#!/usr/bin/env python3
"""Write a variant of a checkout's step kernel that uses programmatic
dependent launch (PDL), for timing against the checkout in turns.

    python3 tools/pdl_variant.py SRC DST
    python3 tools/path_turns.py SRC DST        # on a card

Copies SRC's ``viabel_tpu_torch`` package into DST (which must not exist)
and edits DST's ``csrc/adagrad.cu``: every launch of the library carries
``cudaLaunchAttributeProgrammaticStreamSerialization``, so that a step may
be launched while the kernel before it (the objective's last) finishes,
and the step kernel issues the loads that no earlier kernel of the
iteration writes (the counter, the ring, param, the tail sum: only the
step before wrote them) before ``griddepcontrol.wait``
(``cudaGridDependencySynchronize``), and the objective's outputs (grad,
value, log-norm) after it.  The kernel before it triggers nothing, so
the step may start when that kernel's blocks have all exited.  The
package's own kernel does not do this (PERF.md has the measurement).
"""
import os
import shutil
import sys

EDITS = [
    # the objective's gradient is loaded after the wait, not with the
    # column
    ('  c.g = grad[kP + p];\n', ''),
    ('  const T ln = log_norm != nullptr ? log_norm[k] : T(0);\n'
     '  const T val = writer ? value[k] : T(0);\n', ''),
    ('  if (p < P) load_column(cur, grad, param, tail_sum, ring_grads, kP, '
     'kw, P, p);\n',
     '  if (p < P) load_column(cur, grad, param, tail_sum, ring_grads, kP, '
     'kw, P, p);\n'
     '  asm volatile("griddepcontrol.wait;" ::: "memory");\n'
     '  const T ln = log_norm != nullptr ? log_norm[k] : T(0);\n'
     '  const T val = writer ? value[k] : T(0);\n'
     '  if (p < P) cur.g = grad[kP + p];\n'),
    ('    if (q < P)\n'
     '      load_column(next, grad, param, tail_sum, ring_grads, kP, kw, P, '
     'q);\n',
     '    if (q < P) {\n'
     '      load_column(next, grad, param, tail_sum, ring_grads, kP, kw, P, '
     'q);\n'
     '      next.g = grad[kP + q];\n'
     '    }\n'),
    ('  cudaLaunchAttribute attr[1];\n'
     '  if (cluster > 1) {\n'
     '    attr[0].id = cudaLaunchAttributeClusterDimension;\n'
     '    attr[0].val.clusterDim.x = cluster;\n'
     '    attr[0].val.clusterDim.y = 1;\n'
     '    attr[0].val.clusterDim.z = 1;\n'
     '    config.attrs = attr;\n'
     '    config.numAttrs = 1;\n'
     '  }\n',
     '  cudaLaunchAttribute attr[2];\n'
     '  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;\n'
     '  attr[0].val.programmaticStreamSerializationAllowed = 1;\n'
     '  config.attrs = attr;\n'
     '  config.numAttrs = 1;\n'
     '  if (cluster > 1) {\n'
     '    attr[1].id = cudaLaunchAttributeClusterDimension;\n'
     '    attr[1].val.clusterDim.x = cluster;\n'
     '    attr[1].val.clusterDim.y = 1;\n'
     '    attr[1].val.clusterDim.z = 1;\n'
     '    config.numAttrs = 2;\n'
     '  }\n'),
]


def main(src, dst):
    shutil.copytree(os.path.join(src, 'viabel_tpu_torch'),
                    os.path.join(dst, 'viabel_tpu_torch'),
                    ignore=shutil.ignore_patterns('_build', '__pycache__'))
    path = os.path.join(dst, 'viabel_tpu_torch', 'csrc', 'adagrad.cu')
    with open(path) as f:
        text = f.read()
    for old, new in EDITS:
        if text.count(old) != 1:
            raise SystemExit('pdl_variant: {!r} is not in {} once'.format(
                old[:60], path))
        text = text.replace(old, new)
    with open(path, 'w') as f:
        f.write(text)
    return 0


if __name__ == '__main__':
    sys.exit(main(*sys.argv[1:]))
