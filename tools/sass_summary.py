#!/usr/bin/env python3
"""Count the machine instructions of the port's float32 kernels.

    python3 tools/sass_summary.py [OUT_DIR]

Builds the CUDA sources, disassembles each library with ``cuobjdump -sass``
(from the CUDA toolkit, ``$CUDA_HOME/bin`` or ``/usr/local/cuda/bin``), and
for each kernel named in `KERNELS` prints its static instruction count and
its most frequent opcodes, and writes its listing (without the encodings)
to ``OUT_DIR/<kernel>.sass`` (default ``sass_out/``, git-ignored).  The counts are static: the score
kernels unroll the 8 samples a thread scores in a chunk, so a sample costs
about an eighth of the kernel, slow paths and the statistics included.
Needs nvcc and cuobjdump, no GPU.
"""
import collections
import glob
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# part of the mangled name -> what to call it
KERNELS = {
    'philox_normal_kernelIfE': 'philox_normal f32',
    'score_partials_kernelIfLi10ELi10ENS_11LoadedDraws': 'K1 f32 d=10',
    'score_partials_kernelIfLi2ELi2ENS_11LoadedDraws': 'K1 f32 d=2',
    'score_partials_kernelIfLi10ELi10ENS_11PhiloxDraws': 'K2 f32 d=10',
    'lw_partials_kernelIfE': 'K3 f32',
    'combine_partials_kernelIfE': 'combine f32',
}
_OPCODE = re.compile(
    r'/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\d\s+)?([A-Z0-9_]+(?:\.WIDE)?)')
# shared-memory and constant loads with their modifiers (the width among
# them: LDS.64, LDS.128; none is 32 bits)
_LOAD = re.compile(
    r'/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\d\s+)?((?:LDS|ULDC|LDC)(?:\.[A-Z0-9]+)*)')


def main():
    from viabel_tpu_torch.ops import _build

    _build.build_all()
    cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    out_dir = os.path.abspath(sys.argv[1] if len(sys.argv) > 1
                              else os.path.join(ROOT, 'sass_out'))
    os.makedirs(out_dir, exist_ok=True)
    build_dir = os.path.join(ROOT, 'viabel_tpu_torch', '_build')
    for lib in sorted(glob.glob(os.path.join(build_dir, '*.so'))):
        text = subprocess.run(
            [os.path.join(cuda_home, 'bin', 'cuobjdump'), '-sass', lib],
            capture_output=True, text=True, check=True).stdout
        for section in re.split(r'(?m)^\s*Function : ', text)[1:]:
            mangled = section.split('\n', 1)[0].strip()
            label = next((v for k, v in KERNELS.items() if k in mangled),
                         None)
            if label is None:
                continue
            lines = [re.sub(r'/\* 0x[0-9a-f]+ \*/', '', line).rstrip()
                     for line in section.splitlines()]
            lines = [line for line in lines if line.strip()]
            name = label.replace(' ', '_').replace('=', '')
            with open(os.path.join(out_dir, name + '.sass'), 'w') as f:
                f.write('\n'.join(lines) + '\n')
            ops = collections.Counter(
                m.group(1) for m in map(_OPCODE.search, lines) if m)
            print('{}: {} instructions; {}'.format(
                label, sum(ops.values()),
                ', '.join('{} {}'.format(op, c)
                          for op, c in ops.most_common(14))), flush=True)
            loads = collections.Counter(
                m.group(1) for m in map(_LOAD.search, lines) if m)
            print('  {}: FFMA {}; loads by width: {}'.format(
                label, ops['FFMA'], ', '.join(
                    '{} {}'.format(op, c) for op, c in sorted(loads.items()))),
                flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
