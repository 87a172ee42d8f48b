#!/usr/bin/env python3
"""Time K3 (`lw_partials`) of several checkouts of this repository in
turns, on one card.

    python3 tools/k3_turns.py ROOT [ROOT ...]

Each ROOT is a checkout (for example the parent commit unpacked by
``git archive`` into a git-ignored directory, and ``.``).  The CUDA
library ``csrc/lw_stats.cu`` of every ROOT is built first, all at once;
then each ROOT, in its own process, in the order given and again in
reverse (parent, change, change, parent for two), checks its K3 against
its plain version in float32 at n = 2.5e6 (counts and maxima exactly, the
combined statistics to rtol 2e-5) and times it at n = 2.5e6 and 1e6: the
kernel's own duration on the card (``chip_smoke.device_ms``, mean of 10
launches), with L2 flushed before each by writing 256 MB (dirty L2, as
``chip_smoke.py`` times every kernel) and by reading them (clean L2).
Prints the card's name and power limit.  Needs a CUDA device; imports
nothing of JAX.
"""
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = (2_500_000, 1_000_000)


def child(root, build_only):
    """In a process of its own: `root`'s K3, built, checked and timed."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from viabel_tpu_torch.ops import _build
    from viabel_tpu_torch.ops import lw_stats as ops
    spec = importlib.util.spec_from_file_location(
        'smoke', os.path.join(HERE, 'chip_smoke.py'))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    if build_only:  # the build steps of _build.load, keeping nvcc's output
        started = _build._start('lw_stats')
        if started is not None:
            smoke.log('{}:'.format(root))
            smoke.log_ptxas(_build._finish('lw_stats', started),
                            only='lw_partials')
        return 0
    g = torch.Generator(device='cuda').manual_seed(0)
    lw = 3.0 * torch.randn(SIZES[0], generator=g, device='cuda') - 50.0
    parts, parts_p = ops.lw_partials(lw), ops.lw_partials_plain(lw)
    if not torch.equal(parts[:, :2], parts_p[:, :2]):
        raise AssertionError('K3 counts or maxima differ in ' + root)
    smoke.check_close('K3 of {} against its plain version'.format(root),
                      ops.combine_partials_plain(parts),
                      ops.combine_partials_plain(parts_p), 0, 2e-5)
    out = {}
    for clean in (False, True):
        for n in SIZES:
            x = lw[:n].contiguous()
            out['{} {}'.format(n, 'clean L2' if clean else 'dirty L2')] = \
                smoke.device_ms(lambda: ops.lw_partials(x), 'lw_partials',
                                clean=clean)
    print(json.dumps({'root': root, 'device_ms': out}), flush=True)
    return 0


def main(roots):
    if '--child' in roots or '--build' in roots:
        return child(roots[-1], '--build' in roots)
    me = os.path.abspath(__file__)
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    builds = [subprocess.Popen([sys.executable, me, '--build', r])
              for r in roots]
    if any(p.wait() for p in builds):
        return 1
    for root in list(roots) + list(reversed(roots)):
        rc = subprocess.run([sys.executable, me, '--child', root]).returncode
        if rc:
            return rc
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
