#!/usr/bin/env python3
"""Time the paths that the adagrad step kernel serves, for several
checkouts of this repository in turns, on one card.

    python3 tools/path_turns.py ROOT [ROOT ...]

Each ROOT is a checkout (for example the parent commit unpacked by
``git archive`` into a git-ignored directory, and ``.``).  Every ROOT's
CUDA libraries are built first, all at once; then each ROOT, in its own
process, in the order given and again in reverse (parent, change, change,
parent for two), runs in float32, with ``chip_smoke.py``'s helpers:

* eight-schools CP KLVI (mean-field t(40), n_mc 100, lr 0.01 -> 0.001),
  2000 iterations through the graph, twice (iterations a second, host
  clock), then 500 under ``torch.profiler`` (busy share and kernels an
  iteration);
* robust regression's 16-start mf-t KLVI batch (phase 13's first
  configuration), 2000 batched iterations through the graph (batched
  iterations a second) and 500 under the profiler;
* examples/large_d.py's default fit (d = 100, P = 5150, 10000
  iterations; phase 15 (a)): the ``validated_vi`` wall.

Prints the card's name and power limit and one JSON line a turn.  Needs a
CUDA device; imports nothing of JAX.
"""
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(root, build_only):
    """In a process of its own: `root`'s paths, built and timed."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import viabel_tpu_torch as vt
    from viabel_tpu_torch.models import (eight_schools_cp_model,
                                         robust_regression_model)
    from viabel_tpu_torch.ops import _build
    if build_only:
        _build.build_all()
        return 0
    spec = importlib.util.spec_from_file_location(
        'smoke', os.path.join(HERE, 'chip_smoke.py'))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    out = {}
    model = eight_schools_cp_model()
    fam = vt.mean_field_t_variational_family(model.dim, 40)
    inputs = smoke.adagrad_inputs(vt, model, fam, 'KLVI', smoke.N_OPT_ALONE,
                                  torch.float32, 4)
    smoke.adagrad_run(inputs, smoke.N_OPT_ALONE, 'graph')  # warm up
    out['eight-schools KLVI it/s'] = [
        smoke.N_OPT_ALONE / smoke.wall(lambda: smoke.adagrad_run(
            inputs, smoke.N_OPT_ALONE, 'graph'))[0] for _ in range(2)]
    out['eight-schools KLVI, 500 under the profiler'] = smoke.busy_text(
        smoke.profile_busy(lambda: smoke.adagrad_run(inputs, 500, 'graph')),
        500, 'an iteration')
    name, bfam, obj, init, lr, lr_end = smoke.multistart_configs(
        vt, robust_regression_model())[0]
    rate, busy = smoke.batched_rate(vt, obj, bfam, init, lr, lr_end)
    out['16-start {} batched it/s'.format(name)] = rate
    out['16-start {}, 500 under the profiler'.format(name)] = busy
    smoke.large_d_fit(vt, smoke.LD_D, smoke.LD_ITERS, 'large-d')
    out['large-d validated_vi s'] = smoke.wall(lambda: smoke.large_d_fit(
        vt, smoke.LD_D, smoke.LD_ITERS, 'large-d'))[0]
    print(json.dumps({'root': root, 'paths': out}), flush=True)
    return 0


def main(roots):
    if '--child' in roots or '--build' in roots:
        return child(roots[-1], '--build' in roots)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from k3_turns import turns
    return turns(os.path.abspath(__file__), roots)


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
