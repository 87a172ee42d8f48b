#!/usr/bin/env python3
"""Time the adagrad run's CUDA graph at several depths, on one card.

    python3 tools/graph_depth.py [DEPTH ...]

`optimizers._adagrad_run` captures its body (the objective's value and
gradient, the casts and the step kernel) `optimizers._GRAPH_ITERS` times
in one CUDA graph and replays it.  This times that run at each depth
(default 1, 4, 16, 64 iterations a graph), for presampled KLVI (n_mc 100)
and CHIVI (alpha 2, n_mc 500, with its log-norm rescaling) on
eight-schools CP with a mean-field Student-t(40) family, 2000 iterations
in float32, every depth twice in turns (up the list, then down it), with
the eager loop of the same body first and last.  A run's time holds the
capture of its graphs.  Prints the card's name and power limit.  Needs a
CUDA device; imports nothing of JAX.
"""
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N_ITERS = 2000


def main(depths):
    import subprocess

    import viabel_tpu_torch as vt
    from viabel_tpu_torch import optimizers
    from viabel_tpu_torch.models import eight_schools_cp_model
    from viabel_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print('graph_depth: no CUDA device', file=sys.stderr)
        return 1
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    _build.build_all()
    model = eight_schools_cp_model()
    fam = vt.mean_field_t_variational_family(model.dim, 40)
    for name in ('KLVI', 'CHIVI'):
        if name == 'KLVI':
            obj = vt.black_box_klvi(fam, model, 100, presampled=True)
        else:
            obj = vt.black_box_chivi(2, fam, model, 500, presampled=True)
        g = torch.Generator(device='cuda').manual_seed(0)
        draws = obj.make_draws(g, N_ITERS, torch.float32)
        init = torch.zeros(fam.var_param_dim, device='cuda')
        wrapped = optimizers._wrap_objective(obj, None)

        def run(driver):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            optimizers._adagrad_run(wrapped, N_ITERS, 10, 0.01, 0.1, 0.001,
                                    init, draws, keep_history=False,
                                    driver=driver)
            torch.cuda.synchronize()
            return N_ITERS / (time.perf_counter() - t0)

        run('graph')  # warm up: autograd, the allocator, the kernels
        rates = {d: [] for d in depths}
        eager = [run('eager')]
        for depth in list(depths) + list(reversed(depths)):
            optimizers._GRAPH_ITERS = depth
            rates[depth].append(run('graph'))
        eager.append(run('eager'))
        print('{} on eight-schools CP, {} iterations, float32: eager {:.1f} '
              '/ {:.1f} it/s'.format(name, N_ITERS, *eager), flush=True)
        for depth in depths:
            print('  {:3d} iterations a graph: {:.1f} / {:.1f} it/s'.format(
                depth, *rates[depth]), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main([int(a) for a in sys.argv[1:]] or [1, 4, 16, 64]))
