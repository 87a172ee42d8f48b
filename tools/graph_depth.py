#!/usr/bin/env python3
"""Time the adagrad run's CUDA graph at several depths, on one card.

    python3 tools/graph_depth.py [DEPTH ...]

`optimizers._adagrad_run` captures its body (the objective's value and
gradient, the casts and the step kernel) `optimizers._GRAPH_ITERS` times
in one CUDA graph and replays it; a body on an objective's hand-written
kernel (``fused``, `ops.klvi_mf`) `optimizers._FUSED_GRAPH_ITERS` times.
This times that run at each depth (default 1, 4, 16, 64 iterations a
graph), for presampled KLVI (n_mc 100) on its hand-written kernel and
through autograd, and CHIVI (alpha 2, n_mc 500, with its log-norm
rescaling), on eight-schools CP with a mean-field Student-t(40) family in
float32, every depth in turns (up the list, then down it, `ROUNDS`
times), with the eager loop of the same body first and last: 10000
iterations (a validated fit's) on the kernel, 2000 through autograd; each
depth's rates are printed with their median.  A run's time holds
the capture of its graphs.  Prints the card's name and power limit.  Needs
a CUDA device; imports nothing of JAX.
"""
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

ROUNDS = 3


def main(depths):
    import statistics
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
    for name, n_iters in (('KLVI on its kernel', 10000),
                          ('KLVI through autograd', 2000), ('CHIVI', 2000)):
        if name.startswith('KLVI'):
            obj = vt.black_box_klvi(fam, model, 100, presampled=True)
            if 'autograd' in name:
                obj.fused = None
        else:
            obj = vt.black_box_chivi(2, fam, model, 500, presampled=True)
        knob = ('_FUSED_GRAPH_ITERS' if getattr(obj, 'fused', None)
                else '_GRAPH_ITERS')
        chosen = getattr(optimizers, knob)
        g = torch.Generator(device='cuda').manual_seed(0)
        draws = obj.make_draws(g, n_iters, torch.float32)
        init = torch.zeros(fam.var_param_dim, device='cuda')
        wrapped = optimizers._wrap_objective(obj, None)

        def run(driver):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            optimizers._adagrad_run(wrapped, n_iters, 10, 0.01, 0.1, 0.001,
                                    init, draws, keep_history=False,
                                    driver=driver)
            torch.cuda.synchronize()
            return n_iters / (time.perf_counter() - t0)

        run('graph')  # warm up: autograd, the allocator, the kernels
        rates = {d: [] for d in depths}
        eager = [run('eager')]
        for _ in range(ROUNDS):
            for depth in list(depths) + list(reversed(depths)):
                setattr(optimizers, knob, depth)
                rates[depth].append(run('graph'))
        setattr(optimizers, knob, chosen)
        eager.append(run('eager'))
        print('{} on eight-schools CP, {} iterations, float32 ({} = {}): '
              'eager {:.1f} / {:.1f} it/s'.format(name, n_iters, knob,
                                                  chosen, *eager),
              flush=True)
        for depth in depths:
            print('  {:3d} iterations a graph: median {:.1f} it/s ({})'
                  .format(depth, statistics.median(rates[depth]),
                          ', '.join('{:.1f}'.format(r)
                                    for r in rates[depth])), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main([int(a) for a in sys.argv[1:]] or [1, 4, 16, 64]))
