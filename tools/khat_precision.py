#!/usr/bin/env python3
"""The full-rank robust-regression multistart's khats in float32 and
float64, on one card.

    python3 tools/khat_precision.py

Runs `validated_vi_multistart` on the third configuration of
benchmarks/khat_noise.py:183-207 (robust regression, full-rank
Student-t(100) KLVI, n_mc 100, lr 0.1 -> 0.001, 5000 iterations, 16 starts
tiled from ``init_param()``, 1e6 bound samples each) with the same
generator in float32 and in float64, and prints each start's khat and the
mean and sd of the 16.  Then, at each float64 fit, it rescores the bound
pass's log-weights with noise of a float32 rounding of each (normal, sd
2^-24 |lw|) added, and prints those khats too: how far rounding noise at
float32's resolution moves khat when q is this close to p (d2 ~ 6e-4, the
log-weights spread over ~0.03 nats around ~-50).  Prints the card's name
and power limit.  Needs a CUDA device; imports nothing of JAX.
"""
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N_STARTS, N_ITERS, N_BOUND = 16, 5000, 1_000_000


def summary(label, khats):
    khats = np.asarray(khats, dtype=float)
    print('{}: mean {!r}, sd {!r}, median {!r}; values {}'.format(
        label, float(khats.mean()), float(khats.std(ddof=1)),
        float(np.median(khats)), [round(float(k), 4) for k in khats]),
        flush=True)


def main():
    if not torch.cuda.is_available():
        print('khat_precision: no CUDA device', file=sys.stderr)
        return 1
    import viabel_tpu_torch as vt
    from viabel_tpu_torch.models import robust_regression_model
    from viabel_tpu_torch.psis import _psislw_1d, _tail_len

    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    model = robust_regression_model()
    fam = vt.t_variational_family(2, 100)
    obj = vt.black_box_klvi(fam, model, 100, presampled=True)
    outs = {}
    for dtype in (torch.float32, torch.float64):
        init = fam.init_param(dtype, 'cuda')
        outs[dtype] = vt.validated_vi_multistart(
            model, fam, init, N_ITERS, init_params=init.repeat(N_STARTS, 1),
            objective_and_grad=obj, n_bound_samples=N_BOUND,
            learning_rate=0.1, learning_rate_end=0.001,
            generator=torch.Generator(device='cuda').manual_seed(20260819),
            device='cuda')
        summary('{} khat'.format(dtype), outs[dtype]['khat'])
        summary('{} d2'.format(dtype),
                [b['d2'] for b in outs[dtype]['bounds']])
    lw = outs[torch.float64]['log_weights']
    noise = torch.randn(lw.shape, dtype=lw.dtype, device=lw.device,
                        generator=torch.Generator(device='cuda')
                        .manual_seed(7))
    noisy = lw + noise * lw.abs() * 2.0 ** -24
    tail = _tail_len(N_BOUND, 1.0)
    summary('float64 fits, log-weights with float32-sized rounding noise',
            [float(_psislw_1d(noisy[k], tail)[1]) for k in range(N_STARTS)])
    spread = (lw.max(dim=1).values - lw.min(dim=1).values).cpu().numpy()
    print('float64 log-weights: median |lw| {!r}, spread (max - min) a start '
          '{!r} to {!r}'.format(float(lw.abs().median()),
                                float(spread.min()), float(spread.max())))
    return 0


if __name__ == '__main__':
    sys.exit(main())
