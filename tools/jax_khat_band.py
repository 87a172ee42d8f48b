#!/usr/bin/env python3
"""The JAX package's own 16-start khat band for the full-rank
robust-regression multistart, on the CPU, in float32 and float64.

    python3 tools/jax_khat_band.py                 # both, one process each
    python3 tools/jax_khat_band.py --dtype float32 # one of them

Runs `viabel_tpu.validated_vi_multistart` on the third configuration of
benchmarks/khat_noise.py:183-207 exactly as that script's `run_config`
does: robust regression, full-rank Student-t(100) KLVI (n_mc 100,
presampled), 16 starts tiled from ``tfam.init_param()`` in the dtype,
5000 iterations,
lr 0.1 -> 0.001, 1e6 bound samples a start, ``PRNGKey(20260819)``.  Prints
the 16 khats, their mean, sd and median, and the mean of the 16 d2
bounds.  float64 runs with ``jax_enable_x64``, float32 without it (the
arithmetic the TPU run had, on the CPU's IEEE float32).  Each dtype runs in
a process of its own, since x64 is fixed when JAX starts.  This is a tool
of the JAX package; the port does not import it.  About half a minute a
dtype on a few CPU cores.
"""
import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_STARTS, N_ITERS, N_BOUND, SEED = 16, 5000, 1_000_000, 20260819


def band(dtype):
    os.environ['JAX_PLATFORMS'] = 'cpu'
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', dtype == 'float64')
    import jax.numpy as jnp
    import numpy as np
    import warnings
    sys.path.insert(0, ROOT)
    from viabel_tpu import (black_box_klvi, t_variational_family,
                            validated_vi_multistart)
    from viabel_tpu.bounds import MonteCarloErrorWarning
    from viabel_tpu.models import robust_regression_model
    warnings.simplefilter('ignore', MonteCarloErrorWarning)

    model = robust_regression_model()
    tfam = t_variational_family(2, 100)
    obj = black_box_klvi(tfam, model.log_prob, 100, presampled=True)
    init = tfam.init_param(dtype=jnp.float64 if dtype == 'float64'
                           else jnp.float32)
    out = validated_vi_multistart(
        model.log_prob, tfam, init, N_ITERS,
        init_params=jnp.tile(init[None, :], (N_STARTS, 1)),
        objective_and_grad=obj, n_bound_samples=N_BOUND,
        key=jax.random.PRNGKey(SEED), learning_rate=0.1,
        learning_rate_end=0.001)
    khat = np.asarray(out['khat'], dtype=float)
    d2 = np.asarray([b['d2'] for b in out['bounds']], dtype=float)
    print('JAX package, CPU, {} (init dtype {}): khats {}'.format(
        dtype, init.dtype, [round(float(k), 4) for k in khat]))
    print('  mean {:.4f}, sd {:.4f}, median {:.4f}; d2 mean {:.3e}'.format(
        khat.mean(), khat.std(ddof=1), float(np.median(khat)), d2.mean()),
        flush=True)


def main():
    p = argparse.ArgumentParser()
    p.add_argument('--dtype', choices=('float32', 'float64'))
    args = p.parse_args()
    if args.dtype:
        band(args.dtype)
        return 0
    for dtype in ('float32', 'float64'):
        rc = subprocess.call([sys.executable, os.path.abspath(__file__),
                              '--dtype', dtype])
        if rc:
            return rc
    return 0


if __name__ == '__main__':
    sys.exit(main())
