"""Large-dimension validated VI (examples/large_d.py; no notebook
counterpart): the whole validated workflow (full-rank Gaussian KLVI,
1e6-sample bounds, PSIS) at d = 100 (5150 variational parameters), or
d = 300 with ``--full``, on a conjugate linear-regression posterior whose
exact moments are known, then the fit checked against the truth.

q starts at the prior: at large d the posterior scales are far tighter
than a unit start, which P parameters would not cross in any reasonable
schedule.  n_mc = 800 as in the JAX example.  The JAX example's
``unroll='auto'`` and ``--cpu`` (a JAX platform switch) have no
counterpart: ``--device cpu`` runs it on the CPU.  It reaches the adagrad
step kernel at P = 5150 / 45450 (a cluster of blocks a run), K3 and the
combine.

    python -m viabel_tpu_torch.examples.large_d [--full] [--d 100]
        [--n-iters N] [--device cpu]
"""
import sys
import time

import numpy as np
import torch

from ..families import full_rank_gaussian_variational_family, \
    init_from_moments
from ..models import data_generator_linear, linear_regression_model
from ..pipeline import validated_vi
from ._common import (default_generator, parser, resolve_device,
                      synchronize)


def setup(d):
    """The N = 4 d conjugate regression at dimension `d` (seed 7, noise
    scale 0.5, prior std 3), a full-rank Gaussian family, and q at the
    prior (float32, on the CPU)."""
    data = data_generator_linear(N=4 * d, D=d, alpha=1.0,
                                 noise_variance=0.25, rho=0.5, seed=7)
    model = linear_regression_model(data['X'], data['Y'], noise_scale=0.5,
                                    prior_std=3.0)
    fam = full_rank_gaussian_variational_family(d)
    init = init_from_moments(fam, np.zeros(d),
                             3.0 ** 2 * np.eye(d)).to(torch.float32)
    return model, fam, init


def fit(model, fam, init, n_iters, device):
    """The example's `validated_vi` (n_mc 800, 1e6 bound samples, learning
    rate .05 to .001) from a generator of seed 0 on `device`."""
    return validated_vi(model, fam, init, n_iters, n_mc_samples=800,
                        n_bound_samples=1000000,
                        generator=default_generator(device, 0),
                        learning_rate=.05, learning_rate_end=.001,
                        device=device)


def main(d=100, n_iters=None, device=None):
    """`validated_vi` at dimension `d` in float32 on `device` (None: the
    CUDA card); 0 when the fit is certified (khat < 0.7 and |mean - truth|
    < 0.05), else 1."""
    device = resolve_device(device)
    n_iters = n_iters or (10000 if d < 300 else 40000)
    model, fam, init = setup(d)
    print('d = {}  (P = {} variational parameters), {} iterations'.format(
        d, fam.var_param_dim, n_iters))

    t0 = time.perf_counter()
    out = fit(model, fam, init, n_iters, device)
    synchronize(device)
    wall = time.perf_counter() - t0

    mean = np.asarray(out['q_mean'].cpu())
    cov = np.asarray(out['q_cov'].cpu())
    mean_err = float(np.linalg.norm(mean - model.true_mean))
    cov_err = float(np.linalg.norm(cov - model.true_cov)
                    / np.linalg.norm(model.true_cov))
    print('wall (incl. the first graph capture): {:.1f}s'.format(wall))
    print('khat = {:+.3f}  (< 0.7 certifies the PSIS correction)'.format(
        out['khat']))
    print('d2 bound = {:.3g}'.format(out['bounds']['d2']))
    print('|mean - truth| = {:.4f}   rel cov err = {:.3f}'.format(
        mean_err, cov_err))
    ok = out['khat'] < 0.7 and mean_err < 0.05
    print('validated fit: {}'.format('OK' if ok else 'NOT CERTIFIED'))
    return 0 if ok else 1


if __name__ == '__main__':
    p = parser(__doc__.splitlines()[0], full=False)
    p.add_argument('--d', type=int, default=100)
    p.add_argument('--full', action='store_true',
                   help='d = 300 / 40k iterations (DIM_SCALING.md flagship)')
    p.add_argument('--n-iters', type=int)
    a = p.parse_args()
    sys.exit(main(300 if a.full else a.d, a.n_iters, a.device))
