"""Linear-regression iterate-averaging sweeps
(examples/linear_regression_ia.py), both checked against the exact
posterior of the conjugate model:

* ``main`` (reference:
  notebooks/linear-regression-model-Iterate-Averaging-rhat.ipynb):
  RMSProp and Adam with R-hat-gated iterate averaging across step sizes,
  with PSIS-corrected posterior estimates (`improve_with_psis`);
* ``protocol2`` (reference: the notebook's ``-2`` variant): correlated
  design at N=200, k=20 (seed 5080), comparing (a) plain KLVI and the
  path-gradient `black_box_klvi_pd2` under RMSProp-IA and (b) full-rank
  ``t_variational_family(k, df=1000000)`` (the notebook's cell 27) under
  RMSProp-IA and Adam-IA, with the raw-against-IA covariance distance
  (cells 60-100).

The objectives are presampled (each chain's draws are those of the JAX
example's key-threaded chain); the chains step eagerly, one batched step
an iteration.  ``main`` reaches K2, ``philox_normal``, K3 and the combine
(`improve_with_psis` of a mean-field Gaussian); ``protocol2`` runs no
bound pass, and of the port's kernels launches only ``philox_normal`` (the
chains' init noise).

    python -m viabel_tpu_torch.examples.linear_regression_ia [--full]
        [--protocol2] [--device cpu]
"""
import numpy as np
import torch

from ..experiments import check_accuracy, improve_with_psis
from ..families import (mean_field_gaussian_variational_family,
                        t_variational_family)
from ..models import data_generator_linear, linear_regression_model
from ..objectives import black_box_klvi, black_box_klvi_pd2
from ..optimizers import (adam_IA_optimize_with_rhat,
                          rmsprop_IA_optimize_with_rhat)
from ._common import default_generator, parser, resolve_device


def main(full=False, device=None):
    """RMSProp-IA and Adam-IA over step sizes, 4 chains, float32, on
    `device` (None: the CUDA card); generators of seed 0 (the chains) and
    1 (PSIS).  Returns ``{(name, lr): {...}}`` of the printed numbers (the
    JAX example returns None)."""
    device = resolve_device(device)
    D = 10 if full else 5
    data = data_generator_linear(N=100, D=D, alpha=1.0, noise_variance=0.25,
                                 rho=0.5, seed=42)
    model = linear_regression_model(data['X'], data['Y'])
    fam = mean_field_gaussian_variational_family(D)
    obj = black_box_klvi(fam, model, 100, presampled=True)
    init = torch.zeros(fam.var_param_dim, dtype=torch.float32)
    n_iters = 20000 if full else 3000
    n_chains = 4

    print('exact posterior mean: {}'.format(
        np.round(model.true_mean, 3)))
    out = {}
    for name, optimizer in [('rmsprop', rmsprop_IA_optimize_with_rhat),
                            ('adam', adam_IA_optimize_with_rhat)]:
        for lr in ([0.1, 0.02, 0.005] if full else [0.02, 0.005]):
            (final, chains, avg_means, avg_sigmas, _, _, log) = optimizer(
                n_iters, obj, init, D, generator=default_generator(device, 0),
                learning_rate=lr, n_optimisers=n_chains,
                rhat_window=max(n_iters // 10, 100),
                tail_avg_iters=n_iters // 4, device=device)
            ia_param = torch.as_tensor(np.concatenate([avg_means[0][-1],
                                                       avg_sigmas[0][-1]]))
            acc = check_accuracy(model.true_mean, model.true_cov,
                                 *fam.mean_and_cov(ia_param))
            psis_res, _, _ = improve_with_psis(
                model, fam, ia_param, 100000, model.true_mean,
                model.true_cov, generator=default_generator(device, 1),
                device=device)
            print('{:>8} lr={:<6} IA-start mean/sigma = {}/{}  '
                  'mean_err = {:.4f}  psis mean_err = {:.4f}  '
                  'khat = {:.2f}'.format(
                      name, lr, log['start_avg_mean_iters'],
                      log['start_avg_sigma_iters'], acc['mean_error'],
                      psis_res['mean_error'], psis_res['khat']))
            out[name, lr] = dict(
                start_avg_mean_iters=log['start_avg_mean_iters'],
                start_avg_sigma_iters=log['start_avg_sigma_iters'],
                mean_error=float(acc['mean_error']),
                psis_mean_error=float(psis_res['mean_error']),
                khat=psis_res['khat'])
    return out


def _cov_distance(fam, params, true_cov):
    """Per-iterate Frobenius distance between the iterate's covariance and
    the exact posterior covariance, averaged over iterates (the -2
    notebook's distance plots; reference cells 60, 70)."""
    params = torch.as_tensor(np.asarray(params))
    covs = torch.func.vmap(lambda p: fam.mean_and_cov(p)[1])(params)
    diff = covs.reshape(covs.shape[0], -1) - torch.as_tensor(
        np.asarray(true_cov), dtype=covs.dtype).reshape(-1)
    return float(torch.mean(torch.linalg.norm(diff, dim=1)))


def protocol2(full=False, n_iters=None, device=None):
    """The -2 notebook's protocol, float32 (the JAX example's default
    float type), on `device` (None: the CUDA card).  Returns ``{'mf':
    {...}, 'fr': {...}}`` of the printed numbers (the JAX example returns
    None)."""
    device = resolve_device(device)
    N, k = (200, 20) if full else (100, 6)
    n_iters = n_iters or (7000 if full else 1500)
    rhat_window = 500 if full else 200
    data = data_generator_linear(N=N, D=k, alpha=1.0, noise_variance=0.16,
                                 rho=0.5, seed=5080)
    model = linear_regression_model(data['X'], data['Y'])
    print('== protocol 2: N={} k={} rho=0.5 (seed 5080), {} iters =='.format(
        N, k, n_iters))
    out = dict(mf={}, fr={})

    # (a) mean-field: plain KLVI against path-gradient KLVI under
    # RMSProp-IA (reference: -2 notebook cells 28-31 and 29/50)
    mf = mean_field_gaussian_variational_family(k)
    mf_init = torch.cat([torch.zeros(k), torch.ones(k)])
    for name, factory in [('klvi', black_box_klvi),
                          ('klvi_pd2', black_box_klvi_pd2)]:
        obj = factory(mf, model, 100, presampled=True)
        (_, chains, avg_means, _, _, _, log) = rmsprop_IA_optimize_with_rhat(
            n_iters, obj, mf_init, k, generator=default_generator(device, 0),
            learning_rate=.01, n_optimisers=2, rhat_window=rhat_window,
            tail_avg_iters=n_iters // 3, device=device)
        ia_err = float(np.mean(np.abs(avg_means[0][-1] - model.true_mean)))
        raw_err = float(np.mean(np.abs(
            chains[0, log['start_avg_mean_iters']:, :k] - model.true_mean)))
        print('  mf {:>9}: IA-start {}  mean err: raw tail = {:.5f}  '
              'IA = {:.5f}'.format(name, log['start_avg_mean_iters'],
                                   raw_err, ia_err))
        out['mf'][name] = dict(ia_start=log['start_avg_mean_iters'],
                               raw_err=raw_err, ia_err=ia_err)

    # (b) full-rank (t, df = 1e6): RMSProp-IA against Adam-IA, covariance
    # distance raw against IA (reference: -2 notebook cells 27, 60-70,
    # 90-100)
    fr = t_variational_family(k, df=1000000)
    fr_init = torch.cat([torch.zeros(k), torch.ones(fr.var_param_dim - k)])
    fr_lr = .005 if full else .02  # short horizons need the larger step
    fr_obj = black_box_klvi(fr, model, 100, presampled=True)
    for name, optimizer in [('rmsprop', rmsprop_IA_optimize_with_rhat),
                            ('adam', adam_IA_optimize_with_rhat)]:
        (final, chains, avg_means, avg_sigmas, _, _, log) = optimizer(
            n_iters, fr_obj, fr_init, k,
            generator=default_generator(device, 1),
            learning_rate=fr_lr, n_optimisers=2, rhat_window=rhat_window,
            tail_avg_iters=n_iters // 3, device=device)
        s0 = log['start_avg_sigma_iters']
        # the IA trajectory in parameter space: the averaged mean block
        # and the averaged scale block, then the distance of each iterate
        stride = max((chains.shape[1] - s0) // 200, 1)
        raw = chains[0, s0::stride]
        # the mean and sigma averages start at their own R-hat-gated
        # iterations; align them on the common tail
        n_ia = min(len(avg_means[0]), len(avg_sigmas[0]))
        ia = np.concatenate([avg_means[0][-n_ia:], avg_sigmas[0][-n_ia:]],
                            axis=1)[::stride]
        d_raw = _cov_distance(fr, raw, model.true_cov)
        d_ia = _cov_distance(fr, ia, model.true_cov)
        mean_err = float(np.mean(np.abs(avg_means[0][-1] - model.true_mean)))
        print('  fr {:>8}: IA-start {}  cov dist: raw = {:.5f}  IA = {:.5f}'
              '  IA mean err = {:.5f}'.format(name, s0, d_raw, d_ia,
                                              mean_err))
        out['fr'][name] = dict(ia_start=s0, cov_dist_raw=d_raw,
                               cov_dist_ia=d_ia, ia_mean_err=mean_err)
    return out


if __name__ == '__main__':
    p = parser(__doc__.splitlines()[0])
    p.add_argument('--protocol2', action='store_true',
                   help='run only the -2 notebook protocol')
    a = p.parse_args()
    if a.protocol2:
        protocol2(a.full, device=a.device)
    else:
        main(a.full, a.device)
        protocol2(a.full, device=a.device)
