"""Eight-schools iterate-averaging protocol (examples/eight_schools_ia.py;
reference: notebooks/eight-schools-iterate-averaging-rhat.ipynb): RMSProp
with R-hat-gated iterate averaging on the centred and non-centred
parameterisations, started from the ground-truth moments, and whether
the iterate average gets closer to the truth than the raw iterates once
the chains have converged; then the full-rank Gaussian protocol of
eight_schools.ipynb (cells 22-23).

Protocol (reference cells 14-15, 36): mean-field Gaussian family, KLVI
n_mc = 100; CP 9000 iterations with ``r_mean_threshold = 1.20``, NCP
11000 with 1.15; ``learning_rate = .01, n_optimisers = 2,
tail_avg_iters = 3000``.  Each model starts from its own scale's stored
HMC moments (PARITY.md).  The script prints what the notebook plots: the
averaging starts, the R-hat windows, and the distance to the truth of the
raw iterates and of the average, overall and by block.

The objectives are presampled (the JAX example's key-threaded draws); the
chains step eagerly.  No bound pass runs here: the protocol is the IA
optimizers' path, and of the port's kernels it launches only
``philox_normal`` (the chains' init noise).

    python -m viabel_tpu_torch.examples.eight_schools_ia [--full]
        [--full-rank] [--device cpu]
"""
import numpy as np
import torch

from ..families import (full_rank_gaussian_variational_family,
                        init_from_moments,
                        mean_field_gaussian_variational_family)
from ..models import eight_schools_cp_model, eight_schools_ncp_model
from ..objectives import black_box_klvi
from ..optimizers import rmsprop_IA_optimize_with_rhat
from ._common import default_generator, parser, resolve_device


def _l2(err):
    """Per-iterate l2 norm over the parameter axis (the notebook's
    'Distance'), averaged over iterates; scalars reduce to |err|."""
    err = np.atleast_1d(np.asarray(err))
    flat = err.reshape(err.shape[0], -1) if err.ndim > 1 else err[:, None]
    return float(np.mean(np.linalg.norm(flat, axis=1)))


def _block_errors(label, raw_tail, ia_traj, truth):
    """Mean l2 distance to the truth: raw post-convergence iterates against
    the final iterate average (the notebook's 'Distance' plots)."""
    raw = _l2(raw_tail - truth)
    ia = _l2(np.asarray(ia_traj)[-1:] - truth)
    better = 'IA' if ia <= raw else 'raw'
    print('    {:<22} raw tail = {:.4f}   IA final = {:.4f}   ({} better)'
          .format(label, raw, ia, better))
    return ia <= raw


def run_one(label, model, n_iters, r_mean_threshold, tail_avg_iters, key,
            rhat_window=500, n_mc=100):
    """One parameterisation's IA run from generator `key` (on the device
    it is on).  Returns the optimisation log."""
    K = model.dim
    fam = mean_field_gaussian_variational_family(K)
    obj = black_box_klvi(fam, model, n_mc, presampled=True)
    init = init_from_moments(fam, model.true_mean,
                             np.diag(np.diag(model.true_cov))).float()
    (_, chains, avg_means, avg_sigmas, _, _, log) = \
        rmsprop_IA_optimize_with_rhat(
            n_iters, obj, init, K, generator=key, learning_rate=.01,
            n_optimisers=2, r_mean_threshold=r_mean_threshold,
            rhat_window=rhat_window, tail_avg_iters=tail_avg_iters,
            device=key.device)

    true_mean = np.asarray(model.true_mean)
    true_log_sigma = .5 * np.log(np.diag(np.asarray(model.true_cov)))

    print('\n== {} ({} iters) =='.format(label, n_iters))
    m0, s0 = log['start_avg_mean_iters'], log['start_avg_sigma_iters']
    print('  averaging starts: mean block iter {}, sigma block iter {}'
          .format(m0, s0))
    rhm, rhs = log['r_hat_mean'], log['r_hat_sigma']
    print('  R-hat windows (mean block): mu {}  log_tau {}  theta max {}'
          .format(np.round(rhm[:, 0], 3), np.round(rhm[:, 1], 3),
                  np.round(rhm[:, 2:].max(axis=1), 3)))
    print('  final-window R-hat: mean block max = {:.3f}, '
          'sigma block max = {:.3f}'.format(rhm[-1].max(), rhs[-1].max()))

    # chain 0, post-convergence raw iterates against the IA trajectory
    raw_mean = chains[0, m0:, :K]
    raw_sig = chains[0, s0:, K:]
    print('  distance to truth (chain 0, iterations since convergence):')
    wins = [
        _block_errors('mean, all params', raw_mean, avg_means[0], true_mean),
        _block_errors('mean, mu', raw_mean[:, 0], avg_means[0][:, 0],
                      true_mean[0]),
        _block_errors('mean, log_tau', raw_mean[:, 1], avg_means[0][:, 1],
                      true_mean[1]),
        _block_errors('mean, thetas', raw_mean[:, 2:], avg_means[0][:, 2:],
                      true_mean[2:]),
        _block_errors('log-sigma, all params', raw_sig, avg_sigmas[0],
                      true_log_sigma),
    ]
    print('  IA at least as close as raw on {}/{} blocks'.format(
        sum(wins), len(wins)))
    return log


def run_full_rank(full=False, n_iters=None, device=None):
    """Full-rank Gaussian RMSProp-IA on the CP model (reference:
    notebooks/eight_schools.ipynb cells 10, 22-23: 30000 iterations, lr
    .01), from a generator of seed 2 on `device` (None: the CUDA card).
    Returns the optimisation log with the printed errors added under
    ``'raw_mean_err'``, ``'ia_mean_err'`` and ``'ia_cov_err'``."""
    device = resolve_device(device)
    model = eight_schools_cp_model()
    K = model.dim
    n_iters = n_iters or (30000 if full else 3000)
    fam = full_rank_gaussian_variational_family(K)
    obj = black_box_klvi(fam, model, 100, presampled=True)
    init = init_from_moments(fam, model.true_mean, model.true_cov).float()
    (_, chains, avg_means, avg_sigmas, _, _, log) = \
        rmsprop_IA_optimize_with_rhat(
            n_iters, obj, init, K, generator=default_generator(device, 2),
            learning_rate=.01, n_optimisers=2,
            rhat_window=500 if full else 200,
            tail_avg_iters=n_iters // 3, device=device)
    print('\n== eight-schools CP, full-rank Gaussian ({} iters) =='
          .format(n_iters))
    print('  averaging starts: mean block iter {}, scale block iter {}'
          .format(log['start_avg_mean_iters'], log['start_avg_sigma_iters']))
    true_mean = np.asarray(model.true_mean)
    # everything on chain 0, so raw against IA is not confounded with the
    # chain: raw = chain 0's last recorded iterate, IA = chain 0's averaged
    # mean and scale blocks
    raw_param = np.asarray(chains[0, -1])
    raw_mean, _ = fam.mean_and_cov(torch.as_tensor(raw_param))
    ia_param = np.concatenate([avg_means[0][-1],
                               avg_sigmas[0][-1]]).astype(raw_param.dtype)
    ia_mean, ia_cov = fam.mean_and_cov(torch.as_tensor(ia_param))
    raw_err = float(np.linalg.norm(raw_mean.numpy() - true_mean))
    ia_err = float(np.linalg.norm(ia_mean.numpy() - true_mean))
    cov_err = float(np.linalg.norm(ia_cov.numpy()
                                   - np.asarray(model.true_cov)))
    print('  mean err (l2): final iterate = {:.4f}   IA = {:.4f}'.format(
        raw_err, ia_err))
    print('  IA cov err (Frobenius, vs HMC truth) = {:.4f}'.format(cov_err))
    return dict(log, raw_mean_err=raw_err, ia_mean_err=ia_err,
                ia_cov_err=cov_err)


def main(full=False, full_rank=False, device=None):
    """CP and NCP (a quarter of the reference's iterations unless `full`),
    then the full-rank protocol, on `device` (None: the CUDA card);
    generators of seed 0 (CP), 1 (NCP) and 2 (full rank)."""
    device = resolve_device(device)
    if full_rank:
        run_full_rank(full=full, device=device)
        return
    scale = 1 if full else 4  # quick mode: quarter-length runs
    run_one('eight-schools CP', eight_schools_cp_model(),
            n_iters=9000 // scale, r_mean_threshold=1.20,
            tail_avg_iters=3000 // scale, key=default_generator(device, 0))
    run_one('eight-schools NCP', eight_schools_ncp_model(),
            n_iters=11000 // scale, r_mean_threshold=1.15,
            tail_avg_iters=3000 // scale, key=default_generator(device, 1))
    run_full_rank(full=full, device=device)


if __name__ == '__main__':
    p = parser(__doc__.splitlines()[0])
    p.add_argument('--full-rank', action='store_true',
                   help='run only the full-rank Gaussian protocol '
                        '(eight_schools.ipynb cells 22-23)')
    a = p.parse_args()
    main(full=a.full, full_rank=a.full_rank, device=a.device)
