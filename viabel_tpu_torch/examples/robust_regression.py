"""Robust-regression workload (examples/robust_regression.py; reference:
notebooks/robust-regression.ipynb): KLVI with a mean-field Student-t(40)
family, CHIVI warm-started from the KLVI solution at +3.0 on the
log-scales, and full-rank Student-t(100) KLVI, each with bounds (the
family's closed-form moments, `family_moment_bounds`) and PSIS khat.

The objectives are presampled: iteration i's draws are those the JAX
example's key-threaded run draws from ``fold_in(key, i)`` (the JAX
package's `make_draws` gives the same block), and on the card each fit is
a replayed CUDA graph.  `timed_optimize` warms up with a throwaway
generator and times the second run; the JAX example's one stacked host
fetch (the TPU's dispatch floor) has no counterpart here.

It reaches K1 (the regression row model, d = 2), K3 (the full-rank
family's log-weights), the combine and the adagrad step kernel.

    python -m viabel_tpu_torch.examples.robust_regression [--full]
        [--device cpu]
"""
import time

import numpy as np
import torch

from ..bounds import all_bounds, family_moment_bounds
from ..experiments import (check_approx_accuracy,
                           get_samples_and_log_weights, print_bounds)
from ..families import (mean_field_t_variational_family,
                        t_variational_family)
from ..models import robust_regression_model
from ..objectives import black_box_chivi, black_box_klvi
from ..optimizers import adagrad_optimize
from ..psis import psislw
from ._common import (default_generator, folded, parser, resolve_device,
                      split, synchronize)


def bounds_and_khat(model, fam, opt_param, n_samples, key, elbo=None):
    """Bounds, khat and the mean log-weight (the ELBO estimate) of
    `n_samples` draws of q at `opt_param`.  `key` is a generator, or the
    ``(n_samples,)`` log-weights it would give."""
    opt_param = torch.as_tensor(opt_param)
    if isinstance(key, torch.Generator):
        _, lw = get_samples_and_log_weights(model, fam, opt_param,
                                            n_samples, key,
                                            device=opt_param.device)
    else:
        lw = torch.as_tensor(key, device=opt_param.device)
    cov = fam.mean_and_cov(opt_param)[1].cpu().numpy()
    res = all_bounds(lw, q_var=cov,
                     moment_bound_fn=family_moment_bounds(fam, opt_param),
                     log_norm_bound=elbo)
    _, khat = psislw(lw)
    return res, float(khat), float(torch.mean(lw))


def timed_optimize(n_iters, obj, init, key, device=None, **kw):
    """`adagrad_optimize` run twice: a warm-up from a throwaway generator
    (``folded(key, 99)``), then the timed run from `key`, closed by a
    synchronize of the card.  `key` is a generator, or the presampled
    ``(n_iters, n_mc, ...)`` draws it would give (both runs then take
    them).  Returns ``(adagrad_optimize's result, iterations a second)``
    on `device` (None: the CUDA card)."""
    device = resolve_device(device)
    if isinstance(key, torch.Generator):
        warm, timed = dict(generator=folded(key, 99)), dict(generator=key)
    else:
        warm = timed = dict(draws=key)
    adagrad_optimize(n_iters, obj, init, device=device, **warm, **kw)
    synchronize(device)
    t0 = time.perf_counter()
    out = adagrad_optimize(n_iters, obj, init, device=device, **timed, **kw)
    synchronize(device)
    return out, n_iters / (time.perf_counter() - t0)


def main(full=False, mc_samples=None, n_iters=None, device=None,
         dtype=torch.float32, key=None):
    """The three fits on `device` (None: the CUDA card) in `dtype`.  `key`
    (default: a generator of seed 0) is split into six generators, one a
    stage: each fit's optimizer, then its bound pass.  In its place a
    sequence of six sources may be given: each fit's presampled draws and
    each bound pass's log-weights.  Returns the JAX example's dict."""
    device = resolve_device(device)
    mc_samples = mc_samples or (1000000 if full else 100000)
    n_iters = n_iters or (5000 if full else 2000)
    model = robust_regression_model()
    if key is None:
        key = default_generator(device, 0)
    k1, k2, k3, k4, k5, k6 = (split(key, 6)
                              if isinstance(key, torch.Generator) else key)

    # --- KLVI, mean-field t(40) (reference cells 13-21: 245.65 it/s,
    #     khat after PSIS = 0.92) ---
    fam = mean_field_t_variational_family(2, 40)
    klvi = black_box_klvi(fam, model, 100, presampled=True)
    init = torch.as_tensor(np.concatenate([np.zeros(2), np.ones(2)]),
                           dtype=dtype)
    (klvi_param, _, _, _), it_s = timed_optimize(
        n_iters, klvi, init, k1, device, learning_rate=.01)
    print('KLVI mf-t(40): {:.0f} it/s (reference laptop 245.65)'.format(
        it_s))
    check_approx_accuracy(fam, klvi_param, model.true_mean, model.true_cov,
                          verbose=True)
    res, khat, elbo = bounds_and_khat(model, fam, klvi_param, mc_samples, k2)
    print_bounds(res)
    print('khat = {:.3f} (reference 0.92)'.format(khat))
    khat_klvi = khat

    # --- CHIVI alpha=2, warm start (reference cells 23-30: khat 0.341) ---
    chivi = black_box_chivi(2, fam, model, 500, presampled=True)
    chivi_init = klvi_param.clone()
    chivi_init[2:] += 3.0
    (chivi_param, _, _, _), it_s = timed_optimize(
        n_iters, chivi, chivi_init, k3, device, learning_rate=.01)
    print('\nCHIVI: {:.0f} it/s (reference laptop 48.70)'.format(it_s))
    check_approx_accuracy(fam, chivi_param, model.true_mean, model.true_cov,
                          verbose=True)
    res, khat, _ = bounds_and_khat(model, fam, chivi_param, mc_samples, k4,
                                   elbo=elbo)
    print_bounds(res)
    print('khat = {:.3f} (reference 0.341)'.format(khat))
    khat_chivi = khat

    # --- full-rank t(100) KLVI (reference cells 32-38: khat -0.93,
    #     W2 = 0.385, d2 = 5.92e-4, mean_err = 0.0456) ---
    tfam = t_variational_family(2, 100)
    full_klvi = black_box_klvi(tfam, model, 100, presampled=True)
    tinit = tfam.init_param(dtype)
    (full_param, _, _, _), it_s = timed_optimize(
        n_iters, full_klvi, tinit, k5, device, learning_rate=.1,
        learning_rate_end=.001)
    print('\nfull-rank KLVI: {:.0f} it/s (reference laptop 143.81)'.format(
        it_s))
    check_approx_accuracy(tfam, full_param, model.true_mean, model.true_cov,
                          verbose=True)
    res, khat, _ = bounds_and_khat(model, tfam, full_param, mc_samples, k6)
    print_bounds(res)
    print('khat = {:.3f} (reference -0.93)'.format(khat))
    return dict(khat_full=khat, W2_full=res['W2'], d2_full=res['d2'],
                mean_err_full=res['mean_error'], khat_klvi=khat_klvi,
                khat_chivi=khat_chivi)


if __name__ == '__main__':
    a = parser(__doc__.splitlines()[0]).parse_args()
    main(a.full, device=a.device)
