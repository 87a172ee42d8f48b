"""Validated VI end to end: optimize -> bound pass -> PSIS.

PyTorch port of the single-run pipeline of viabel_tpu/pipeline.py:33-378.
The JAX package compiles the whole workflow into one program; here it runs
eagerly as the same sequence of steps on one device:

* windowed adagrad on presampled KLVI (`optimizers._adagrad_run`);
* the bound pass: base draws z, then the fused kernel K1 (transform, score,
  per-chunk statistics) and the combine kernel where the model has a CUDA
  log density (`experiments.draw_and_score`);
* PSIS over the log-weights and the PSIS-corrected moments;
* the scalar bound algebra on the host, after one ``.cpu()`` of each
  reduced result.

The mesh-sharded run, `validated_vi_multistart` and `validated_vi_sweep`
come with a later slice.
"""
import warnings

import numpy as np
import torch

from ._device import default_generator, resolve_device
from .bounds import (STAT_KEYS, divergence_bound, error_bounds,
                     wasserstein_bounds)
from .experiments import draw_and_score
from .families import NoClosedFormMomentError
from .objectives import black_box_klvi
from .optimizers import _adagrad_run, _wrap_objective
from .psis import _psislw_1d, _tail_len, weighted_moments

__all__ = ['validated_vi', 'DivergedRunWarning']


class DivergedRunWarning(UserWarning):
    """An optimizer run produced a non-finite fit: the pipeline returns
    infinite bounds and a NaN khat instead of raising, and warns with this
    category (viabel_tpu/pipeline.py:33-44)."""


def _optimize_and_average(obj, n_iters, window, learning_rate, epsilon,
                          learning_rate_end, init_param, opt_draws):
    """The adagrad run without its iterate history, returning the
    tail-quarter average (viabel_tpu/pipeline.py:61-78)."""
    values, log_norms, _, opt_param = _adagrad_run(
        obj, n_iters, window, learning_rate, epsilon, learning_rate_end,
        init_param, opt_draws, keep_history=False)
    return values, log_norms, opt_param


def _closed_form_moments(var_family, opt_param, alpha):
    """Closed-form C2/C4 as a (2,) tensor, NaN placeholders for alpha != 2,
    or None when the family has no closed-form 4th moment
    (viabel_tpu/pipeline.py:81-99)."""
    if alpha != 2:
        return torch.full((2,), float('nan'), dtype=opt_param.dtype,
                          device=opt_param.device)
    try:
        return torch.stack([var_family.pth_moment(opt_param, 2),
                            var_family.pth_moment(opt_param, 4)])
    except NoClosedFormMomentError:
        return None


def _pipeline_core(obj, var_family, log_density, n_iters, window,
                   learning_rate, epsilon, learning_rate_end, alpha,
                   tail_len, init_param, opt_draws, bound_draws):
    """Optimize -> draw -> score -> statistics -> PSIS
    (viabel_tpu/pipeline.py:138-174).

    `opt_draws` feeds the optimizer (the ``(n_iters, n_mc, d)`` block of a
    presampled objective, or a generator), and `bound_draws` holds the
    bound pass's base draws z; the tests pass the exact draws the JAX
    package derives from its key split.  Every returned entry is a tensor
    on the input's device; ``stats`` is the (5,) `bounds.STAT_KEYS`
    tensor and ``moments`` the (2,) C2/C4 tensor.
    """
    values, log_norms, opt_param = _optimize_and_average(
        obj, n_iters, window, learning_rate, epsilon, learning_rate_end,
        init_param, opt_draws)
    samples, lw, stats = draw_and_score(log_density, var_family, opt_param,
                                        bound_draws, alpha)
    moments = _closed_form_moments(var_family, opt_param, alpha)
    if moments is None:  # e.g. a t family with df <= 4: empirical C2/C4
        c = samples - torch.mean(samples, dim=0, keepdim=True)
        norm2 = torch.sum(c ** 2, dim=1)
        moments = torch.stack([torch.mean(norm2), torch.mean(norm2 ** 2)])
    slw, khat = _psislw_1d(lw, tail_len)
    psis_mean, psis_cov = weighted_moments(samples, slw)
    q_mean, q_cov = var_family.mean_and_cov(opt_param)
    return dict(opt_param=opt_param, value_history=values,
                log_norm_history=log_norms, q_mean=q_mean, q_cov=q_cov,
                log_weights=lw, smoothed_log_weights=slw, khat=khat,
                psis_mean=psis_mean, psis_cov=psis_cov, stats=stats,
                moments=moments)


def validated_vi(log_density, var_family, init_param, n_iters, *,
                 objective_and_grad=None, n_mc_samples=100,
                 n_bound_samples=1000000, alpha=2.0, generator=None,
                 has_log_norm=None, window=10, learning_rate=0.01,
                 epsilon=0.1, learning_rate_end=None, log_norm_bound=None,
                 mesh=None, device=None):
    """The validated-VI pipeline: windowed adagrad, error bounds from
    `n_bound_samples` Monte Carlo log-weights, and PSIS-corrected moments
    (viabel_tpu/pipeline.py:247-346).

    `log_density` is a `models.Model` or a batched log-density callable;
    a Model whose `kernel` names a CUDA log density is scored by the fused
    bound-pass kernel.  The objective defaults to KLVI on
    (`var_family`, `log_density`, `n_mc_samples`), presampled when the
    family has a `base_sample`.  Runs on `device` (None: the CUDA card)
    with `generator` (default: seed 0 there), which draws the optimizer's
    draws first and the bound pass's base draws second.

    Returns a dict with ``opt_param``, ``value_history``,
    ``log_norm_history``, ``q_mean``, ``q_cov``, ``log_weights``,
    ``smoothed_log_weights``, ``psis_mean``, ``psis_cov`` (tensors),
    ``khat`` (float) and ``bounds`` (the `all_bounds` dict).
    """
    if mesh is not None:
        raise NotImplementedError('the mesh-sharded pipeline is not ported '
                                  'yet')
    device = resolve_device(device)
    if generator is None:
        generator = default_generator(device)
    if objective_and_grad is None:
        objective_and_grad = black_box_klvi(
            var_family, log_density, n_mc_samples,
            presampled=var_family.base_sample is not None)
    obj = _wrap_objective(objective_and_grad, has_log_norm)
    init_param = torch.as_tensor(init_param, device=device)
    opt_draws = generator
    if obj.presampled:
        opt_draws = objective_and_grad.make_draws(generator, n_iters,
                                                  init_param.dtype)
    bound_draws = var_family.base_sample(generator, n_bound_samples,
                                         init_param.dtype)
    out = _pipeline_core(obj, var_family, log_density, n_iters, window,
                         learning_rate, epsilon, learning_rate_end, alpha,
                         _tail_len(n_bound_samples, 1.0), init_param,
                         opt_draws, bound_draws)
    bounds, khat, diverged = _assemble_bounds(
        out.pop('stats'), out.pop('moments'), out['khat'], out['q_cov'],
        n_bound_samples, alpha, log_norm_bound)
    # the divergence signal is non-finite LOG-WEIGHT STATISTICS: khat = inf
    # is also the legitimate short-tail outcome of a tiny, healthy bound pass
    if diverged:
        warnings.warn(
            'the optimizer run diverged (non-finite log-weights at the '
            'fitted parameter): bounds are vacuous. Reduce the learning '
            'rate', DivergedRunWarning, stacklevel=2)
    out['bounds'] = bounds
    out['khat'] = khat
    return out


def _assemble_bounds(stats, moments, khat, q_cov, n, alpha, log_norm_bound):
    """Host-side `all_bounds` from the reduced tensors, one ``.cpu()``
    each (viabel_tpu/pipeline.py:349-378).  A diverged run (non-finite
    statistics or covariance) degrades to infinite bounds instead of
    raising.  Returns ``(bounds, khat, diverged)``."""
    stats = dict(zip(STAT_KEYS, stats.cpu().tolist()), n=n)
    c2, c4 = moments.cpu().tolist()
    khat = float(khat.cpu())
    q_cov = q_cov.cpu().numpy()
    if not np.all(np.isfinite(q_cov)):
        q_cov = np.inf
    finite_stats = all(np.isfinite(stats[k]) for k in STAT_KEYS)
    if finite_stats:
        d2, log_norm_bound = divergence_bound(
            None, alpha=alpha, log_norm_bound=log_norm_bound,
            return_log_norm_bound=True, _stats=stats)
    else:
        d2 = np.inf
        if log_norm_bound is None:
            log_norm_bound = -np.inf
    bounds = {}
    if alpha == 2:
        moments = {2: c2, 4: c4}
        moment_fn = (moments.get if np.isfinite(c2) and np.isfinite(c4)
                     else lambda p: np.inf)
        bounds = wasserstein_bounds(d2 if np.isfinite(d2) else np.inf,
                                    moment_bound_fn=moment_fn)
        bounds.update(error_bounds(q_var=q_cov, **bounds))
    bounds['d2' if alpha == 2 else 'dalpha'] = d2
    bounds['log_norm_bound'] = log_norm_bound
    return bounds, khat, not finite_stats
