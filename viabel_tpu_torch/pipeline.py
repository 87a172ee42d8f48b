"""Validated VI end to end: optimize -> bound pass -> PSIS.

PyTorch port of viabel_tpu/pipeline.py: the single run `validated_vi`, and
the batches of runs `validated_vi_multistart` (K starts) and
`validated_vi_sweep` (K learning rates).  The JAX package compiles the
whole workflow into one program (vmapped over the runs of a batch); here
it runs as the same sequence of steps on one device:

* windowed adagrad on presampled KLVI (`optimizers._adagrad_run`; a
  batch's K runs at once, `optimizers._adagrad_runs`);
* the bound pass: base draws z, then the fused kernel K1 (transform, score,
  per-chunk statistics) and the combine kernel where the model has a CUDA
  log density (`experiments.draw_and_score`);
* PSIS over the log-weights and the PSIS-corrected moments;
* the scalar bound algebra on the host, after one ``.cpu()`` of each
  reduced result.

A batch's bound passes, PSIS and moments run one run after another.  The
mesh-sharded runs (``mesh=``) are not ported.
"""
import warnings

import numpy as np
import torch

from ._device import default_generator, resolve_device
from .bounds import (STAT_KEYS, divergence_bound, error_bounds,
                     wasserstein_bounds)
from .experiments import draw_and_score
from .families import NoClosedFormMomentError
from .objectives import black_box_klvi, map_draws, stack_draws
from .ops.gaussian_lw import philox_normal
from .ops.philox import philox_seed
from .optimizers import (_adagrad_run, _adagrad_runs, _learning_rates,
                         _perturbed_inits, _wrap_objective)
from .psis import _psislw_1d, _tail_len, weighted_moments

__all__ = ['validated_vi', 'validated_vi_multistart', 'validated_vi_sweep',
           'DivergedRunWarning']


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


def _bound_and_psis(var_family, log_density, alpha, tail_len, opt_param,
                    bound_draws):
    """Draw -> score -> statistics -> PSIS at the fitted `opt_param`
    (viabel_tpu/pipeline.py:149-174)."""
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
    return dict(opt_param=opt_param, q_mean=q_mean, q_cov=q_cov,
                log_weights=lw, smoothed_log_weights=slw, khat=khat,
                psis_mean=psis_mean, psis_cov=psis_cov, stats=stats,
                moments=moments)


def _pipeline_core(obj, var_family, log_density, n_iters, window,
                   learning_rate, epsilon, learning_rate_end, alpha,
                   tail_len, init_param, opt_draws, bound_draws):
    """Optimize -> draw -> score -> statistics -> PSIS
    (viabel_tpu/pipeline.py:138-174).

    `opt_draws` feeds the optimizer (the ``(n_iters, n_mc, d)`` block of a
    presampled objective, or a generator), and `bound_draws` holds the
    bound pass's base draws; the tests pass the exact draws the JAX
    package derives from its key split.  Every returned entry is a tensor
    on the input's device; ``stats`` is the (5,) `bounds.STAT_KEYS`
    tensor and ``moments`` the (2,) C2/C4 tensor.
    """
    values, log_norms, opt_param = _optimize_and_average(
        obj, n_iters, window, learning_rate, epsilon, learning_rate_end,
        init_param, opt_draws)
    out = _bound_and_psis(var_family, log_density, alpha, tail_len,
                          opt_param, bound_draws)
    return dict(value_history=values, log_norm_history=log_norms, **out)


def _batch_core(objective_and_grad, has_log_norm, var_family, log_density,
                n_iters, window, lr_tables, epsilon, alpha, tail_len,
                init_params, opt_draws, bound_draws):
    """The pipeline of K runs (viabel_tpu/pipeline.py:393-412, 732-745):
    the K optimizer runs at once (`optimizers._adagrad_runs`), then each
    run's bound pass and PSIS in turn.

    `init_params` is ``(K, P)``, `lr_tables` the ``(K, n_iters)`` learning
    rates, `opt_draws` the ``(K, n_iters, n_mc, ...)`` draws of a
    presampled objective (or a list of K generators for any other) and
    `bound_draws` the ``(K, n, ...)`` base draws of the bound passes (dicts
    of such blocks for dict draws).  Returns `_pipeline_core`'s dict with a
    leading run axis on every entry.
    """
    values, log_norms, _, opt_params = _adagrad_runs(
        objective_and_grad, has_log_norm, n_iters, window, lr_tables,
        epsilon, init_params, opt_draws)
    runs = [_bound_and_psis(var_family, log_density, alpha, tail_len,
                            opt_params[k],
                            map_draws(lambda v: v[k], bound_draws))
            for k in range(init_params.shape[0])]
    out = {key: torch.stack([r[key] for r in runs]) for key in runs[0]}
    return dict(value_history=values, log_norm_history=log_norms, **out)


def _setup(log_density, var_family, init_param, objective_and_grad,
           n_mc_samples, generator, mesh, device):
    """The entry points' common defaults: the device (None: the CUDA card),
    a generator of seed 0 there, presampled KLVI on (`var_family`,
    `log_density`, `n_mc_samples`), and the init on that device."""
    if mesh is not None:
        raise NotImplementedError('the mesh-sharded pipelines are not '
                                  'ported yet')
    device = resolve_device(device)
    if generator is None:
        generator = default_generator(device)
    if objective_and_grad is None:
        objective_and_grad = black_box_klvi(
            var_family, log_density, n_mc_samples,
            presampled=var_family.base_sample is not None)
    return (device, generator, objective_and_grad,
            torch.as_tensor(init_param, device=device))


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
    _, generator, objective_and_grad, init_param = _setup(
        log_density, var_family, init_param, objective_and_grad,
        n_mc_samples, generator, mesh, device)
    obj = _wrap_objective(objective_and_grad, has_log_norm)
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


def _finalize_batch(out, n_bound_samples, alpha, log_norm_bound):
    """Host assembly for a batch (viabel_tpu/pipeline.py:657-689): each
    run's bounds and khat, and ``best``, the run of the smallest finite
    validated divergence bound (ties to the lowest index; when every run
    diverged, run 0, with one `DivergedRunWarning`)."""
    stats, moments = out.pop('stats'), out.pop('moments')
    bounds, khats, diverged = [], [], []
    for k in range(stats.shape[0]):
        b, kh, dv = _assemble_bounds(stats[k], moments[k], out['khat'][k],
                                     out['q_cov'][k], n_bound_samples,
                                     alpha, log_norm_bound)
        bounds.append(b)
        khats.append(kh)
        diverged.append(dv)
    d_key = 'd2' if alpha == 2 else 'dalpha'
    d_vals = np.asarray([b[d_key] for b in bounds], dtype=float)
    out['bounds'] = bounds
    out['khat'] = khats
    out['best'] = int(np.argmin(np.where(np.isfinite(d_vals), d_vals,
                                         np.inf)))
    if all(diverged):
        warnings.warn(
            'every run in this batch diverged (non-finite log-weights): '
            'bounds are vacuous and `best` is arbitrary. Reduce the '
            'learning rate or switch objective (CHIVI at large d: see '
            'benchmarks/DIM_SCALING.md)', DivergedRunWarning, stacklevel=3)
    return out


def validated_vi_multistart(log_density, var_family, init_param, n_iters, *,
                            n_starts=4, perturb_scale=0.5, init_params=None,
                            objective_and_grad=None, n_mc_samples=100,
                            n_bound_samples=1000000, alpha=2.0,
                            generator=None, has_log_norm=None, window=10,
                            learning_rate=0.01, epsilon=0.1,
                            learning_rate_end=None, log_norm_bound=None,
                            mesh=None, device=None):
    """K independent validated-VI runs as one batch
    (viabel_tpu/pipeline.py:560-654).

    Start 0 runs from `init_param` unperturbed, start o >= 1 from ``init +
    N(0, 1) (o + 1) perturb_scale``, unless explicit `init_params` (K, P)
    are given.  From `generator` (default: seed 0 on `device`, None: the
    CUDA card) come a seed for the perturbation noise (a Philox stream, so
    the CPU and the card perturb alike) and then a seed for each start;
    start k's generator draws its optimizer draws and then its bound
    pass's base draws, so start k is `validated_vi` with that generator
    and its init.  The K optimizer runs go at once, one batched step and
    one step-kernel launch an iteration; the bound passes run in turn.
    `n_bound_samples` is per start.  ``mesh=`` raises NotImplementedError.

    Returns a dict like `validated_vi`'s with a leading start axis on
    every tensor, ``bounds`` a list of K dicts, ``khat`` a list of K
    floats, and ``best`` the index of the start with the smallest finite
    validated divergence bound.
    """
    device, generator, objective_and_grad, init_param = _setup(
        log_density, var_family, init_param, objective_and_grad,
        n_mc_samples, generator, mesh, device)
    dtype = init_param.dtype
    perturb_seed = philox_seed(generator)
    if init_params is None:
        noise = philox_normal(n_starts, init_param.shape[0], perturb_seed,
                              dtype=dtype, device=device)
        init_params = _perturbed_inits(init_param, n_starts, perturb_scale,
                                       noise)
    else:
        init_params = torch.as_tensor(init_params, device=device)
        n_starts = init_params.shape[0]
    generators = [torch.Generator(device=device).manual_seed(
        philox_seed(generator)) for _ in range(n_starts)]
    presampled = getattr(objective_and_grad, 'presampled', False)
    opt_draws = (stack_draws([objective_and_grad.make_draws(g, n_iters,
                                                             dtype)
                               for g in generators])
                 if presampled else generators)
    bound_draws = stack_draws([var_family.base_sample(g, n_bound_samples,
                                                       dtype)
                                for g in generators])
    lr_tables = _learning_rates(n_iters, learning_rate, learning_rate_end,
                                dtype).repeat(n_starts, 1)
    out = _batch_core(objective_and_grad, has_log_norm, var_family,
                      log_density, n_iters, window, lr_tables, epsilon,
                      alpha, _tail_len(n_bound_samples, 1.0), init_params,
                      opt_draws, bound_draws)
    return _finalize_batch(out, n_bound_samples, alpha, log_norm_bound)


def _sweep_rates(learning_rates, learning_rate_ends=None):
    """The sweep's rates as float64 arrays, checked as the JAX package
    checks them (viabel_tpu/pipeline.py:757-770)."""
    lrs = np.asarray(learning_rates, dtype=np.float64)
    if lrs.ndim != 1 or lrs.size == 0:
        raise ValueError('learning_rates must be a non-empty 1-D array')
    if np.any(lrs <= 0):
        raise ValueError('learning rates must be positive')
    lr_ends = None
    if learning_rate_ends is not None:
        lr_ends = np.asarray(learning_rate_ends, dtype=np.float64)
        if lr_ends.shape != lrs.shape:
            raise ValueError('learning_rate_ends must match learning_rates')
        if np.any(lr_ends <= 0) or np.any(lrs <= lr_ends):
            raise ValueError('each end rate must satisfy '
                             '0 < learning_rate_end < learning_rate')
    return lrs, lr_ends


def validated_vi_sweep(log_density, var_family, init_param, n_iters, *,
                       learning_rates, learning_rate_ends=None,
                       objective_and_grad=None, n_mc_samples=100,
                       n_bound_samples=100000, alpha=2.0, generator=None,
                       has_log_norm=None, window=10, epsilon=0.1,
                       log_norm_bound=None, mesh=None, device=None):
    """A learning-rate sweep: the validated pipeline once a rate, as one
    batch, and which rate's fit carries the tightest validated bound
    (viabel_tpu/pipeline.py:748-836).

    Every rate runs from `init_param` on the same draws (common random
    numbers: `generator`, default seed 0 on `device`, draws the optimizer's
    draws and then the bound pass's base draws once, as `validated_vi`
    does, and every rate takes them), so the differences between rates
    are the rate's alone.  An objective that samples from a generator gets
    one copy of the generator's state a rate.  `learning_rates` must be
    positive; `learning_rate_ends` (optional) match them in shape, each
    in ``(0, rate)``.  ``mesh=`` raises NotImplementedError.

    Returns `validated_vi_multistart`'s dict with a leading rate axis, plus
    ``learning_rates`` echoed.
    """
    lrs, lr_ends = _sweep_rates(learning_rates, learning_rate_ends)
    device, generator, objective_and_grad, init_param = _setup(
        log_density, var_family, init_param, objective_and_grad,
        n_mc_samples, generator, mesh, device)
    dtype, K = init_param.dtype, lrs.size

    def shared(block):
        return map_draws(lambda v: v.expand(K, *v.shape), block)

    presampled = getattr(objective_and_grad, 'presampled', False)
    if presampled:
        opt_draws = shared(objective_and_grad.make_draws(generator, n_iters,
                                                         dtype))
    bound_draws = shared(var_family.base_sample(generator, n_bound_samples,
                                                dtype))
    if not presampled:  # the state validated_vi's optimizer would start at
        opt_draws = []
        for _ in range(K):
            opt_draws.append(torch.Generator(device=device))
            opt_draws[-1].set_state(generator.get_state())
    lr_tables = torch.stack([
        _learning_rates(n_iters, lr, None if lr_ends is None else lr_ends[k],
                        dtype) for k, lr in enumerate(lrs)])
    out = _batch_core(objective_and_grad, has_log_norm, var_family,
                      log_density, n_iters, window, lr_tables, epsilon,
                      alpha, _tail_len(n_bound_samples, 1.0),
                      init_param.repeat(K, 1), opt_draws, bound_draws)
    out = _finalize_batch(out, n_bound_samples, alpha, log_norm_bound)
    out['learning_rates'] = lrs
    return out
