"""Experiment harness: optimize, check accuracy, draw and score, bound,
PSIS-correct.

PyTorch port of viabel_tpu/experiments.py:39-184 and 283-387 (the
reporting helpers, `get_samples_and_log_weights`, `psis_correction`,
`improve_with_psis`, and `run_experiment`: KLVI then CHIVI, each followed
by a bound pass and PSIS).  The plots and `improve_with_psis_sharded` are
not ported.

`draw_and_score` and `get_samples_and_log_weights` decide how a bound
pass scores its samples:

* a mean-field Gaussian family and a model whose `kernel` tag names a CUDA
  log density: `get_samples_and_log_weights` goes to K2
  (`ops.gaussian_lw`), which draws the base normals from the Philox stream
  of a seed taken from the generator inside the kernel; the samples, where
  a caller needs them, come from `ops.gaussian_lw.philox_normal` of the
  same stream;
* given base draws z (`draw_and_score`, as `validated_vi` passes them), a
  mean-field family and a kernel-tagged model go through K1
  (`ops.lw_stats`);
* anything else is scored by the plain composition
  ``log p(x) - log q(x)`` and reduced by the log-weight kernels.

The wrappers run the kernels on CUDA tensors and their plain versions on
CPU tensors, so a CPU run draws and scores what a card run does.
"""
import time

import numpy as np
import torch

from ._device import default_generator, resolve_device
from .bounds import all_bounds, family_moment_bounds
from .objectives import black_box_chivi, black_box_klvi
from .ops import gaussian_lw as _gaussian_ops
from .ops import lw_stats as _lw_ops
from .ops.philox import philox_seed
from .optimizers import adagrad_optimize
from .psis import psislw, weighted_moments

__all__ = [
    'print_bounds', 'check_accuracy', 'check_approx_accuracy',
    'get_samples_and_log_weights', 'draw_and_score', 'psis_correction',
    'improve_with_psis', 'run_experiment',
]

# families whose transform is mean + exp(log_scale) * z with a base density
# the fused kernels know
_KERNEL_FAMILIES = ('mf_gaussian', 'mf_t')


def _print_table(title, rows):
    """Aligned label/value report (viabel_tpu/experiments.py:39-47)."""
    print(title)
    width = max((len(label) for label, _ in rows), default=0)
    for label, value in rows:
        print('    {label:<{w}}  {value:.3g}'.format(label=label,
                                                     value=float(value),
                                                     w=width))


def print_bounds(results):
    """Report the bounds present in an `all_bounds` result dict
    (viabel_tpu/experiments.py:50-64)."""
    rows = []
    for key, label in (('W2', '2-Wasserstein'), ('W1', '1-Wasserstein'),
                       ('d2', '2-divergence'), ('mean_error', 'mean error'),
                       ('std_error', 'stdev error')):
        if results.get(key) is not None:
            rows.append((label, results[key]))
    if results.get('cov_error') is not None:
        rows.append(('cov error', results['cov_error']))
        rows.append(('cov error (sqrt)', np.sqrt(results['cov_error'])))
    _print_table('Upper bounds on the approximation error:', rows)


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def check_accuracy(true_mean, true_cov, approx_mean, approx_cov,
                   verbose=False, method=None):
    """Norm-based moment errors against ground truth: 2-norm mean and
    stdev errors, relative stdev error, spectral and nuclear covariance
    errors beside the true covariance's norms
    (viabel_tpu/experiments.py:67-102).  Takes tensors or arrays."""
    true_mean, approx_mean, true_cov, approx_cov = map(
        _host, (true_mean, approx_mean, true_cov, approx_cov))
    true_std = np.sqrt(np.diag(true_cov))
    approx_std = np.sqrt(np.diag(approx_cov))

    results = {} if method is None else {'method': method}
    results['mean_error'] = np.linalg.norm(true_mean - approx_mean)
    results['std_error'] = np.linalg.norm(true_std - approx_std)
    results['rel_std_error'] = np.linalg.norm(approx_std / true_std - 1)
    for suffix, order in (('2', 2), ('nuc', 'nuc')):
        results['cov_error_' + suffix] = np.linalg.norm(
            true_cov - approx_cov, ord=order)
        results['cov_norm_' + suffix] = np.linalg.norm(true_cov, ord=order)

    if verbose:
        print('approx mean   =', approx_mean)
        print('approx stdevs =', approx_std)
        print()
        _print_table('Moment errors vs ground truth:', [
            ('mean error', results['mean_error']),
            ('stdev error', results['std_error']),
            ('sqrt spectral cov error', np.sqrt(results['cov_error_2'])),
            ('sqrt spectral true-cov norm', np.sqrt(results['cov_norm_2'])),
        ])
    return results


def check_approx_accuracy(var_family, var_param, true_mean, true_cov,
                          verbose=False, name=None):
    """`check_accuracy` of the family's moments at `var_param`
    (viabel_tpu/experiments.py:105-110)."""
    mean, cov = var_family.mean_and_cov(torch.as_tensor(var_param))
    return check_accuracy(true_mean, true_cov, mean, cov, verbose, name)


def _draws_in_kernel(log_density, var_family):
    return (getattr(log_density, 'kernel', None) is not None
            and var_family.name == 'mf_gaussian')


def draw_and_score(log_density, var_family, var_param, z, alpha=2.0):
    """Samples, log-weights and their (5,) statistics tensor
    (`bounds.STAT_KEYS` order) for base draws `z` at `var_param`.

    The samples ``var_family.transform(var_param, z)`` are formed in torch
    in both branches; the fused kernel scores from z and never reads them.
    """
    samples = var_family.transform(var_param, z)
    kernel = getattr(log_density, 'kernel', None)
    if kernel is not None and var_family.name in _KERNEL_FAMILIES:
        d = var_family.dim
        lw, stats = _lw_ops.transform_score_stats(
            z.contiguous(), var_param[:d].contiguous(),
            var_param[d:].contiguous(), kernel,
            log_density.kernel_data_like(z), df=var_family.df, alpha=alpha)
        return samples, lw, stats
    lw = log_density(samples) - var_family.log_prob(var_param, samples)
    return samples, lw, _lw_ops.lw_stats(lw.contiguous(), alpha)


def get_samples_and_log_weights(log_density, var_family, var_param,
                                n_samples, generator=None, device=None):
    """Draw ``n_samples`` samples of q and their log-weights
    ``log p - log q`` (viabel_tpu/experiments.py:127-139).  Returns
    ``(samples (n, d), log_weights (n,))`` on `device` (None: the CUDA
    card); `generator` (default: seed 0 there) is advanced.

    A mean-field Gaussian q of a kernel-tagged model draws from the
    Philox stream of a seed taken from `generator`: K2 scores it with the
    draws made in-kernel and `philox_normal` writes the same samples.
    Any other q draws ``var_family.base_sample(generator, n)``."""
    device = resolve_device(device)
    if generator is None:
        generator = default_generator(device)
    var_param = torch.as_tensor(var_param, device=device)
    if _draws_in_kernel(log_density, var_family):
        d = var_family.dim
        seed = philox_seed(generator)
        lw, _ = _gaussian_ops.gaussian_sample_score_partials(
            var_param[:d].contiguous(), var_param[d:].contiguous(),
            n_samples, seed, 0, log_density.kernel,
            log_density.kernel_data_like(var_param))
        z = _gaussian_ops.philox_normal(n_samples, d, seed, 0, 0,
                                        var_param.dtype, device)
        return var_family.transform(var_param, z), lw
    z = var_family.base_sample(generator, n_samples, var_param.dtype)
    samples, lw, _ = draw_and_score(log_density, var_family, var_param, z)
    return samples, lw


def psis_correction(log_density, var_family, var_param, n_samples,
                    generator=None, device=None):
    """Samples (transposed, ``(d, n)``, as in the JAX package), their
    PSIS-smoothed log-weights and khat (viabel_tpu/experiments.py:142-148).
    """
    samples, log_weights = get_samples_and_log_weights(
        log_density, var_family, var_param, n_samples, generator, device)
    smoothed_log_weights, khat = psislw(log_weights)
    return samples.T, smoothed_log_weights, khat


def improve_with_psis(log_density, var_family, var_param, n_samples,
                      true_mean, true_cov, transform=None, verbose=False,
                      generator=None, device=None):
    """PSIS-corrected moment estimates and their accuracy against ground
    truth (viabel_tpu/experiments.py:151-184).  Returns ``(results with
    khat, approx_mean, approx_cov)``, the moments as numpy arrays.

    With no `transform` the weighted moments are computed on the device
    and only the d-sized results reach the host; a `transform` (a numpy
    function of the ``(d, n)`` sample matrix) takes the samples to the host
    first."""
    samples, slw, khat = psis_correction(log_density, var_family, var_param,
                                         n_samples, generator, device)
    return _psis_results(samples, slw, khat, true_mean, true_cov, transform,
                         verbose)


def _psis_results(samples, slw, khat, true_mean, true_cov, transform,
                  verbose):
    """`improve_with_psis`'s moments and report from the ``(d, n)`` samples
    and their smoothed log-weights."""
    if verbose:
        print('khat = {:.3g}'.format(float(khat)))
        print()
    if transform is None:
        approx_mean, approx_cov = weighted_moments(samples.T, slw)
        approx_mean, approx_cov = _host(approx_mean), _host(approx_cov)
    else:
        samples = transform(_host(samples))
        slw = _host(slw)
        slw = slw - np.max(slw)
        wts = np.exp(slw)
        wts = wts / np.sum(wts)
        approx_mean = np.sum(wts[np.newaxis, :] * samples, axis=1)
        c = samples - approx_mean[:, None]
        approx_cov = (wts[np.newaxis, :] * c) @ c.T
    res = check_accuracy(true_mean, true_cov, approx_mean, approx_cov,
                         verbose)
    res['khat'] = float(khat)
    return res, approx_mean, approx_cov


def _stage_banner(name):
    """Section header of the experiment's console log
    (viabel_tpu/experiments.py:283-287)."""
    print()
    print('======== {} ========'.format(name), flush=True)


def _format_seconds(secs):
    """viabel_tpu/utils/timers.py:14-22."""
    if secs < 1e-3:
        t, u = secs * 1e6, 'microsec'
    elif secs < 1e0:
        t, u = secs * 1e3, 'millisec'
    else:
        t, u = secs, 'sec'
    return '{:.03f} {}'.format(t, u)


def _wall(fn, device):
    """``(seconds, fn())`` on the host clock, closed by a synchronize of
    `device` when it is a card."""
    t0 = time.perf_counter()
    out = fn()
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0, out


def _split(generator, k):
    """`k` generators on `generator`'s device, seeded by `k` 64-bit seeds
    drawn from it in turn: the counterpart of ``jax.random.split``."""
    return [torch.Generator(device=generator.device).manual_seed(
        philox_seed(generator)) for _ in range(k)]


def _samples_and_log_weights(log_density, var_family, var_param, n_samples,
                             source):
    """`get_samples_and_log_weights` from a generator, or the same pass on
    given base draws z (the seam the parity tests feed)."""
    if isinstance(source, torch.Generator):
        return get_samples_and_log_weights(log_density, var_family,
                                           var_param, n_samples, source,
                                           var_param.device)
    samples, lw, _ = draw_and_score(log_density, var_family, var_param,
                                    source)
    return samples, lw


def _optimize_and_check_results(log_density, var_family, objective_and_grad,
                                init_var_param, true_mean, true_cov,
                                streams, elbo=None, n_iters=5000,
                                bound_w2=True, verbose=False, use_psis=True,
                                n_psis_samples=1000000, **kwargs):
    """One stage of `run_experiment`: adagrad, the accuracy check, the
    bound pass and PSIS (viabel_tpu/experiments.py:290-345).

    `streams` is ``(optimizer, bound pass, PSIS)``: each a generator, or
    the draws themselves (the optimizer's ``(n_iters, n_mc, d)`` block, the
    passes' base draws z).  `kwargs` go to `adagrad_optimize`, with
    ``has_log_norm=False`` unless given, as in the JAX package.  Besides
    the JAX package's entries, the second result holds ``seconds``: the
    wall time of the optimizer, the bound pass and PSIS.
    """
    opt_src, bound_src, psis_src = streams
    device = init_var_param.device
    kwargs.setdefault('has_log_norm', False)
    kwargs['generator' if isinstance(opt_src, torch.Generator)
           else 'draws'] = opt_src
    seconds = {}
    seconds['optimize'], (opt_param, var_param_history, value_history,
                          _) = _wall(lambda: adagrad_optimize(
                              n_iters, objective_and_grad, init_var_param,
                              device=device, **kwargs), device)
    accuracy_results = check_approx_accuracy(var_family, opt_param,
                                             true_mean, true_cov, verbose)
    other_results = dict(opt_param=_host(opt_param),
                         var_param_history=_host(var_param_history),
                         value_history=_host(value_history),
                         seconds=seconds)
    if bound_w2 not in [False, None]:
        n_samples = 1000000 if bound_w2 is True else int(bound_w2)
        print()

        def bound_pass():
            samples, log_weights = _samples_and_log_weights(
                log_density, var_family, opt_param, n_samples, bound_src)
            var_dist_cov = _host(var_family.mean_and_cov(opt_param)[1])
            # None for df <= 4 t families: empirical fallback from samples
            moment_bound_fn = family_moment_bounds(var_family, opt_param)
            return all_bounds(
                log_weights,
                samples=samples if moment_bound_fn is None else None,
                q_var=var_dist_cov, moment_bound_fn=moment_bound_fn,
                log_norm_bound=elbo)

        seconds['bounds'], bounds = _wall(bound_pass, device)
        other_results.update(bounds)
        print('bound estimation (CUBO + ELBO, {:,} MC samples) took {} to '
              'run'.format(n_samples, _format_seconds(seconds['bounds'])))
        if verbose:
            print()
            print_bounds(other_results)
    if use_psis:
        _stage_banner('PSIS-corrected moments')

        def psis_pass():
            samples, lw = _samples_and_log_weights(
                log_density, var_family, opt_param, n_psis_samples, psis_src)
            slw, khat = psislw(lw)
            return _psis_results(samples.T, slw, khat, true_mean, true_cov,
                                 None, verbose)[0]

        seconds['psis'], other_results['psis_results'] = _wall(psis_pass,
                                                               device)
    return accuracy_results, other_results


def _run_stages(log_density, var_family, klvi, chivi, init_param, true_mean,
                true_cov, kl_streams, chivi_streams, **kwargs):
    """KLVI's stage, then CHIVI's with KLVI's ``log_norm_bound`` as its
    ELBO (viabel_tpu/experiments.py:374-387), each on its streams."""
    _stage_banner('KLVI')
    kl_results, other_kl_results = _optimize_and_check_results(
        log_density, var_family, klvi, init_param, true_mean, true_cov,
        kl_streams, **kwargs)
    kl_results['method'] = 'KLVI'
    _stage_banner('CHIVI')
    elbo = other_kl_results.get('log_norm_bound')
    chivi_results, other_chivi_results = _optimize_and_check_results(
        log_density, var_family, chivi, init_param, true_mean, true_cov,
        chivi_streams, elbo=elbo, **kwargs)
    chivi_results['method'] = 'CHIVI'
    return (klvi, chivi, kl_results, chivi_results, other_kl_results,
            other_chivi_results)


def run_experiment(log_density, var_family, init_param, true_mean, true_cov,
                   kl_n_samples=100, chivi_n_samples=500, alpha=2,
                   plot_contours=None, generator=None, presampled=True,
                   device=None, **kwargs):
    """KLVI then CHIVI on a target, CHIVI reusing KLVI's ELBO as its
    log-normalizer bound; each fit is followed by a bound pass of
    `bound_w2` samples and PSIS at `n_psis_samples`
    (viabel_tpu/experiments.py:348-387).

    `log_density` is a `models.Model` (whose `kernel` tag routes the bound
    and PSIS passes to the fused kernels) or a batched callable.  Runs on
    `device` (None: the CUDA card).  `generator` (default: seed 0 there)
    is split into KLVI's and CHIVI's generators, and each of those into
    the optimizer's, the bound pass's and PSIS's, six streams in all.
    `kwargs` go to each stage (`n_iters`, `bound_w2`, `n_psis_samples`,
    `use_psis`, `verbose`) and on to `adagrad_optimize` (the learning
    rates, `window`, ``has_log_norm``, False by default).  The plots are
    not ported: ``plot_contours=True`` raises NotImplementedError.

    Returns ``(klvi, chivi, kl_results, chivi_results, other_kl_results,
    other_chivi_results)`` as the JAX package does, the arrays in numpy.
    """
    if plot_contours:
        raise NotImplementedError('the contour and history plots are not '
                                  'ported (ROADMAP A.9)')
    device = resolve_device(device)
    if generator is None:
        generator = default_generator(device)
    klvi = black_box_klvi(var_family, log_density, kl_n_samples,
                          presampled=presampled)
    chivi = black_box_chivi(alpha, var_family, log_density, chivi_n_samples,
                            presampled=presampled)
    init_param = torch.as_tensor(init_param, device=device)
    kl_gen, chivi_gen = _split(generator, 2)
    return _run_stages(log_density, var_family, klvi, chivi, init_param,
                       np.asarray(true_mean), true_cov, _split(kl_gen, 3),
                       _split(chivi_gen, 3), **kwargs)
