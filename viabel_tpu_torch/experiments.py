"""Experiment harness: check accuracy, draw and score, PSIS-correct.

PyTorch port of viabel_tpu/experiments.py:39-184 (the reporting helpers,
`get_samples_and_log_weights`, `psis_correction`, `improve_with_psis`).

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
import numpy as np
import torch

from ._device import default_generator, resolve_device
from .ops import gaussian_lw as _gaussian_ops
from .ops import lw_stats as _lw_ops
from .ops.philox import philox_seed
from .psis import psislw, weighted_moments

__all__ = [
    'print_bounds', 'check_accuracy', 'check_approx_accuracy',
    'get_samples_and_log_weights', 'draw_and_score', 'psis_correction',
    'improve_with_psis',
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
            var_param[d:].contiguous(), kernel, log_density.kernel_data,
            df=var_family.df, alpha=alpha)
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
            log_density.kernel_data)
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
