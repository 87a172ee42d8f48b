"""Validated posterior error bounds.

PyTorch port of viabel_tpu/bounds.py:47-405.  The sample-axis statistics
of the log-weights come from one pass of the log-weight kernels
(`ops.lw_stats`: K3 and the combine on CUDA, their plain versions on the
CPU), and reach the host as one ``.cpu()`` of a (5,) tensor.  The bound
algebra on those scalars is numpy, as in the JAX package.
"""
import math
import threading
from collections import OrderedDict
from warnings import warn

import numpy as np
import torch

from ._trace import span, to_host
from .families import NoClosedFormMomentError
from .ops import lw_stats as _lw_ops

__all__ = [
    'all_bounds',
    'error_bounds',
    'wasserstein_bounds',
    'divergence_bound',
    'log_weight_stats',
    'central_moments',
    'family_moment_bounds',
    'MonteCarloErrorWarning',
]

STAT_KEYS = ('log_rescale', 'mean_rescaled_alpha', 'std_rescaled_alpha',
             'mean_lw', 'std_lw')

# family identities whose pth_moment(-, 4) has no closed form: an LRU, so a
# serving process keeps its hot families and evicts cold ones; one lock
# around check+move and insert+evict (viabel_tpu/bounds.py:53-69)
_families_without_closed_moments = OrderedDict()
_NO_CLOSED_MOMENTS_CAP = 64
_no_closed_moments_lock = threading.Lock()


def family_moment_bounds(family, var_param):
    """A `moment_bound_fn` backed by the family's closed-form C2 and C4,
    fetched in one ``.cpu()``; None when the family has no finite
    closed-form 4th moment (callers then use empirical central moments)
    (viabel_tpu/bounds.py:72-113).  Only `NoClosedFormMomentError` maps to
    None; any other error propagates."""
    with _no_closed_moments_lock:
        if family in _families_without_closed_moments:
            _families_without_closed_moments.move_to_end(family)
            return None
    try:
        c24 = torch.stack([family.pth_moment(var_param, 2),
                           family.pth_moment(var_param, 4)])
        c2, c4 = to_host(c24).tolist()
    except NoClosedFormMomentError:
        with _no_closed_moments_lock:
            _families_without_closed_moments[family] = True
            if len(_families_without_closed_moments) > _NO_CLOSED_MOMENTS_CAP:
                _families_without_closed_moments.popitem(last=False)
        return None
    moments = {2: c2, 4: c4}
    return lambda p: moments[p]


class MonteCarloErrorWarning(UserWarning):
    """A Monte Carlo bound estimate's standard error exceeds the 0.01
    threshold (viabel_tpu/bounds.py:116-121)."""


def _as_tensor(x):
    """A tensor as is; an array-like as a floating CPU tensor (float32 and
    float64 kept, anything else as float64)."""
    if isinstance(x, torch.Tensor):
        return x
    x = np.asarray(x)
    return torch.as_tensor(x.astype(np.result_type(x.dtype, np.float32)))


def log_weight_stats(log_weights, alpha=2.0):
    """Statistics of a log-weight vector in one pass: ``log_rescale``
    (max), ``mean_rescaled_alpha`` / ``std_rescaled_alpha`` (moments of
    ``exp(lw - max)**alpha``), ``mean_lw`` / ``std_lw``, as floats, plus
    ``n`` (viabel_tpu/bounds.py:124-156).  A CUDA tensor goes through the
    K3 and combine kernels; anything else through their plain versions."""
    lw = _as_tensor(log_weights).reshape(-1).contiguous()
    values = to_host(_lw_ops.lw_stats(lw, float(alpha))).tolist()
    out = dict(zip(STAT_KEYS, values))
    out['n'] = int(lw.shape[0])
    return out


def central_moments(samples, with_cov=True):
    """Empirical centred norm moments ``C_p = E||x - mean||^p`` for p in
    {2, 4}, plus the sample covariance when ``with_cov``
    (viabel_tpu/bounds.py:159-191).  C4 is the norm moment, with cross
    terms."""
    x = _as_tensor(samples)
    if x.dim() == 1:
        x = x[:, None]
    c = x - torch.mean(x, dim=0, keepdim=True)
    norm2 = torch.sum(c ** 2, dim=1)
    out = dict(C2=torch.mean(norm2), C4=torch.mean(norm2 ** 2))
    if with_cov:
        out['cov'] = (c.T @ c) / (x.shape[0] - 1)
    return out


def _check_mc_error(mean, stderr, atol=0.01, rtol=0.0, quantity_name=None):
    """Warn when the MC standard error is large
    (viabel_tpu/bounds.py:213-225)."""
    if stderr > rtol * np.abs(mean) + atol:
        msg = 'significant Monte Carlo error'
        if quantity_name is not None:
            msg += ' when computing ' + quantity_name
        msg += ' (mean = {}, standard deviation = {})'.format(mean, stderr)
        warn(msg, MonteCarloErrorWarning)
    return mean


def divergence_bound(log_weights, alpha=2.0, log_norm_bound=None,
                     return_log_norm_bound=False, _stats=None):
    """Monte Carlo bound on ``D_alpha(q || p)``:
    ``alpha/(alpha-1) * (CUBO_alpha - log_norm_bound)``, with the ELBO as
    the log-normalizer bound when none is given
    (viabel_tpu/bounds.py:228-259).  `_stats` takes a precomputed
    `log_weight_stats` dict."""
    if alpha <= 1:
        raise ValueError('alpha must be greater than 1')
    s = log_weight_stats(log_weights, alpha=alpha) if _stats is None \
        else _stats
    n = s['n']
    mean_rescaled = _check_mc_error(
        float(s['mean_rescaled_alpha']),
        float(s['std_rescaled_alpha']) / np.sqrt(n), quantity_name='CUBO')
    cubo = np.log(mean_rescaled) / alpha + float(s['log_rescale'])
    if log_norm_bound is None:
        log_norm_bound = _check_mc_error(
            float(s['mean_lw']), float(s['std_lw']) / np.sqrt(n),
            quantity_name='ELBO')
    dalpha = alpha / (alpha - 1) * (cubo - log_norm_bound)
    if return_log_norm_bound:
        return dalpha, log_norm_bound
    return dalpha


def wasserstein_bounds(d2, samples=None, moment_bound_fn=None, _moments=None):
    """``W_p <= 2 C_{2p}^{1/(2p)} expm1(d2)^{1/(2p)}`` for p in {1, 2}
    (viabel_tpu/bounds.py:262-311), in log space so a large d2 saturates to
    inf instead of overflowing; a negative MC d2 clamps to 0."""
    results = dict()
    if moment_bound_fn is None:
        if samples is None and _moments is None:
            raise ValueError('must provide samples if moment_bound_fn not '
                             'given')
        m = central_moments(samples) if _moments is None else _moments
        c24 = torch.stack([_as_tensor(m['C2']), _as_tensor(m['C4'])])
        c2, c4 = to_host(c24).tolist()
        moments = {2: c2, 4: c4}
        moment_bound_fn = lambda p: moments[p]
    d2 = max(float(d2), 0.0)
    for p in [1, 2]:
        Cp = float(moment_bound_fn(2 * p))
        if Cp < 0 or math.isnan(Cp) or math.isnan(d2):
            w = math.nan
        elif d2 == 0.0 or Cp == 0.0:
            w = 0.0
        else:
            if d2 < 700.0:
                log_em1 = math.log(math.expm1(d2))
            else:
                log_em1 = d2 + math.log1p(-math.exp(-d2))
            log_w = math.log(2.0) + (.5 / p) * (math.log(Cp) + log_em1)
            try:
                w = math.exp(log_w)
            except OverflowError:  # vacuous bound
                w = math.inf
        results['W{}'.format(p)] = w
    return results


def _compute_norm_if_needed(var):
    """Spectral norm of a covariance matrix (array or tensor), identity on
    scalars."""
    if isinstance(var, torch.Tensor):
        var = to_host(var).numpy()
    var = np.asarray(var)
    if var.ndim == 2:
        return np.linalg.norm(var, ord=2)
    return var


def mean_bound(Wp):
    """|E_p[x] - E_q[x]| <= W_p (viabel_tpu/bounds.py:323-325)."""
    return Wp


def std_bound(W2):
    """Stdev error bound (viabel_tpu/bounds.py:328-330)."""
    return W2


def var_bound(W2, var1, var2=None):
    """Covariance error bound ``2 (min_std W2 + W2^2)``, saturating to
    inf (viabel_tpu/bounds.py:333-345)."""
    if var2 is not None:
        min_var = np.min([var1, var2], axis=0)
    else:
        min_var = var1
    min_std = np.sqrt(min_var)
    W2 = np.float64(W2)
    with np.errstate(over='ignore'):
        return 2 * (min_std * W2 + W2 ** 2)


def error_bounds(W1=np.inf, W2=np.inf, q_var=np.inf, p_var=np.inf):
    """Mean / stdev / covariance error bounds from Wasserstein bounds
    (viabel_tpu/bounds.py:348-356)."""
    results = dict()
    results['mean_error'] = mean_bound(min(W1, W2))
    results['std_error'] = std_bound(W2)
    results['cov_error'] = var_bound(W2, _compute_norm_if_needed(q_var),
                                     _compute_norm_if_needed(p_var))
    return results


def all_bounds(log_weights, samples=None, moment_bound_fn=None,
               q_var=None, p_var=None, log_norm_bound=None, alpha=2.0):
    """Every error and distance bound: `divergence_bound` ->
    `wasserstein_bounds` -> `error_bounds` (viabel_tpu/bounds.py:359-405).
    Returns ``mean_error``, ``std_error``, ``cov_error``, ``W1``, ``W2``,
    ``d2`` and ``log_norm_bound``.  `alpha` must be 2."""
    if alpha != 2:
        raise ValueError('all_bounds requires alpha == 2 (the Wasserstein '
                         'and moment-error bounds are 2-divergence bounds); '
                         'use divergence_bound for other orders')
    with span('host_bounds'):
        stats = log_weight_stats(log_weights, alpha=alpha)
        moments = None
        if samples is not None:
            moments = central_moments(samples, with_cov=q_var is None)
        d2, log_norm_bound = divergence_bound(
            None, alpha=alpha, log_norm_bound=log_norm_bound,
            return_log_norm_bound=True, _stats=stats)
        results = wasserstein_bounds(d2, moment_bound_fn=moment_bound_fn,
                                     _moments=moments)
        if q_var is None:
            q_var = moments['cov'] if moments is not None else np.inf
        if p_var is None:
            p_var = np.inf
        results.update(error_bounds(q_var=q_var, p_var=p_var, **results))
        results['d2'] = d2
        results['log_norm_bound'] = log_norm_bound
        return results
