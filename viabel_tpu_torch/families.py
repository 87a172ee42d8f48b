"""Variational families as bundles of plain tensor functions.

PyTorch port of viabel_tpu/families.py.  The mean-field families'
parameters are flat vectors ``[location (d), log scale (d)]``; the
full-rank families' are ``[mu (d), log diag L (d), strict lower L]`` with
the strict lower triangle in ``np.tril_indices(d, k=-1)`` (row-major)
order, so a JAX parameter vector means the same here.  Sampling takes an
explicit `torch.Generator` in place of a JAX key and draws on the
generator's device; ``sample(g, p, n) == transform(p, base_sample(g, n))``
holds exactly, which is what presampled objectives and the tests' shared
draws rely on.  The full-rank Student-t family's base draws are a dict
``{'z': (n, d), 'chi2': (n,)}``.
"""
import math
from functools import lru_cache
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .distributions import (chi2_sample, diag_normal_logpdf,
                            diag_student_t_logpdf, mvn_logpdf_chol,
                            mvt_logpdf_chol, student_t_sample)

__all__ = [
    'VariationalFamily',
    'NoClosedFormMomentError',
    'mean_field_gaussian_variational_family',
    'mean_field_t_variational_family',
    'full_rank_gaussian_variational_family',
    't_variational_family',
    'init_from_moments',
]

_LOG_2PI = math.log(2.0 * math.pi)


class NoClosedFormMomentError(ValueError):
    """Raised by `pth_moment` when the requested moment has no finite
    closed form (a Student-t with ``2 < df <= p``); callers branch on
    exactly this type to the empirical-moment fallback
    (viabel_tpu/families.py:48-58)."""


def _memoized_constructor(build):
    """Memoize a family constructor on normalized ``(int dim, float df)``
    arguments, so reconstructing a family returns the same object and
    identity-keyed caches (`bounds.family_moment_bounds`) hit
    (viabel_tpu/families.py:61-86)."""
    cached = lru_cache(maxsize=256)(build)

    def constructor(dim, df=None):
        if df is None:
            return cached(int(dim))
        return cached(int(dim), float(df))

    constructor.__name__ = build.__name__
    constructor.__qualname__ = build.__qualname__
    constructor.__doc__ = build.__doc__
    return constructor


class VariationalFamily(NamedTuple):
    """Bundle of functions defining a variational family
    (viabel_tpu/families.py:102-143).

    Fields
    ------
    sample : (generator, var_param, n_samples) -> (n_samples, dim)
    entropy : (var_param) -> scalar
    log_prob : (var_param, x) -> (n,) log q(x; var_param)
    mean_and_cov : (var_param) -> (mean (dim,), cov (dim, dim))
    pth_moment : (var_param, p) -> scalar bound on E||x - mean||^p, p in {2, 4}
    var_param_dim, dim : int
    name : str
    base_sample : (generator, n_samples, dtype) -> parameter-free draws
    transform : (var_param, draws) -> (n_samples, dim)
    df : degrees of freedom of a Student-t family, else None
    """
    sample: Callable
    entropy: Callable
    log_prob: Callable
    mean_and_cov: Callable
    pth_moment: Callable
    var_param_dim: int
    dim: int
    name: str
    base_sample: Callable = None
    transform: Callable = None
    df: Optional[float] = None

    def init_param(self, dtype=torch.float32, device='cpu'):
        return torch.zeros(self.var_param_dim, dtype=dtype, device=device)


@_memoized_constructor
def mean_field_gaussian_variational_family(dim):
    """Mean-field Gaussian, ``var_param = [mean (d), log_std (d)]``
    (viabel_tpu/families.py:146-188)."""

    def unpack(var_param):
        return var_param[:dim], var_param[dim:]

    def base_sample(generator, n_samples, dtype=torch.float32):
        return torch.randn((n_samples, dim), generator=generator,
                           dtype=dtype, device=generator.device)

    def transform(var_param, z):
        mean, log_std = unpack(var_param)
        return mean + torch.exp(log_std) * z

    def sample(generator, var_param, n_samples):
        return transform(var_param,
                         base_sample(generator, n_samples, var_param.dtype))

    def entropy(var_param):
        _, log_std = unpack(var_param)
        return 0.5 * dim * (1.0 + _LOG_2PI) + torch.sum(log_std)

    def log_prob(var_param, x):
        mean, log_std = unpack(var_param)
        return diag_normal_logpdf(x, mean, log_std)

    def mean_and_cov(var_param):
        mean, log_std = unpack(var_param)
        return mean, torch.diag(torch.exp(2 * log_std))

    def pth_moment(var_param, p):
        if p not in (2, 4):
            raise ValueError('only p = 2 or 4 supported')
        _, log_std = unpack(var_param)
        variances = torch.exp(2 * log_std)
        if p == 2:
            return torch.sum(variances)
        return 2 * torch.sum(variances ** 2) + torch.sum(variances) ** 2

    return VariationalFamily(sample, entropy, log_prob, mean_and_cov,
                             pth_moment, 2 * dim, dim, 'mf_gaussian',
                             base_sample, transform)


@_memoized_constructor
def mean_field_t_variational_family(dim, df):
    """Mean-field Student-t, ``var_param = [mean (d), log_scale (d)]``
    (viabel_tpu/families.py:191-245).  The entropy drops df-only
    constants."""
    if df <= 2:
        raise ValueError('df must be greater than 2')

    def unpack(var_param):
        return var_param[:dim], var_param[dim:]

    def base_sample(generator, n_samples, dtype=torch.float32):
        return student_t_sample(generator, df, (n_samples, dim), dtype)

    def transform(var_param, t):
        mean, log_scale = unpack(var_param)
        return mean + torch.exp(log_scale) * t

    def sample(generator, var_param, n_samples):
        return transform(var_param,
                         base_sample(generator, n_samples, var_param.dtype))

    def entropy(var_param):
        _, log_scale = unpack(var_param)
        return torch.sum(log_scale)

    def log_prob(var_param, x):
        mean, log_scale = unpack(var_param)
        return diag_student_t_logpdf(x, df, mean, log_scale)

    def mean_and_cov(var_param):
        mean, log_scale = unpack(var_param)
        return mean, df / (df - 2) * torch.diag(torch.exp(2 * log_scale))

    def pth_moment(var_param, p):
        if p not in (2, 4):
            raise ValueError('only p = 2 or 4 supported')
        if df <= p:
            raise NoClosedFormMomentError(
                'df must be greater than p = {} for a closed-form moment '
                '(df = {}); callers fall back to empirical central '
                'moments'.format(p, df))
        _, log_scale = unpack(var_param)
        scales = torch.exp(log_scale)
        c = df / (df - 2)
        if p == 2:
            return c * torch.sum(scales ** 2)
        return c ** 2 * (2 * (df - 1) / (df - 4) * torch.sum(scales ** 4)
                         + torch.sum(scales ** 2) ** 2)

    return VariationalFamily(sample, entropy, log_prob, mean_and_cov,
                             pth_moment, 2 * dim, dim, 'mf_t',
                             base_sample, transform, df)


@lru_cache(maxsize=None)
def _chol_scatter_index(dim, device):
    """The row-major positions in the (d, d) factor of ``[strict lower L,
    diag L]``: ``torch.tril_indices(d, d, -1)`` walks the strict lower
    triangle in the order of ``np.tril_indices(d, k=-1)``, then the
    diagonal."""
    rows, cols = torch.tril_indices(dim, dim, -1)
    return torch.cat([rows * dim + cols,
                      torch.arange(dim) * (dim + 1)]).to(device)


def _unpack_chol(var_param, dim):
    """Unpack ``[mu, log diag L, strict lower L]`` into (mu, L)
    (viabel_tpu/families.py:248-258).  L is one scatter of the entries
    into zeros, so it builds alike under autograd, `torch.func.vmap` and a
    CUDA graph capture, and its gradient is one gather.  (A gather of L
    from ``[entries, 0]`` read the one zero at each of the d (d - 1) / 2
    entries above the diagonal, and its backward, an accumulating
    index_put, summed those into that one slot one after another: 3.9 ms
    of a 4.3 ms iteration at d = 300 on an H100, PERF.md.)"""
    mu = var_param[:dim]
    entries = torch.cat([var_param[2 * dim:],
                         torch.exp(var_param[dim:2 * dim])])
    index = _chol_scatter_index(dim, var_param.device)
    L = entries.new_zeros(dim * dim).scatter(0, index, entries)
    return mu, L.reshape(dim, dim)


def _chol_param_dim(dim):
    return dim * (dim + 3) // 2


def _full_rank_moment(L, p, c2=1.0, c4=1.0):
    """``c2 tr(Sigma)`` (p = 2) or ``c4 (2 tr(Sigma^2) + tr(Sigma)^2)``
    (p = 4) for ``Sigma = L L^T``."""
    tr_sigma = torch.sum(L ** 2)
    if p == 2:
        return c2 * tr_sigma
    tr_sigma2 = torch.sum((L.T @ L) ** 2)  # tr(Sigma^2) = ||L^T L||_F^2
    return c4 * (2 * tr_sigma2 + tr_sigma ** 2)


@_memoized_constructor
def full_rank_gaussian_variational_family(dim):
    """Full-rank Gaussian with the Cholesky parameterization
    (viabel_tpu/families.py:265-314): ``x = mu + z L^T``."""

    def base_sample(generator, n_samples, dtype=torch.float32):
        return torch.randn((n_samples, dim), generator=generator,
                           dtype=dtype, device=generator.device)

    def transform(var_param, z):
        mu, L = _unpack_chol(var_param, dim)
        return mu + z @ L.T

    def sample(generator, var_param, n_samples):
        return transform(var_param,
                         base_sample(generator, n_samples, var_param.dtype))

    def entropy(var_param):
        return (torch.sum(var_param[dim:2 * dim])
                + 0.5 * dim * (1.0 + _LOG_2PI))

    def log_prob(var_param, x):
        mu, L = _unpack_chol(var_param, dim)
        return mvn_logpdf_chol(x, mu, L)

    def mean_and_cov(var_param):
        mu, L = _unpack_chol(var_param, dim)
        return mu, L @ L.T

    def pth_moment(var_param, p):
        if p not in (2, 4):
            raise ValueError('only p = 2 or 4 supported')
        return _full_rank_moment(_unpack_chol(var_param, dim)[1], p)

    return VariationalFamily(sample, entropy, log_prob, mean_and_cov,
                             pth_moment, _chol_param_dim(dim), dim,
                             'full_rank_gaussian', base_sample, transform)


@_memoized_constructor
def t_variational_family(dim, df):
    """Full-rank multivariate Student-t with the Cholesky parameterization
    (viabel_tpu/families.py:317-384): the scale mixture ``mu + (z L^T) /
    s`` with ``s = sqrt(chi2_df / df)`` shared by every coordinate of a
    sample; the base draws are ``{'z': (n, d), 'chi2': (n,)}``.  The
    entropy drops df-only constants; the fourth moment carries the shared
    divisor's ``df^2 / ((df - 2)(df - 4))``."""
    if df <= 2:
        raise ValueError('df must be greater than 2')

    def base_sample(generator, n_samples, dtype=torch.float32):
        z = torch.randn((n_samples, dim), generator=generator, dtype=dtype,
                        device=generator.device)
        return dict(z=z, chi2=chi2_sample(generator, df, (n_samples,),
                                          dtype))

    def transform(var_param, draws):
        mu, L = _unpack_chol(var_param, dim)
        s = torch.sqrt(draws['chi2'] / df)
        return mu + (draws['z'] @ L.T) / s[..., None]

    def sample(generator, var_param, n_samples):
        return transform(var_param,
                         base_sample(generator, n_samples, var_param.dtype))

    def entropy(var_param):
        return torch.sum(var_param[dim:2 * dim])  # = 0.5 log det Sigma

    def log_prob(var_param, x):
        mu, L = _unpack_chol(var_param, dim)
        return mvt_logpdf_chol(x, mu, L, df)

    def mean_and_cov(var_param):
        mu, L = _unpack_chol(var_param, dim)
        return mu, df / (df - 2.0) * (L @ L.T)

    def pth_moment(var_param, p):
        if p not in (2, 4):
            raise ValueError('only p = 2 or 4 supported')
        if df <= p:
            raise NoClosedFormMomentError(
                'df must be greater than p = {} for a closed-form moment '
                '(df = {}); callers fall back to empirical central '
                'moments'.format(p, df))
        return _full_rank_moment(_unpack_chol(var_param, dim)[1], p,
                                 df / (df - 2),
                                 df ** 2 / ((df - 2) * (df - 4)))

    return VariationalFamily(sample, entropy, log_prob, mean_and_cov,
                             pth_moment, _chol_param_dim(dim), dim,
                             'full_rank_t', base_sample, transform, df)


def init_from_moments(family, mean, cov):
    """Variational parameters of `family` from a target's first and second
    moments (viabel_tpu/families.py:387-411): ``[mean, 0.5 log diag(cov)]``
    for a mean-field family, ``[mean, log diag L, strict lower L]`` of the
    Cholesky factor ``L`` of `cov` for a full-rank one.  For a Student-t
    family the scale is set from `cov` directly, with no df/(df - 2)
    correction, as the JAX package and the reference notebooks do.
    Returns a float64 CPU tensor."""
    mean = np.asarray(mean, dtype=float)
    cov = np.atleast_2d(np.asarray(cov, dtype=float))
    d = family.dim
    if mean.shape != (d,) or cov.shape != (d, d):
        raise ValueError('moments must have shape ({0},) and ({0}, {0})'
                         .format(d))
    if family.name in ('mf_gaussian', 'mf_t'):
        log_scale = 0.5 * np.log(np.diag(cov))
        return torch.as_tensor(np.concatenate([mean, log_scale]))
    L = np.linalg.cholesky(cov)
    off = L[np.tril_indices(d, k=-1)]
    return torch.as_tensor(np.concatenate([mean, np.log(np.diag(L)), off]))
