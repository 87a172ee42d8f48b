"""Log densities and rejection-free samplers for the variational families.

PyTorch port of viabel_tpu/distributions.py:42-141.  Densities are plain
tensor functions, shape polymorphic over a leading sample batch and
differentiable by autograd.  Samplers take an explicit `torch.Generator`
and draw on its device.

The Cholesky and dense multivariate densities
(viabel_tpu/distributions.py:144-208) belong to the full-rank families and
are not ported yet.
"""
import math

import torch

__all__ = [
    'normal_logpdf',
    'diag_normal_logpdf',
    'student_t_logpdf',
    'diag_student_t_logpdf',
    'student_t_sample',
    'chi2_sample',
    't_lognorm',
]

_LOG_2PI = math.log(2.0 * math.pi)

# the exact construction costs one uniform per unit of df; the JAX package
# falls back to a rejection sampler above this df (and for non-integer df)
_MAX_EXACT_T_DF = 200


def _log(v):
    return torch.log(v) if isinstance(v, torch.Tensor) else math.log(v)


def _exact_df(df):
    """The integer df the rejection-free construction needs, or raise."""
    df_int = int(df)
    if df != df_int or not 1 <= df_int <= _MAX_EXACT_T_DF:
        raise NotImplementedError(
            'only integer df in [1, {}] is supported (got {}); the '
            'rejection-sampler fallback is not ported yet'.format(
                _MAX_EXACT_T_DF, df))
    return df_int


def _gamma_integer_shape(generator, k, shape, dtype):
    """Gamma(k, 1) draws for integer ``k`` as ``-sum log u``, with the
    uniforms grouped into products of at most 10 before each log (a
    product of 10 uniforms cannot underflow f32)
    (viabel_tpu/distributions.py:42-62)."""
    device = generator.device
    tiny = torch.finfo(dtype).tiny
    total = torch.zeros(shape, dtype=dtype, device=device)
    i = 0
    while i < k:
        group = min(10, k - i)
        prod = torch.ones(shape, dtype=dtype, device=device)
        for _ in range(group):
            u = torch.rand(shape, generator=generator, dtype=dtype,
                           device=device).clamp_min_(tiny)
            prod.mul_(u)
        total.sub_(torch.log(prod))
        i += group
    return total


def _chi2_exact(generator, df_int, shape, dtype):
    """chi2_df = 2 Gamma(df // 2, 1), plus z1^2 when df is odd."""
    chi2 = torch.zeros(shape, dtype=dtype, device=generator.device)
    if df_int // 2 > 0:
        chi2 = 2.0 * _gamma_integer_shape(generator, df_int // 2, shape,
                                          dtype)
    if df_int % 2 == 1:
        z1 = torch.randn(shape, generator=generator, dtype=dtype,
                         device=generator.device)
        chi2 = chi2 + z1 * z1
    return chi2


def chi2_sample(generator, df, shape, dtype=torch.float32):
    """Chi-square draws for integer ``df``, rejection-free
    (viabel_tpu/distributions.py:65-79)."""
    return _chi2_exact(generator, _exact_df(df), tuple(shape), dtype)


def student_t_sample(generator, df, shape, dtype=torch.float32):
    """Standard Student-t draws ``z * sqrt(df / chi2_df)`` for integer df
    (viabel_tpu/distributions.py:82-110).  Same distribution as the JAX
    package's sampler, different draws: the generators differ."""
    df_int = _exact_df(df)
    shape = tuple(shape)
    z = torch.randn(shape, generator=generator, dtype=dtype,
                    device=generator.device)
    chi2 = _chi2_exact(generator, df_int, shape, dtype)
    return z * torch.sqrt(df / chi2)


def t_lognorm(df):
    """log Gamma((df+1)/2) - log Gamma(df/2) - log(df pi) / 2, on the host."""
    return (math.lgamma(0.5 * (df + 1.0)) - math.lgamma(0.5 * df)
            - 0.5 * math.log(df * math.pi))


def normal_logpdf(x, loc=0.0, scale=1.0):
    """Elementwise univariate normal log density."""
    z = (x - loc) / scale
    return -0.5 * (z * z + _LOG_2PI) - _log(scale)


def diag_normal_logpdf(x, mean, log_std):
    """Diagonal-covariance Gaussian log density, summed over the last axis."""
    z = (x - mean) * torch.exp(-log_std)
    return (-0.5 * torch.sum(z * z + _LOG_2PI, dim=-1)
            - torch.sum(log_std, dim=-1))


def student_t_logpdf(x, df, loc=0.0, scale=1.0):
    """Elementwise univariate Student-t log density."""
    z = (x - loc) / scale
    return (t_lognorm(df) - 0.5 * (df + 1.0) * torch.log1p(z * z / df)
            - _log(scale))


def diag_student_t_logpdf(x, df, mean, log_scale):
    """Independent Student-t log densities summed over the last axis."""
    return torch.sum(student_t_logpdf(x, df, mean, torch.exp(log_scale)),
                     dim=-1)
