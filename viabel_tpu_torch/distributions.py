"""Log densities and rejection-free samplers for the variational families.

PyTorch port of viabel_tpu/distributions.py.  Densities are plain
tensor functions, shape polymorphic over a leading sample batch and
differentiable by autograd and `torch.func`.  Samplers take an explicit
`torch.Generator` and draw on its device.

The Cholesky densities of the full-rank families invert the (d, d) factor
once and take one product over the samples (`_chol_mahalanobis_and_logdet`);
`multivariate_t_logpdf` takes a dense scale matrix through an eigh
pseudo-inverse.
"""
import math

import torch

from .ops import t_sample

__all__ = [
    'normal_logpdf',
    'diag_normal_logpdf',
    'student_t_logpdf',
    'diag_student_t_logpdf',
    'mvn_logpdf_chol',
    'mvt_logpdf_chol',
    'multivariate_t_logpdf',
    'student_t_sample',
    'chi2_sample',
    't_lognorm',
]

_LOG_2PI = math.log(2.0 * math.pi)

# the exact construction costs one uniform per unit of df; above this df
# (and for a non-integer df) the samplers take the gamma sampler instead
_MAX_EXACT_T_DF = 200


def _log(v):
    return torch.log(v) if isinstance(v, torch.Tensor) else math.log(v)


def _exact_df(df):
    """The integer df of the rejection-free construction, or None where
    the gamma sampler takes the draw (viabel_tpu/distributions.py:70-72);
    raises for a df that is not positive."""
    if not df > 0:
        raise ValueError('df must be positive (got {})'.format(df))
    df_int = int(df)
    if df != df_int or not 1 <= df_int <= _MAX_EXACT_T_DF:
        return None
    return df_int


def _chi2_gamma(generator, df, shape, dtype):
    """chi2_df = 2 Gamma(df / 2, 1) from torch's gamma sampler (a
    rejection sampler) driven by `generator`, for any df > 0: the
    counterpart of the JAX package's ``jax.random.chisquare`` fallback.
    The draw is made in float64 and cast, so a float32 draw of a large df
    keeps its spread."""
    alpha = torch.full(shape, 0.5 * float(df), dtype=torch.float64,
                       device=generator.device)
    return (2.0 * torch._standard_gamma(alpha, generator=generator)).to(dtype)


def _chi2_exact(generator, df_int, shape, dtype, z=None):
    """chi2_df = 2 Gamma(df // 2, 1), plus z1^2 when df is odd, with
    Gamma(k, 1) = -sum log u over k uniforms, grouped into products of at
    most `t_sample.GROUP` = 10 before each log (a product of 10 uniforms
    cannot underflow f32) (viabel_tpu/distributions.py:42-62); given the
    normals `z`, the t draws ``z * sqrt(df / chi2)`` instead.

    The generator calls are the same on every device and in this order:
    the uniforms of each group in turn, then z1 (odd df).  The arithmetic
    after each group's uniforms is one `t_sample.t_from_uniforms` launch
    for a CUDA float32 or float64 draw (`t_sample.takes`), its plain
    version elsewhere; the two agree bit for bit.  A group's uniforms are
    dropped after its step, so at most `GROUP` of them, z, z1 and the total
    are alive at once: 13 buffers of the draw's shape at most."""
    device = generator.device
    step = (t_sample.t_from_uniforms if t_sample.takes(device, dtype)
            else t_sample.t_from_uniforms_plain)
    k = df_int // 2
    starts = list(range(0, k, t_sample.GROUP)) or [0]
    total = torch.empty(shape, dtype=dtype, device=device)
    for start in starts:
        last = start == starts[-1]
        uniforms = [torch.rand(shape, generator=generator, dtype=dtype,
                               device=device)
                    for _ in range(min(t_sample.GROUP, k - start))]
        z1 = (torch.randn(shape, generator=generator, dtype=dtype,
                          device=device)
              if last and df_int % 2 == 1 else None)
        total = step(uniforms, total, start == 0, last, z=z, z1=z1,
                     df=df_int)
        del uniforms, z1  # before the next group's draws reuse the memory
    return total


def chi2_sample(generator, df, shape, dtype=torch.float32):
    """Chi-square draws: rejection-free for integer ``df`` up to 200, from
    the gamma sampler otherwise (viabel_tpu/distributions.py:65-79)."""
    shape, df_int = tuple(shape), _exact_df(df)
    if df_int is None:
        return _chi2_gamma(generator, df, shape, dtype)
    return _chi2_exact(generator, df_int, shape, dtype)


def student_t_sample(generator, df, shape, dtype=torch.float32):
    """Standard Student-t draws ``z * sqrt(df / chi2_df)``
    (viabel_tpu/distributions.py:82-110), the chi-square rejection-free
    for integer df up to 200 and from the gamma sampler otherwise.  Same
    distribution as the JAX package's sampler, different draws: the
    generators differ."""
    shape, df_int = tuple(shape), _exact_df(df)
    z = torch.randn(shape, generator=generator, dtype=dtype,
                    device=generator.device)
    if df_int is None:
        return z * torch.sqrt(df / _chi2_gamma(generator, df, shape, dtype))
    return _chi2_exact(generator, df_int, shape, dtype, z=z)


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


def _chol_mahalanobis_and_logdet(x, mean, chol):
    """``(||L^{-1}(x - mean)||^2, log det Sigma)`` for ``Sigma = L L^T``
    (viabel_tpu/distributions.py:144-163).  As in the JAX package, the
    (d, d) factor is inverted once (a triangular solve against the
    identity) and the samples go through one product with the inverse, not
    a triangular solve over the sample axis: the product runs at the full
    float32 precision the package pins (`_device.fp32_matmul_policy`), and
    the inverse assumes the well-conditioned factors a variational fit
    produces."""
    dev = x - mean
    eye = torch.eye(chol.shape[-1], dtype=chol.dtype, device=chol.device)
    inv_chol = torch.linalg.solve_triangular(chol, eye, upper=False)
    z = inv_chol @ dev.transpose(-1, -2)
    maha = torch.sum(z * z, dim=-2)
    log_det = 2.0 * torch.sum(torch.log(torch.diagonal(chol, dim1=-2,
                                                       dim2=-1)), dim=-1)
    return maha, log_det


def mvn_logpdf_chol(x, mean, chol):
    """Multivariate normal log density with covariance ``chol chol^T``."""
    d = mean.shape[-1]
    maha, log_det = _chol_mahalanobis_and_logdet(x, mean, chol)
    return -0.5 * (maha + log_det + d * _LOG_2PI)


def _mvt_lognorm(df, d):
    return (math.lgamma(0.5 * (df + d)) - math.lgamma(0.5 * df)
            - 0.5 * d * math.log(math.pi * df))


def mvt_logpdf_chol(x, mean, chol, df):
    """Multivariate Student-t log density with scale ``chol chol^T``
    (viabel_tpu/distributions.py:173-184)."""
    d = mean.shape[-1]
    maha, log_det = _chol_mahalanobis_and_logdet(x, mean, chol)
    return (_mvt_lognorm(df, d) - 0.5 * log_det
            - 0.5 * (df + d) * torch.log1p(maha / df))


def multivariate_t_logpdf(x, m, S, df=math.inf):
    """Multivariate-t log density with a dense positive semi-definite scale
    `S` (viabel_tpu/distributions.py:187-208): an eigh pseudo-inverse, so
    a rank-deficient `S` is taken (eigenvalues within 1e-10 of zero are
    dropped from the inverse and the log-determinant), and the normal
    density for ``df`` infinite or None."""
    x = torch.atleast_2d(x)
    d = m.shape[-1]
    s, u = torch.linalg.eigh(S)
    small = torch.abs(s) <= 1e-10
    s_pinv = torch.where(small, 0.0, 1.0 / s)
    U = u * torch.sqrt(s_pinv)
    log_pdet = torch.sum(torch.log(torch.where(small, 1.0, s)))
    maha = torch.sum(((x - m) @ U) ** 2, dim=-1)
    if df is None or df == math.inf:
        return -0.5 * (maha + log_pdet + d * _LOG_2PI)
    return (_mvt_lognorm(df, d) - 0.5 * log_pdet
            - 0.5 * (df + d) * torch.log1p(maha / df))
