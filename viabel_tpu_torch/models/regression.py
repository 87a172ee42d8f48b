"""Bayesian regression targets.

PyTorch port of viabel_tpu/models/regression.py:29-132:

* `robust_regression_model`: ``beta ~ N(0, 10); y ~ student_t(df, x beta,
  1)``;
* `linear_regression_model`: ``beta ~ N(0, 10); y ~ N(x beta, 0.5)``, with
  the exact conjugate posterior as its true moments;
* `robust_regression_notebook_data` and `data_generator_linear`, which draw
  with numpy's legacy ``RandomState`` exactly as the JAX package does, so
  both packages see identical data.

A model whose data the fused bound-pass kernels take (``D <=
ops.limits.MAX_DIM`` and x and y, staged as rows padded to 16-byte
words (``ops.limits.regression_row``), fit their shared memory in float64)
carries ``kernel='regression'``: those kernels score it with the CUDA
regression density, which reads ``kernel_data = (x (N, D), y (N,), df,
noise_scale, prior_std)`` with ``df`` None for the Gaussian likelihood.
A larger model carries no kernel tag, and the bound pass scores it by the
plain composition ``log p(x) - log q(x)``.  `regression_log_density` is
the plain version that the models and the kernels' plain versions share.
"""
import numpy as np
import torch

from ..diagnostics import compute_posterior_moments
from ..distributions import normal_logpdf, student_t_logpdf
from ..ops import limits
from .base import Model, _DataCache

__all__ = [
    'robust_regression_model',
    'robust_regression_notebook_data',
    'linear_regression_model',
    'data_generator_linear',
    'regression_log_density',
]

# Long-NUTS ground truth for the notebook's seed-5039 data (the JAX
# package's constants, viabel_tpu/models/regression.py:36-37)
_ROBUST_TRUE_MEAN = np.array([-2.5245, 1.5185])
_ROBUST_TRUE_COV = np.array([[0.4328, -0.4301], [-0.4301, 0.4489]])


def regression_log_density(beta2, x, y, df, noise_scale, prior_std):
    """Log posterior density of the rows of ``beta2`` (n, D) with data
    tensors ``x`` (N, D) and ``y`` (N,) of beta2's device and dtype: a
    Student-t(df) likelihood (df None: Gaussian) of scale `noise_scale`
    around ``x beta`` and an N(0, prior_std) prior on each coefficient
    (viabel_tpu/models/regression.py:67-76, 100-107)."""
    mu = beta2 @ x.T                                       # (n, N)
    if df is None:
        loglik = normal_logpdf(y[None, :], mu, noise_scale)
    else:
        loglik = student_t_logpdf(y[None, :], df, mu, noise_scale)
    logprior = normal_logpdf(beta2, 0.0, prior_std)
    return torch.sum(loglik, dim=-1) + torch.sum(logprior, dim=-1)


def _regression_model(x, y, df, noise_scale, prior_std, name, true_mean,
                      true_cov):
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    N, D = x.shape
    data = _DataCache(x, y)
    df = None if df is None else float(df)
    noise_scale, prior_std = float(noise_scale), float(prior_std)

    def log_prob(beta):
        beta2 = torch.atleast_2d(beta)
        lp = regression_log_density(beta2, *data.like(beta2), df,
                                    noise_scale, prior_std)
        return lp[0] if beta.dim() == 1 else lp

    kernel = kernel_data = None
    if limits.fits(D, N * limits.regression_row(D, x.itemsize), x.itemsize):
        kernel = 'regression'
        kernel_data = data.host + (df, noise_scale, prior_std)
    return Model(log_prob, D, name, true_mean, true_cov,
                 tuple('beta[{}]'.format(i) for i in range(D)),
                 kernel, kernel_data, data if kernel else None)


def robust_regression_notebook_data():
    """The notebook's synthetic data: numpy legacy seed 5039, 25 rows,
    correlated design, t(40) noise, centred response
    (viabel_tpu/models/regression.py:40-50)."""
    rs = np.random.RandomState(5039)
    beta_gen = np.array([-2.0, 1.0])
    N = 25
    x = rs.randn(N, 2).dot(np.array([[1, .75], [.75, 1]]))
    y_raw = x.dot(beta_gen) + rs.standard_t(40, N)
    y = y_raw - np.mean(y_raw)
    return x, y


def robust_regression_model(x=None, y=None, df=40.0, prior_std=10.0,
                            noise_scale=1.0):
    """Student-t-likelihood regression posterior over the coefficients
    (viabel_tpu/models/regression.py:53-81).  With no data it uses the
    notebook's, whose NUTS moments are `true_mean` / `true_cov`."""
    use_notebook_truth = x is None and y is None
    if x is None:
        x, y = robust_regression_notebook_data()
    return _regression_model(
        x, y, df, noise_scale, prior_std, 'robust_regression',
        _ROBUST_TRUE_MEAN if use_notebook_truth else None,
        _ROBUST_TRUE_COV if use_notebook_truth else None)


def linear_regression_model(x, y, noise_scale=0.5, prior_std=10.0):
    """Gaussian-likelihood regression posterior over the coefficients
    (viabel_tpu/models/regression.py:84-110).  Conjugate: `true_mean` and
    `true_cov` are the exact posterior from `compute_posterior_moments`
    with prior covariance ``prior_std^2 I`` and noise variance
    ``noise_scale^2``."""
    x = np.asarray(x)
    D = x.shape[1]
    true_mean, true_cov = compute_posterior_moments(
        np.zeros(D), prior_std ** 2 * np.eye(D), noise_scale ** 2, x,
        np.asarray(y))
    return _regression_model(x, y, None, noise_scale, prior_std,
                             'linear_regression', true_mean, true_cov)


def data_generator_linear(N, D, alpha=1.0, noise_variance=0.25, rho=0.5,
                          seed=0):
    """Synthetic correlated-design linear-regression data
    (viabel_tpu/models/regression.py:113-132): rows of X from N(0, R) with
    ``R = (1 - rho) I + rho 11^T``, weights ``W ~ N(0, alpha^2 I)``, and
    ``Y = X W + N(0, noise_variance)``.  Returns a dict with keys ``X``,
    ``Y``, ``W``."""
    rs = np.random.RandomState(seed)
    R = (1 - rho) * np.eye(D) + rho * np.ones((D, D))
    L = np.linalg.cholesky(R)
    X = rs.randn(N, D) @ L.T
    W = alpha * rs.randn(D)
    Y = X @ W + np.sqrt(noise_variance) * rs.randn(N)
    return dict(X=X, Y=Y, W=W)
