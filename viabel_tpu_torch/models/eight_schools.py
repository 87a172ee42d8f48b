"""Eight-schools hierarchical models, centred and non-centred.

PyTorch port of viabel_tpu/models/eight_schools.py:35-127.  Stan's
``tau = exp(log_tau)`` reparameterization with its log-Jacobian
``+log_tau`` is kept, so log densities differ from Stan's only by
parameter-free constants.

Unconstrained parameter layout:

* CP:  ``[mu, log_tau, theta_1..theta_J]``
* NCP: ``[mu, log_tau, theta_tilde_1..theta_tilde_J]``
"""
import math
import os

import numpy as np
import torch

from ..distributions import normal_logpdf
from .base import Model, _DataCache

__all__ = [
    'EIGHT_SCHOOLS_Y',
    'EIGHT_SCHOOLS_SIGMA',
    'eight_schools_cp_model',
    'eight_schools_ncp_model',
    'eight_schools_ncp_to_cp',
    'cp_log_density',
    'ncp_log_density',
]

EIGHT_SCHOOLS_Y = np.array([28., 8., -3., 7., -1., 1., 18., 12.])
EIGHT_SCHOOLS_SIGMA = np.array([15., 10., 16., 11., 9., 11., 10., 18.])

# the CUDA log densities in csrc/bound_pass.cuh unroll J = 8 schools
_KERNEL_J = 8


def _load_ground_truth(prefix):
    """Posterior mean and covariance from the JAX package's HMC ground
    truth (8 chains x 50k draws on the NCP; a copy of
    viabel_tpu/models/_ground_truth.npz)."""
    path = os.path.join(os.path.dirname(__file__), '_ground_truth.npz')
    with np.load(path) as data:
        return data[prefix + '_mean'], data[prefix + '_cov']


def _half_cauchy_logpdf_with_jacobian(log_tau, scale):
    """``tau ~ cauchy(0, scale)`` on ``tau = exp(log_tau) > 0``, plus the
    log-Jacobian ``log_tau``."""
    tau = torch.exp(log_tau)
    cauchy = -torch.log(math.pi * scale * (1.0 + (tau / scale) ** 2))
    return cauchy + log_tau


def _data(y, sigma):
    y = EIGHT_SCHOOLS_Y if y is None else np.asarray(y, dtype=np.float64)
    sigma = (EIGHT_SCHOOLS_SIGMA if sigma is None
             else np.asarray(sigma, dtype=np.float64))
    default = (np.array_equal(y, EIGHT_SCHOOLS_Y)
               and np.array_equal(sigma, EIGHT_SCHOOLS_SIGMA))
    return y, sigma, default


def cp_log_density(z2, y, sigma):
    """Centred eight-schools log density of the rows of ``z2`` (n, 2 + J)
    with data tensors ``y``, ``sigma`` (J,) of z2's device and dtype.  The
    plain version of the CUDA bound-pass kernel scores with this too."""
    mu, log_tau, theta = z2[:, 0], z2[:, 1], z2[:, 2:]
    tau = torch.exp(log_tau)
    lp = normal_logpdf(mu, 0.0, 5.0)
    lp = lp + _half_cauchy_logpdf_with_jacobian(log_tau, 5.0)
    lp = lp + torch.sum(normal_logpdf(theta, mu[:, None], tau[:, None]),
                        dim=-1)
    return lp + torch.sum(normal_logpdf(y[None, :], theta, sigma[None, :]),
                          dim=-1)


def ncp_log_density(z2, y, sigma):
    """Non-centred eight-schools log density of the rows of ``z2``
    (n, 2 + J), as `cp_log_density`; the plain version of the CUDA
    bound-pass kernels scores with this too."""
    mu, log_tau, theta_tilde = z2[:, 0], z2[:, 1], z2[:, 2:]
    tau = torch.exp(log_tau)
    theta = mu[:, None] + tau[:, None] * theta_tilde
    lp = normal_logpdf(mu, 0.0, 5.0)
    lp = lp + _half_cauchy_logpdf_with_jacobian(log_tau, 5.0)
    lp = lp + torch.sum(normal_logpdf(theta_tilde, 0.0, 1.0), dim=-1)
    return lp + torch.sum(normal_logpdf(y[None, :], theta, sigma[None, :]),
                          dim=-1)


def eight_schools_cp_model(y=None, sigma=None):
    """Centred parameterization: ``mu ~ N(0,5); tau ~ cauchy(0,5) [tau>0];
    theta ~ N(mu, tau); y ~ N(theta, sigma)``
    (viabel_tpu/models/eight_schools.py:61-87)."""
    y, sigma, default = _data(y, sigma)
    J = len(y)
    data = _DataCache(y, sigma)

    def log_prob(z):
        z2 = torch.atleast_2d(z)
        lp = cp_log_density(z2, *data.like(z2))
        return lp[0] if z.dim() == 1 else lp

    names = ('mu', 'log_tau') + tuple(
        'theta[{}]'.format(j + 1) for j in range(J))
    true_mean = true_cov = None
    if default:
        true_mean, true_cov = _load_ground_truth('eight_schools_cp')
    kernel = 'eight_schools_cp' if J == _KERNEL_J else None
    return Model(log_prob, 2 + J, 'eight_schools_cp', true_mean, true_cov,
                 names, kernel, data.host if kernel else None)


def eight_schools_ncp_model(y=None, sigma=None):
    """Non-centred parameterization: ``theta_tilde ~ N(0,1)`` with
    ``theta = mu + tau * theta_tilde``
    (viabel_tpu/models/eight_schools.py:90-117).  With J = 8 schools it
    carries ``kernel='eight_schools_ncp'``, as the CP model does."""
    y, sigma, default = _data(y, sigma)
    J = len(y)
    data = _DataCache(y, sigma)

    def log_prob(z):
        z2 = torch.atleast_2d(z)
        lp = ncp_log_density(z2, *data.like(z2))
        return lp[0] if z.dim() == 1 else lp

    names = ('mu', 'log_tau') + tuple(
        'theta_tilde[{}]'.format(j + 1) for j in range(J))
    true_mean = true_cov = None
    if default:
        true_mean, true_cov = _load_ground_truth('eight_schools_ncp')
    kernel = 'eight_schools_ncp' if J == _KERNEL_J else None
    return Model(log_prob, 2 + J, 'eight_schools_ncp', true_mean, true_cov,
                 names, kernel, data.host if kernel else None)


def eight_schools_ncp_to_cp(z):
    """Map NCP draws ``[mu, log_tau, theta_tilde]`` to the CP scale
    ``[mu, log_tau, theta]`` (viabel_tpu/models/eight_schools.py:120-127).
    Accepts and returns the input's kind: a tensor or a numpy array."""
    if isinstance(z, torch.Tensor):
        z = torch.atleast_2d(z)
        mu, log_tau, theta_tilde = z[:, :1], z[:, 1:2], z[:, 2:]
        return torch.cat([mu, log_tau, mu + torch.exp(log_tau) * theta_tilde],
                         dim=1)
    z = np.atleast_2d(np.asarray(z))
    mu, log_tau, theta_tilde = z[:, :1], z[:, 1:2], z[:, 2:]
    theta = mu + np.exp(log_tau) * theta_tilde
    return np.concatenate([mu, log_tau, theta], axis=1)
