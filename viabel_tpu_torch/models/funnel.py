"""Neal's 2-D funnel.

PyTorch port of viabel_tpu/models/funnel.py:13-24: ``log_sigma ~ N(0,
s); mu ~ N(0, exp(log_sigma))`` with ``s = log_sigma_stdev`` and the
analytic moments ``mean 0, cov diag(exp(2 s^2), s^2)``.  The model carries
``kernel='funnel'`` with ``kernel_data = (s,)``: the fused bound-pass
kernels score it with the CUDA funnel density, whose plain version is
`funnel_log_density`.
"""
import numpy as np
import torch

from ..distributions import normal_logpdf
from .base import Model

__all__ = ['funnel_model', 'funnel_log_density']


def funnel_log_density(x, log_sigma_stdev):
    """Funnel log density of the rows ``[mu, log_sigma]`` of ``x`` (n, 2)
    (or of one point (2,))."""
    mu, log_sigma = x[..., 0], x[..., 1]
    sigma_density = normal_logpdf(log_sigma, 0.0, log_sigma_stdev)
    mu_density = normal_logpdf(mu, 0.0, torch.exp(log_sigma))
    return sigma_density + mu_density


def funnel_model(log_sigma_stdev=1.35):
    """The funnel with its log_sigma prior's scale `log_sigma_stdev`."""
    s = float(log_sigma_stdev)

    def log_prob(x):
        return funnel_log_density(x, s)

    true_mean = np.zeros(2)
    true_cov = np.diag(np.array([np.exp(2 * s ** 2), s ** 2]))
    return Model(log_prob, 2, 'funnel', true_mean, true_cov,
                 ('mu', 'log_sigma'), 'funnel', (s,))
