"""1-D two-component Gaussian mixture ``p = 0.5 N(-2, 1) + 0.5 N(2, 1)``.

PyTorch port of viabel_tpu/models/mixture.py.  The model has no CUDA log
density (no `kernel` tag): a bound pass scores it by the plain composition
``log p - log q`` and reduces the log-weights with the statistics kernels.
"""
import math

import numpy as np
import torch

from ..distributions import normal_logpdf
from .base import Model

__all__ = ['normal_mixture_model']


def normal_mixture_model(locs=(-2.0, 2.0), scale=1.0):
    """1-D mixture density.

    `log_prob` is ELEMENTWISE over a 1-D input: ``(n,)`` is a batch of n
    scalar points returning ``(n,)``; a ``(n, 1)`` family-shaped batch also
    returns ``(n,)`` (viabel_tpu/models/mixture.py:14-24).
    """
    locs = np.asarray(locs, dtype=float)
    loc0, loc1, scale = float(locs[0]), float(locs[1]), float(scale)

    def log_prob(x):
        x1 = x[..., 0] if x.dim() > 1 else x
        return (torch.logaddexp(normal_logpdf(x1, loc0, scale),
                                normal_logpdf(x1, loc1, scale))
                - math.log(2.0))

    # moments of the symmetric mixture: mean 0, var = scale^2 + loc^2
    true_mean = np.array([locs.mean()])
    true_var = scale ** 2 + np.mean((locs - locs.mean()) ** 2)
    return Model(log_prob, 1, 'normal_mixture', true_mean,
                 np.array([[true_var]]), ('x',))
