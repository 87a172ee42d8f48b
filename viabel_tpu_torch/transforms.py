"""Constrained-parameter transforms (Stan-style unconstraining).

PyTorch port of viabel_tpu/transforms.py.  A constrained model is lifted
to the unconstrained scale the variational families live on:

    log p_unconstrained(z) = log p_constrained(T(z)) + log |dT/dz|

Example, a scale parameter and a correlation::

    t = ParameterTransforms([identity_transform(),       # mu
                             positive_transform(),       # sigma > 0
                             interval_transform(-1, 1)]) # rho in (-1, 1)
    log_density_unc = t.transformed_log_density(log_density_constrained)
    samples_constrained = t.constrain(unconstrained_samples)

Every function takes and returns tensors; the transforms are elementwise,
so they run on whatever device their input lives on.
"""
import math
from typing import Callable, NamedTuple, Sequence

import torch

__all__ = [
    'Transform',
    'identity_transform',
    'positive_transform',
    'lower_bounded_transform',
    'interval_transform',
    'ParameterTransforms',
]


class Transform(NamedTuple):
    """Bijection from an unconstrained scalar to a constrained one.

    `constrain(z)` maps R -> support; `unconstrain(x)` inverts it;
    `log_det_jacobian(z)` is ``log |d constrain / dz|`` (the term Stan adds
    to the target density).
    """
    constrain: Callable
    unconstrain: Callable
    log_det_jacobian: Callable
    name: str


def identity_transform():
    return Transform(lambda z: z, lambda x: x, torch.zeros_like, 'identity')


def positive_transform():
    """x = exp(z), for parameters declared ``<lower=0>`` (Stan's choice)."""
    return Transform(torch.exp, torch.log, lambda z: z, 'positive')


def lower_bounded_transform(lower):
    """x = lower + exp(z)."""
    return Transform(lambda z: lower + torch.exp(z),
                     lambda x: torch.log(x - lower),
                     lambda z: z, 'lower_bounded({})'.format(lower))


def _log1pexp(z):
    """``log(1 + exp(z))`` as ``logaddexp(0, z)``."""
    return torch.logaddexp(torch.zeros_like(z), z)


def interval_transform(lower, upper):
    """x = lower + (upper - lower) * sigmoid(z)
    (Stan's ``<lower=a, upper=b>`` logit transform)."""
    width = upper - lower

    def constrain(z):
        return lower + width / (1.0 + torch.exp(-z))

    def unconstrain(x):
        u = (x - lower) / width
        return torch.log(u) - torch.log1p(-u)

    def log_det_jacobian(z):
        # log(width) + log sigmoid(z) + log sigmoid(-z)
        return math.log(width) - _log1pexp(-z) - _log1pexp(z)

    return Transform(constrain, unconstrain, log_det_jacobian,
                     'interval({}, {})'.format(lower, upper))


class ParameterTransforms:
    """Per-coordinate transforms for a parameter vector.

    `transforms` is one `Transform` per dimension (use
    `identity_transform()` for unconstrained coordinates).  Each method
    takes one point (d,) or a batch (n, d) and works on the batch
    ``atleast_2d`` of it, as the JAX package does.
    """

    def __init__(self, transforms: Sequence[Transform]):
        self.transforms = list(transforms)
        self.dim = len(self.transforms)

    def constrain(self, z):
        z = torch.atleast_2d(z)
        return torch.stack([t.constrain(z[:, d])
                            for d, t in enumerate(self.transforms)], dim=-1)

    def unconstrain(self, x):
        x = torch.atleast_2d(x)
        return torch.stack([t.unconstrain(x[:, d])
                            for d, t in enumerate(self.transforms)], dim=-1)

    def log_det_jacobian(self, z):
        z = torch.atleast_2d(z)
        return sum(t.log_det_jacobian(z[:, d])
                   for d, t in enumerate(self.transforms))

    def transformed_log_density(self, log_density_constrained):
        """Lift a constrained-space log density to the unconstrained scale
        (the role Stan's ``log_prob`` plays for its models)."""

        def log_density_unconstrained(z):
            z2 = torch.atleast_2d(z)
            out = (log_density_constrained(self.constrain(z2))
                   + self.log_det_jacobian(z2))
            return out[0] if z.dim() == 1 else out

        return log_density_unconstrained
