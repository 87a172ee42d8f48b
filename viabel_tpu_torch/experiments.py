"""Bound-pass draws and log-weights (the ported part of
viabel_tpu/experiments.py).

`draw_and_score` is the one place that decides how a bound pass scores
its samples: a model whose `kernel` tag names a CUDA log density, under a
mean-field family, goes through the fused kernel K1 (`ops.lw_stats`) and
its combine; anything else is scored by the plain composition
``log p(x) - log q(x)`` and reduced by the log-weight kernels.
"""
import torch

from ._device import default_generator, resolve_device
from .ops import lw_stats as _lw_ops

__all__ = ['get_samples_and_log_weights', 'draw_and_score']

# families whose transform is mean + exp(log_scale) * z with a base density
# the fused kernel knows
_KERNEL_FAMILIES = ('mf_gaussian', 'mf_t')


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
    card); `generator` defaults to seed 0 there."""
    device = resolve_device(device)
    if generator is None:
        generator = default_generator(device)
    var_param = torch.as_tensor(var_param, device=device)
    z = var_family.base_sample(generator, n_samples, var_param.dtype)
    samples, lw, _ = draw_and_score(log_density, var_family, var_param, z)
    return samples, lw
