"""viabel-tpu-torch: validated variational inference on PyTorch and CUDA.

The PyTorch port of the JAX package `viabel_tpu`, for an NVIDIA H100.  It
keeps the JAX package's module names, so each function has a counterpart
of the same name there, and it imports neither JAX nor `viabel_tpu`.

This slice carries the eight-schools validated-VI pipeline: the mean-field
families, presampled KLVI, windowed adagrad, the bounds, PSIS, and the
fused pipeline `validated_vi`.  The bound pass runs on hand-written CUDA
kernels (``csrc/lw_stats.cu``, wrapped in `ops.lw_stats`).

Entry points run on the CUDA card unless the caller passes
``device='cpu'``; without a card and without that argument they raise.
Products never run in TF32 (`_device.fp32_matmul_policy`).
"""
from ._device import fp32_matmul_policy, resolve_device
from .bounds import (all_bounds, divergence_bound, error_bounds,
                     family_moment_bounds, log_weight_stats,
                     wasserstein_bounds)
from .experiments import get_samples_and_log_weights
from .families import (NoClosedFormMomentError, VariationalFamily,
                       mean_field_gaussian_variational_family,
                       mean_field_t_variational_family)
from .objectives import black_box_klvi
from .optimizers import adagrad_optimize, learning_rate_schedule
from .pipeline import DivergedRunWarning, validated_vi
from .psis import psislw, weighted_moments

__version__ = '0.1.0'

__all__ = [
    'all_bounds', 'error_bounds', 'wasserstein_bounds', 'divergence_bound',
    'log_weight_stats', 'family_moment_bounds',
    'VariationalFamily', 'NoClosedFormMomentError',
    'mean_field_gaussian_variational_family',
    'mean_field_t_variational_family',
    'black_box_klvi',
    'learning_rate_schedule', 'adagrad_optimize',
    'get_samples_and_log_weights',
    'psislw', 'weighted_moments',
    'validated_vi', 'DivergedRunWarning',
    'resolve_device', 'fp32_matmul_policy',
]
