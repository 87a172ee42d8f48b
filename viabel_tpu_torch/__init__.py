"""viabel-tpu-torch: validated variational inference on PyTorch and CUDA.

The PyTorch port of the JAX package `viabel_tpu`, for an NVIDIA H100.  It
keeps the JAX package's module names, so each function has a counterpart
of the same name there, and it imports neither JAX nor `viabel_tpu`.

It carries six slices: the eight-schools validated-VI pipeline (the
mean-field families, presampled KLVI, windowed adagrad, the bounds, PSIS,
the fused pipeline `validated_vi`); R-hat-gated iterate averaging on
Bayesian regression (`diagnostics`, the RMSProp/Adam IA optimizers, the
regression models, `improve_with_psis`); the KLVI-against-CHIVI
harness `run_experiment` (`black_box_chivi`, `init_from_moments`, the
non-centred eight-schools and funnel models); and the batched pipelines
`validated_vi_multistart` and `validated_vi_sweep`, the full-rank families
with the Cholesky densities, and the rest of the objectives; and the
command line ``python -m viabel_tpu_torch run`` / ``configs``
(`__main__`, `config`) with checkpoint and resume (`checkpoint`), the
segmented IA chain runs with progress and objectives that sample inside
the step, the constrained-parameter transforms (`transforms`) and the
normal-mixture model; and the HTTP posterior service
(``python -m viabel_tpu_torch.serve``, `serve`), the in-repo HMC ground
truth (`mcmc`: `hmc_sample`, `hmc_ground_truth`) and host-side log
densities (`models.make_callback_log_density`, the C++ densities of
`native`).  The bound
pass runs on hand-written CUDA kernels: K1, K3 and the combine in
``csrc/lw_stats.cu`` (`ops.lw_stats`), and K2, which draws a Gaussian q's
samples in-kernel from a Philox stream, with ``philox_normal`` in
``csrc/gaussian_lw.cu`` (`ops.gaussian_lw`).  K1 and K2 score every model density the TPU
kernels had: eight-schools CP and NCP, the funnel and regression.  The
windowed adagrad's step is one hand-written kernel for a run or a batch of
runs (``csrc/adagrad.cu``, `ops.adagrad`).

Entry points run on the CUDA card unless the caller passes
``device='cpu'``; without a card and without that argument they raise.
Products never run in TF32 (`_device.fp32_matmul_policy`).
"""
from ._device import fp32_matmul_policy, resolve_device
from .bounds import (all_bounds, divergence_bound, error_bounds,
                     family_moment_bounds, log_weight_stats,
                     wasserstein_bounds)
from .diagnostics import (compute_posterior_moments, compute_R_hat,
                          compute_R_hat_adaptive, compute_R_hat_halfway,
                          effective_sample_size,
                          stochastic_iterate_averaging)
from .experiments import (check_accuracy, check_approx_accuracy,
                          get_samples_and_log_weights, improve_with_psis,
                          print_bounds, psis_correction, run_experiment)
from .distributions import multivariate_t_logpdf
from .mcmc import hmc_ground_truth, hmc_sample
from .families import (NoClosedFormMomentError, VariationalFamily,
                       full_rank_gaussian_variational_family,
                       init_from_moments,
                       mean_field_gaussian_variational_family,
                       mean_field_t_variational_family, t_variational_family)
from .objectives import (black_box_chivi, black_box_chivi_neff,
                         black_box_klvi, black_box_klvi_pd,
                         black_box_klvi_pd2, perturbed_black_box_vi,
                         vectorize_log_density)
from .optimizers import (adagrad_optimize, adam_IA_optimize,
                         adam_IA_optimize_with_rhat, learning_rate_schedule,
                         rmsprop_IA_optimize, rmsprop_IA_optimize_with_rhat)
from .pipeline import (DivergedRunWarning, validated_vi,
                       validated_vi_multistart, validated_vi_sweep)
from .psis import psislw, weighted_moments
from .transforms import (ParameterTransforms, identity_transform,
                         interval_transform, lower_bounded_transform,
                         positive_transform)

__version__ = '0.1.0'

__all__ = [
    'all_bounds', 'error_bounds', 'wasserstein_bounds', 'divergence_bound',
    'log_weight_stats', 'family_moment_bounds',
    'VariationalFamily', 'NoClosedFormMomentError',
    'mean_field_gaussian_variational_family',
    'mean_field_t_variational_family',
    'full_rank_gaussian_variational_family', 't_variational_family',
    'init_from_moments', 'multivariate_t_logpdf',
    'black_box_klvi', 'black_box_klvi_pd', 'black_box_klvi_pd2',
    'black_box_chivi', 'black_box_chivi_neff', 'perturbed_black_box_vi',
    'vectorize_log_density',
    'learning_rate_schedule', 'adagrad_optimize',
    'rmsprop_IA_optimize_with_rhat', 'adam_IA_optimize_with_rhat',
    'rmsprop_IA_optimize', 'adam_IA_optimize',
    'compute_R_hat', 'compute_R_hat_adaptive', 'compute_R_hat_halfway',
    'effective_sample_size', 'stochastic_iterate_averaging',
    'compute_posterior_moments',
    'get_samples_and_log_weights', 'psis_correction', 'improve_with_psis',
    'check_accuracy', 'check_approx_accuracy', 'print_bounds',
    'run_experiment',
    # in-repo MCMC ground truth
    'hmc_sample', 'hmc_ground_truth',
    'psislw', 'weighted_moments',
    'validated_vi', 'validated_vi_multistart', 'validated_vi_sweep',
    'DivergedRunWarning',
    'resolve_device', 'fp32_matmul_policy',
    # constrained-parameter transforms (the Stan unconstraining layer)
    'ParameterTransforms', 'identity_transform', 'positive_transform',
    'lower_bounded_transform', 'interval_transform',
]
