"""Experiment configuration: a declarative, validated `ExperimentConfig`
that names a model, family, objective and optimizer by string, its JSON
form, and the objects and the fit it builds.

PyTorch port of viabel_tpu/config.py.  The fields, their defaults, the
validation and the registries are the JAX package's, so a config written
by either package is the same JSON text and runs in the other.  In place
of a PRNG key, `fit` takes a `torch.Generator` and a device.
"""
import dataclasses
import json
from typing import Optional

import numpy as np
import torch

from ._device import resolve_device

__all__ = ['ExperimentConfig', 'MODELS', 'FAMILIES', 'OBJECTIVES',
           'OPTIMIZERS', 'build', 'fit']


def _linear_model(m, cfg):
    data = m.data_generator_linear(cfg.data_n, cfg.data_dim,
                                   rho=cfg.data_rho, seed=cfg.seed)
    return m.linear_regression_model(data['X'], data['Y'])


def _model_registry():
    from . import models as m
    return {
        'funnel': lambda cfg: m.funnel_model(),
        'normal_mixture': lambda cfg: m.normal_mixture_model(),
        'robust_regression': lambda cfg: m.robust_regression_model(),
        'eight_schools_cp': lambda cfg: m.eight_schools_cp_model(),
        'eight_schools_ncp': lambda cfg: m.eight_schools_ncp_model(),
        'linear_regression': lambda cfg: _linear_model(m, cfg),
    }


MODELS = ('funnel', 'normal_mixture', 'robust_regression',
          'eight_schools_cp', 'eight_schools_ncp', 'linear_regression')
FAMILIES = ('mean_field_gaussian', 'mean_field_t', 'full_rank_gaussian',
            'full_rank_t')
OBJECTIVES = ('klvi', 'klvi_pd', 'klvi_pd2', 'chivi', 'chivi_neff')
OPTIMIZERS = ('adagrad', 'rmsprop_ia', 'adam_ia')


@dataclasses.dataclass
class ExperimentConfig:
    """Declarative description of a VI experiment
    (viabel_tpu/config.py:48-95)."""
    model: str = 'funnel'
    family: str = 'mean_field_t'
    df: float = 40.0
    objective: str = 'klvi'
    alpha: float = 2.0
    n_mc: int = 100
    # draw every iteration's base draws before the optimizer runs (faster;
    # costs an (n_iters, n_mc, dim) block of draws)
    presampled: bool = True
    optimizer: str = 'adagrad'
    n_iters: int = 5000
    learning_rate: float = 0.01
    learning_rate_end: Optional[float] = None
    n_chains: int = 1
    seed: int = 0
    bound_samples: int = 1000000
    psis_samples: int = 1000000
    data_n: int = 100
    data_dim: int = 5
    data_rho: float = 0.5
    checkpoint_path: Optional[str] = None

    def __post_init__(self):
        if self.model not in MODELS:
            raise ValueError('unknown model {!r}; choose from {}'.format(
                self.model, MODELS))
        if self.family not in FAMILIES:
            raise ValueError('unknown family {!r}; choose from {}'.format(
                self.family, FAMILIES))
        if self.objective not in OBJECTIVES:
            raise ValueError('unknown objective {!r}; choose from {}'.format(
                self.objective, OBJECTIVES))
        if self.optimizer not in OPTIMIZERS:
            raise ValueError('unknown optimizer {!r}; choose from {}'.format(
                self.optimizer, OPTIMIZERS))

    def to_json(self):
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text):
        return cls(**json.loads(text))


def build(cfg):
    """Resolve a config into ``(model, family, objective_and_grad)``
    (viabel_tpu/config.py:98-126).  The objective scores the model's
    `log_prob`; the bound pass takes the model itself, whose `kernel` tag
    routes it to the fused kernels."""
    from . import families as fam_mod
    from . import objectives as obj_mod

    model = _model_registry()[cfg.model](cfg)

    if cfg.family == 'mean_field_gaussian':
        family = fam_mod.mean_field_gaussian_variational_family(model.dim)
    elif cfg.family == 'mean_field_t':
        family = fam_mod.mean_field_t_variational_family(model.dim, cfg.df)
    elif cfg.family == 'full_rank_gaussian':
        family = fam_mod.full_rank_gaussian_variational_family(model.dim)
    else:
        family = fam_mod.t_variational_family(model.dim, cfg.df)

    ps = cfg.presampled
    if cfg.objective == 'klvi':
        objective = obj_mod.black_box_klvi(family, model.log_prob, cfg.n_mc,
                                           presampled=ps)
    elif cfg.objective == 'klvi_pd':
        objective = obj_mod.black_box_klvi_pd(family, model.log_prob,
                                              cfg.n_mc, presampled=ps)
    elif cfg.objective == 'klvi_pd2':
        objective = obj_mod.black_box_klvi_pd2(family, model.log_prob,
                                               cfg.n_mc, presampled=ps)
    elif cfg.objective == 'chivi':
        objective = obj_mod.black_box_chivi(cfg.alpha, family,
                                            model.log_prob, cfg.n_mc,
                                            presampled=ps)
    else:
        objective = obj_mod.black_box_chivi_neff(cfg.alpha, family,
                                                 model.log_prob, cfg.n_mc,
                                                 presampled=ps)
    return model, family, objective


def fit(cfg, model, family, objective, *, generator=None, progress=False,
        device=None):
    """Run the optimizer a config prescribes (viabel_tpu/config.py:129-195):
    windowed adagrad (resumable when `cfg.checkpoint_path` is set, with
    progress lines when `progress`), or an IA optimizer with
    `cfg.checkpoint_path` passed through.

    `generator` defaults to the first of three generators split
    (`experiments._split`) from one seeded with `cfg.seed` on `device`
    (None: the CUDA card), the generator every entry point derives.
    Returns ``(var_param, value_history, ia_log)``: for IA the first
    chain's final iterate averages (mean block, then sigma block) as a
    tensor on `device`, the values as numpy, and the optimizers'
    ``optimisation_log``; for adagrad the smoothed parameter, the values as
    tensors and None.
    """
    device = resolve_device(device)
    if generator is None:
        from .experiments import _split
        generator = _split(torch.Generator(device=device).manual_seed(
            cfg.seed), 3)[0]
    init = family.init_param(device=device)
    if cfg.optimizer == 'adagrad':
        if cfg.checkpoint_path:
            from .checkpoint import adagrad_optimize_resumable
            var_param, _, values, _ = adagrad_optimize_resumable(
                cfg.n_iters, objective, init,
                checkpoint_path=cfg.checkpoint_path, generator=generator,
                learning_rate=cfg.learning_rate,
                learning_rate_end=cfg.learning_rate_end, device=device)
        else:
            from .optimizers import adagrad_optimize
            var_param, _, values, _ = adagrad_optimize(
                cfg.n_iters, objective, init, generator=generator,
                learning_rate=cfg.learning_rate,
                learning_rate_end=cfg.learning_rate_end,
                progress=progress, device=device)
        return var_param, values, None
    from .optimizers import (adam_IA_optimize_with_rhat,
                             rmsprop_IA_optimize_with_rhat)
    optimizer = (rmsprop_IA_optimize_with_rhat
                 if cfg.optimizer == 'rmsprop_ia'
                 else adam_IA_optimize_with_rhat)
    out = optimizer(cfg.n_iters, objective, init, model.dim,
                    generator=generator, learning_rate=cfg.learning_rate,
                    learning_rate_end=cfg.learning_rate_end,
                    n_optimisers=cfg.n_chains,
                    checkpoint_path=cfg.checkpoint_path, device=device)
    avg_means, avg_sigmas = out[2], out[3]
    var_param = torch.as_tensor(np.concatenate([avg_means[0][-1],
                                                avg_sigmas[0][-1]]),
                                device=device)
    return var_param, out[4], out[6]
