"""Model container: a batched log density plus metadata
(viabel_tpu/models/base.py)."""
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np

__all__ = ['Model']


class Model(NamedTuple):
    """A target distribution for variational inference.

    `log_prob` maps a batch of unconstrained parameter vectors ``(n, dim)``
    (or one ``(dim,)`` vector) to log densities ``(n,)`` (or a scalar).
    `true_mean` / `true_cov` carry ground-truth posterior moments when
    known.

    `kernel` names the hand-written CUDA log density that scores this model
    inside the fused bound-pass kernel (`ops.lw_stats`), and `kernel_data`
    holds the float64 host tensors that kernel reads; both are ``None`` for
    a model without one.  The bound pass dispatches on `kernel`.
    """
    log_prob: Callable
    dim: int
    name: str
    true_mean: Optional[np.ndarray] = None
    true_cov: Optional[np.ndarray] = None
    param_names: Tuple[str, ...] = ()
    kernel: Optional[str] = None
    kernel_data: Optional[tuple] = None

    def __call__(self, x):
        return self.log_prob(x)
