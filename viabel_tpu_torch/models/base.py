"""Model container: a batched log density plus metadata
(viabel_tpu/models/base.py)."""
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

__all__ = ['Model']


class Model(NamedTuple):
    """A target distribution for variational inference.

    `log_prob` maps a batch of unconstrained parameter vectors ``(n, dim)``
    (or one ``(dim,)`` vector) to log densities ``(n,)`` (or a scalar).
    `true_mean` / `true_cov` carry ground-truth posterior moments when
    known.

    `kernel` names the hand-written CUDA log density that scores this model
    inside the fused bound-pass kernels (`ops.lw_stats`,
    `ops.gaussian_lw`), and `kernel_data` holds what that density reads:
    float64 host tensors, then any scalar constants (the regression
    models' ``(x, y, df, noise_scale, prior_std)``); both are ``None`` for
    a model without one.  The bound pass dispatches on `kernel`, and
    takes the data from `kernel_data_like`, which keeps one copy of the
    tensors per device and dtype (`kernel_cache`, shared with `log_prob`).
    """
    log_prob: Callable
    dim: int
    name: str
    true_mean: Optional[np.ndarray] = None
    true_cov: Optional[np.ndarray] = None
    param_names: Tuple[str, ...] = ()
    kernel: Optional[str] = None
    kernel_data: Optional[tuple] = None
    kernel_cache: Optional['_DataCache'] = None

    def __call__(self, x):
        return self.log_prob(x)

    def kernel_data_like(self, x):
        """`kernel_data` with its tensors on `x`'s device in `x`'s dtype,
        converted once for each device and dtype."""
        if self.kernel_cache is None:
            return self.kernel_data
        tensors = self.kernel_cache.like(x)
        return tensors + self.kernel_data[len(tensors):]


class _DataCache:
    """The data as tensors of the evaluating tensor's device and dtype,
    converted once per (device, dtype) rather than on every call.  The data
    is copied when the cache is made: a later change to the caller's arrays
    changes neither the host tensors nor their copies."""

    def __init__(self, *arrays):
        self._host = [torch.tensor(np.array(a, dtype=np.float64))
                      for a in arrays]
        self._cache = {}

    def like(self, x):
        key = (x.device, x.dtype)
        out = self._cache.get(key)
        if out is None:
            out = self._cache[key] = tuple(t.to(x.device, x.dtype)
                                           for t in self._host)
        return out

    @property
    def host(self):
        return tuple(self._host)
