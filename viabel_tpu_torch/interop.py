"""Carry state from the JAX package into the port.

The JAX package (viabel_tpu) hands out numpy-convertible arrays; these
functions turn them into the port's tensors on a chosen device and dtype,
so both packages can run on the same inputs: the flat variational
parameter, the presampled optimizer draws
(one block, one per IA chain or one per run of a batch), and base draws
for a bound pass.  Draws come as one array, or as a dict of arrays for a
family whose base draws are a dict (the full-rank Student-t family's
``{'z': (..., d), 'chi2': (...)}``: ``chi2`` has one axis fewer).  Model
data (the regression models' x and y) passes as the numpy arrays it is.
Nothing here imports JAX: callers pass ``np.asarray(jax_array)`` or the
JAX array itself (anything ``np.asarray`` accepts).
"""
import numpy as np
import torch

__all__ = ['var_param', 'presampled_draws', 'chain_draws', 'base_draws',
           'run_draws']


def _to_tensor(array, ndim, what, device, dtype):
    a = np.asarray(array)
    if a.ndim != ndim or not np.issubdtype(a.dtype, np.floating):
        raise ValueError('{} must be a {}-D floating array, got shape {} '
                         'and dtype {}'.format(what, ndim, a.shape, a.dtype))
    t = torch.from_numpy(np.array(a, order='C'))  # a writable copy
    return t.to(device=device, dtype=dtype or t.dtype).contiguous()


def var_param(array, device='cpu', dtype=None):
    """A flat variational parameter (P,), e.g. ``[mean (d), log_scale (d)]``
    of a mean-field family."""
    return _to_tensor(array, 1, 'a variational parameter', device, dtype)


def _draws(array, ndim, what, device, dtype):
    """One block of draws with `ndim` axes, or a dict of blocks whose
    ``chi2`` entry has one axis fewer."""
    if isinstance(array, dict):
        return {k: _to_tensor(v, ndim - (k == 'chi2'),
                              '{} ({!r})'.format(what, k), device, dtype)
                for k, v in array.items()}
    return _to_tensor(array, ndim, what, device, dtype)


def presampled_draws(array, device='cpu', dtype=None):
    """A presampled objective's draws (n_iters, n_mc, d), as the JAX
    package's ``objective.make_draws(key, n_iters)`` returns them; row i
    feeds iteration i in both packages."""
    return _draws(array, 3, 'presampled draws', device, dtype)


def chain_draws(array, device='cpu', dtype=None):
    """The IA optimizers' per-chain presampled draws (n_chains, n_iters,
    n_mc, d): chain c's block is the JAX package's
    ``objective.make_draws_range(chain_key_c, 0, n_iters)``."""
    return _draws(array, 4, 'per-chain presampled draws', device, dtype)


def run_draws(array, device='cpu', dtype=None, presampled=True):
    """The draws of a batch of runs (`pipeline.validated_vi_multistart`,
    `pipeline.validated_vi_sweep`), a leading run axis K: with
    `presampled` the optimizer's (K, n_iters, n_mc, d), else the bound
    pass's base draws (K, n, d)."""
    return _draws(array, 4 if presampled else 3, 'per-run draws', device,
                  dtype)


def base_draws(array, device='cpu', dtype=None):
    """Base draws (n, d) of a family, as ``var_family.base_sample(key,
    n)`` returns them."""
    return _draws(array, 2, 'base draws', device, dtype)
