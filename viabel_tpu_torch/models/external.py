"""Bridge for external (host-side) log-density providers.

PyTorch port of viabel_tpu/models/external.py: host functions (a compiled
Stan model, a C++ library, a numpy density) wrapped into a differentiable
log density with the `Model.log_prob` contract.  The JAX package wraps
them with ``jax.pure_callback`` under ``jax.custom_vjp``; here they sit
behind a `torch.autograd.Function` whose forward and backward take the
batch to the host once per call and put the result back on the input's
device in its dtype.

The function works under `torch.func` (``grad_and_value``, ``vjp``,
``vmap``), which the batched optimizers use: it has the
``setup_context`` form, and its ``vmap`` rule folds the vmapped axis into
the host batch (the counterpart of JAX's ``vmap_method='sequential'``,
one host call for the whole batch instead of one per element).  A host
round trip cannot be captured in a CUDA graph: the returned density
carries ``host_callback = True``, the objectives pass it on, and the
optimizers and HMC then run their bodies eagerly (`_device.pick_driver`).
"""
import numpy as np
import torch

__all__ = ['make_callback_log_density', 'is_host_callback']


class _Host:
    """The host functions of one density, each called on a ``(n, dim)``
    float array and returning ``(n,)`` values or ``(n, dim)`` gradients in
    the input's dtype (viabel_tpu/models/external.py:43-55)."""

    def __init__(self, log_prob_fn, grad_log_prob_fn, dim, batched):
        self.log_prob_fn = log_prob_fn
        self.grad_log_prob_fn = grad_log_prob_fn
        self.dim = dim
        self.batched = batched

    def _call(self, x, batched_fn, row_fn, shape):
        """`x` (..., dim) to the host as one (n, dim) batch, the host
        function on it, and the result back on x's device in x's dtype,
        shaped ``shape``."""
        rows = x.detach().reshape(-1, self.dim).cpu().numpy()
        out = batched_fn(rows) if self.batched else row_fn(rows)
        return torch.as_tensor(np.asarray(out, dtype=rows.dtype)).reshape(
            shape).to(x.device)

    def value(self, x):
        return self._call(
            x, self.log_prob_fn,
            lambda rows: [self.log_prob_fn(row) for row in rows],
            x.shape[:-1])

    def grad(self, x):
        return self._call(
            x, self.grad_log_prob_fn,
            lambda rows: np.stack([np.asarray(self.grad_log_prob_fn(row))
                                   for row in rows]),
            x.shape)


def _vmap_rule(fn):
    """A ``vmap`` staticmethod for a host function of `x` alone: the
    vmapped axis moves to the front and joins the host batch."""

    def vmap(info, in_dims, x, host):
        if in_dims[0] is None:
            return fn.apply(x, host), None
        return fn.apply(x.movedim(in_dims[0], 0), host), 0

    return staticmethod(vmap)


class _HostGradient(torch.autograd.Function):
    """The host gradient ``(..., dim) -> (..., dim)``: the backward of
    `_HostDensity`, itself a function so that it runs under ``vmap``."""

    @staticmethod
    def forward(x, host):
        return host.grad(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass


_HostGradient.vmap = _vmap_rule(_HostGradient)


class _HostDensity(torch.autograd.Function):
    """The host log density ``(..., dim) -> (...)``; its backward is
    ``g[..., None] * grad`` with the gradient from the host
    (viabel_tpu/models/external.py:57-68)."""

    @staticmethod
    def forward(x, host):
        return host.value(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, host = inputs
        ctx.save_for_backward(x)
        ctx.host = host

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return g[..., None] * _HostGradient.apply(x, ctx.host), None


_HostDensity.vmap = _vmap_rule(_HostDensity)


def make_callback_log_density(log_prob_fn, grad_log_prob_fn, dim,
                              batched=False):
    """Wrap host functions into a differentiable log density
    (viabel_tpu/models/external.py:22-71).

    Parameters
    ----------
    log_prob_fn : callable
        ``(dim,) -> float`` (or ``(n, dim) -> (n,)`` if `batched`), on
        numpy arrays.
    grad_log_prob_fn : callable
        ``(dim,) -> (dim,)`` (or ``(n, dim) -> (n, dim)`` if `batched`).
    dim : int
        Parameter dimension.
    batched : bool
        Whether the host functions already accept batches.

    Returns
    -------
    log_density : callable
        ``(n, dim) -> (n,)`` and ``(dim,) -> ()`` on tensors of any device,
        differentiable by autograd and `torch.func`, with
        ``host_callback = True``: the optimizers and HMC never capture it
        in a CUDA graph.
    """
    host = _Host(log_prob_fn, grad_log_prob_fn, int(dim), batched)

    def log_density(x):
        return _HostDensity.apply(x, host)

    log_density.host_callback = True
    return log_density


def is_host_callback(log_density):
    """Whether `log_density` (a callable, or a `Model` whose `log_prob` is
    one) evaluates on the host through `make_callback_log_density`."""
    return bool(getattr(log_density, 'host_callback', False) or getattr(
        getattr(log_density, 'log_prob', None), 'host_callback', False))
