"""The windowed-adagrad step kernel, with its plain PyTorch version.

One CUDA kernel from ``csrc/adagrad.cu`` (see the note at its top):
`adagrad_step` runs one iteration of the JAX package's windowed adagrad,
the body of its compiled ``lax.scan`` (``_make_adagrad_step`` with
``_window_accum``, viabel_tpu/optimizers.py:149-165 and 201-230, and the
tail sum of ``_adagrad_run``, :269-275), on an `AdagradState` that lives
on the device.  The iteration it runs is the state's int64 ``counter``,
which the step advances, so the same launch serves every iteration and
`optimizers._adagrad_run` can replay it from a CUDA graph (`replay`).

Each wrapper takes the plain version only for a tensor on the CPU; for a
CUDA tensor it launches the kernel (building it on first use) or raises.
`launches` counts executions of the kernel: one per launch outside a graph
capture (a capture records the launch and runs nothing), and, through
`replay`, one per step that a replayed graph runs; `replayed` counts the
latter alone.
"""
import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from . import _build
from .lw_stats import check_tensor

__all__ = ['AdagradState', 'new_state', 'adagrad_step', 'adagrad_step_plain',
           'replay', 'launches', 'replayed', 'reset_launches']

launches = {'adagrad_step': 0}
replayed = {'adagrad_step': 0}  # the part of `launches` that replays ran


def reset_launches():
    for counts in (launches, replayed):
        for k in counts:
            counts[k] = 0


class AdagradState(NamedTuple):
    """The device-side state of one windowed-adagrad run, all of it on the
    parameter's device in the parameter's dtype but ``counter``."""
    param: torch.Tensor           # (P,), updated in place
    grads: torch.Tensor           # (window, P), the ring of gradients
    ring_log_norms: torch.Tensor  # (window,)
    counter: torch.Tensor         # (1,) int64: the next step's iteration
    lr: torch.Tensor              # (n_iters,): the learning rate of each
    values: torch.Tensor          # (n_iters,)
    log_norms: torch.Tensor       # (n_iters,)
    params: Optional[torch.Tensor]  # (n_iters, P) after each step, or None
    tail_sum: torch.Tensor        # (P,): sum of the params from tail_start
    epsilon: float
    tail_start: int


def new_state(init_param, lr, window, epsilon, keep_history):
    """A fresh `AdagradState` at iteration 0 from a copy of `init_param`
    (P,) and the per-iteration learning rates `lr` (n_iters,), which the
    caller builds on the host and casts to the parameter's dtype; the tail
    is the last quarter, from iteration ``3 n_iters // 4``."""
    param = init_param.detach().clone()
    dtype, device = param.dtype, param.device
    n_iters, P = lr.shape[0], param.shape[0]
    return AdagradState(
        param=param,
        grads=torch.zeros((window, P), dtype=dtype, device=device),
        ring_log_norms=torch.zeros((window,), dtype=dtype, device=device),
        counter=torch.zeros((1,), dtype=torch.int64, device=device),
        lr=lr.to(device, dtype),
        values=torch.empty((n_iters,), dtype=dtype, device=device),
        log_norms=torch.empty((n_iters,), dtype=dtype, device=device),
        params=(torch.empty((n_iters, P), dtype=dtype, device=device)
                if keep_history else None),
        tail_sum=torch.zeros((P,), dtype=dtype, device=device),
        epsilon=float(epsilon), tail_start=3 * n_iters // 4)


_ptr = ctypes.c_void_p
_SIGNATURES = {
    'adagrad_step': [_ptr] * 12 + [ctypes.c_int, ctypes.c_int,
                                   ctypes.c_longlong, ctypes.c_longlong,
                                   ctypes.c_double],
}
_SUFFIX = {torch.float32: 'f32', torch.float64: 'f64'}


@functools.lru_cache(maxsize=None)
def _lib():
    """The built library with its entry points' C signatures declared."""
    lib = _build.load('adagrad')
    for name, argtypes in _SIGNATURES.items():
        for suffix in _SUFFIX.values():
            fn = getattr(lib, '{}_{}'.format(name, suffix))
            fn.argtypes = argtypes + [_ptr]  # + the stream
            fn.restype = ctypes.c_int
    return lib


def _check(state, grad, value, log_norm):
    param = state.param
    P = param.shape[0]
    check_tensor('param', param, None, None, (P,))
    for name, t, shape in (
            ('grads', state.grads, (state.grads.shape[0], P)),
            ('ring_log_norms', state.ring_log_norms,
             (state.grads.shape[0],)),
            ('lr', state.lr, state.values.shape),
            ('values', state.values, None),
            ('log_norms', state.log_norms, state.values.shape),
            ('tail_sum', state.tail_sum, (P,)),
            ('grad', grad, (P,)), ('value', value, ()),
            ('log_norm', log_norm, ())):
        check_tensor(name, t, param.dtype, param.device, shape)
    if state.params is not None:
        check_tensor('params', state.params, param.dtype, param.device,
                     (state.values.shape[0], P))
    c = state.counter
    if c.dtype != torch.int64 or tuple(c.shape) != (1,) \
            or c.device != param.device:
        raise TypeError('counter must be an int64 (1,) tensor on {}'
                        .format(param.device))


def adagrad_step_plain(state, grad, value, log_norm):
    """Plain version of the step kernel, in tensor operations on the
    device counter (no host decision, so it too could be captured):
    the masked ring of the JAX package's ``_window_accum``, the update and
    the outputs of iteration ``counter``, which it then advances."""
    window = state.grads.shape[0]
    i = state.counter
    slot = torch.remainder(i, window)
    state.grads.index_copy_(0, slot, grad[None])
    state.ring_log_norms.index_copy_(0, slot, log_norm.reshape(1))
    ln = state.ring_log_norms
    valid = (torch.arange(window, device=i.device)
             < torch.clamp(i + 1, max=window))
    low = torch.min(torch.where(valid, ln, math.inf))
    scale = torch.where(valid, torch.exp(low - ln), 0.0)
    accum = torch.sum((scale[:, None] * state.grads) ** 2, dim=0)
    lr = state.lr.index_select(0, i)
    state.param.sub_(lr * grad / torch.sqrt(state.epsilon + accum))
    state.values.index_copy_(0, i, value.reshape(1))
    state.log_norms.index_copy_(0, i, log_norm.reshape(1))
    if state.params is not None:
        state.params.index_copy_(0, i, state.param[None])
    state.tail_sum.add_(torch.where(i >= state.tail_start, state.param, 0.0))
    state.counter.add_(1)


def adagrad_step(state, grad, value, log_norm):
    """One windowed-adagrad iteration on `state`, in place: the kernel on
    the card, its plain version on the CPU.  `grad` (P,), `value` and
    `log_norm` (0-d) are in the parameter's dtype and device."""
    _check(state, grad, value, log_norm)
    if state.param.device.type == 'cpu':
        return adagrad_step_plain(state, grad, value, log_norm)
    device, dtype = state.param.device, state.param.dtype
    fn = getattr(_lib(), 'adagrad_step_{}'.format(_SUFFIX[dtype]))
    params = state.params.data_ptr() if state.params is not None else None
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        rc = fn(grad.data_ptr(), value.data_ptr(), log_norm.data_ptr(),
                state.lr.data_ptr(), state.counter.data_ptr(),
                state.param.data_ptr(), state.grads.data_ptr(),
                state.ring_log_norms.data_ptr(), state.values.data_ptr(),
                state.log_norms.data_ptr(), params,
                state.tail_sum.data_ptr(), state.param.shape[0],
                state.grads.shape[0], state.values.shape[0],
                state.tail_start, state.epsilon, stream.cuda_stream)
        capturing = torch.cuda.is_current_stream_capturing()
    if rc != 0:
        raise RuntimeError('adagrad_step launch failed: CUDA error {}'
                           .format(rc))
    if not capturing:
        launches['adagrad_step'] += 1


def replay(graph, steps):
    """Replay a captured CUDA graph that holds `steps` launches of the step
    kernel on the current stream, and count them."""
    graph.replay()
    launches['adagrad_step'] += steps
    replayed['adagrad_step'] += steps
