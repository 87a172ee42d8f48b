"""The windowed-adagrad step kernel, with its plain PyTorch version.

One CUDA kernel from ``csrc/adagrad.cu`` (see the note at its top):
`adagrad_step` runs one iteration of the JAX package's windowed adagrad,
the body of its compiled ``lax.scan`` (``_make_adagrad_step`` with
``_window_accum``, viabel_tpu/optimizers.py:149-165 and 201-230, and the
tail sum of ``_adagrad_run``, :269-275), on an `AdagradState` that lives
on the device, for one run or for a batch of K runs at once (the
JAX package's vmapped scan of `validated_vi_multistart` and
`validated_vi_sweep`).  The iteration it runs is the state's int64
``counter`` (one slot a run), which the step advances, so the same launch
serves every iteration and `optimizers._adagrad_run` can replay it from a
CUDA graph (`replay`).

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

__all__ = ['AdagradState', 'new_state', 'restore_state', 'host_state',
           'adagrad_step', 'adagrad_step_plain', 'replay', 'launches',
           'replayed', 'reset_launches']

launches = {'adagrad_step': 0}
replayed = {'adagrad_step': 0}  # the part of `launches` that replays ran


def reset_launches():
    for counts in (launches, replayed):
        for k in counts:
            counts[k] = 0


class AdagradState(NamedTuple):
    """The device-side state of a windowed-adagrad run, or of a batch of
    runs, all of it on the parameter's device in the parameter's dtype but
    ``counter``.  A batch puts a leading run axis K on every field (the
    shapes below are one run's); a single run has none, and its counter is
    ``(1,)``."""
    param: torch.Tensor           # (P,), updated in place
    grads: torch.Tensor           # (window, P), the ring of gradients
    ring_log_norms: torch.Tensor  # (window,)
    counter: torch.Tensor         # (1,) or (K,) int64: the next iteration
    lr: torch.Tensor              # (n_iters,): the learning rate of each
    values: torch.Tensor          # (n_iters,)
    log_norms: torch.Tensor       # (n_iters,)
    params: Optional[torch.Tensor]  # (n_iters, P) after each step, or None
    tail_sum: torch.Tensor        # (P,): sum of the params from tail_start
    epsilon: float
    tail_start: int


def new_state(init_param, lr, window, epsilon, keep_history):
    """A fresh `AdagradState` at iteration 0 from a copy of `init_param`,
    (P,) for one run or (K, P) for a batch, and the per-iteration learning
    rates `lr`, (n_iters,) or one table a run (K, n_iters), which the
    caller builds on the host and casts to the parameter's dtype; the tail
    is the last quarter, from iteration ``3 n_iters // 4``."""
    param = init_param.detach().clone()
    dtype, device = param.dtype, param.device
    batch, P = tuple(param.shape[:-1]), param.shape[-1]
    n_iters = lr.shape[-1]
    if len(batch) > 1 or tuple(lr.shape[:-1]) != batch:
        raise ValueError('init_param must be (P,) or (K, P) and lr (n_iters,) '
                         'or (K, n_iters) alike; got {} and {}'.format(
                             tuple(param.shape), tuple(lr.shape)))
    return AdagradState(
        param=param,
        grads=torch.zeros(batch + (window, P), dtype=dtype, device=device),
        ring_log_norms=torch.zeros(batch + (window,), dtype=dtype,
                                   device=device),
        counter=torch.zeros(batch or (1,), dtype=torch.int64, device=device),
        lr=lr.to(device, dtype),
        values=torch.empty(batch + (n_iters,), dtype=dtype, device=device),
        log_norms=torch.empty(batch + (n_iters,), dtype=dtype,
                              device=device),
        params=(torch.empty(batch + (n_iters, P), dtype=dtype, device=device)
                if keep_history else None),
        tail_sum=torch.zeros(batch + (P,), dtype=dtype, device=device),
        epsilon=float(epsilon), tail_start=3 * n_iters // 4)


def restore_state(param, lr, window, epsilon, keep_history, i, grads,
                  ring_log_norms, tail_sum):
    """A single run's `AdagradState` at iteration `i`, made from host
    arrays (a checkpoint's): `param` (P,), the ring `grads` (window, P)
    and `ring_log_norms` (window,) in the JAX package's slot order (the
    gradient of iteration j in slot ``j % window``, the kernel's order
    too) and the running `tail_sum` (P,), all on `lr`'s device in
    `param`'s dtype; ``counter = i``.  The histories are allocated for the
    whole run and filled from iteration `i` on."""
    device = lr.device
    param = torch.as_tensor(param).to(device)
    state = new_state(param, lr, window, epsilon, keep_history)
    for name, value in (('grads', grads), ('ring_log_norms', ring_log_norms),
                        ('tail_sum', tail_sum)):
        getattr(state, name).copy_(torch.as_tensor(value))
    state.counter.fill_(int(i))
    return state


def host_state(state):
    """A single run's resumable state on the host, as numpy copies (never
    views of the live state, on the CPU either): the counter ``i``,
    ``param``, the ring ``grads`` and ``log_norms`` and the running
    ``tail_sum`` (the arrays `restore_state` takes)."""
    def host(t):
        return t.to('cpu', copy=True).numpy()

    return dict(i=int(state.counter[0]), param=host(state.param),
                grads=host(state.grads),
                log_norms=host(state.ring_log_norms),
                tail_sum=host(state.tail_sum))


def _runs(state):
    """`state` with a leading run axis: the tensors themselves for a batch,
    views of K = 1 for a single run (writes go through)."""
    if state.param.dim() == 2:
        return state
    return state._replace(**{
        name: getattr(state, name)[None]
        for name in ('param', 'grads', 'ring_log_norms', 'lr', 'values',
                     'log_norms', 'params', 'tail_sum')
        if getattr(state, name) is not None})


_ptr = ctypes.c_void_p
_SIGNATURES = {
    'adagrad_step': [_ptr] * 12 + [ctypes.c_int, ctypes.c_int, ctypes.c_int,
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
    runs = _runs(state)
    K, P = runs.param.shape
    window, n_iters = runs.grads.shape[1], runs.values.shape[1]
    batch = tuple(state.param.shape[:-1])
    check_tensor('param', state.param, None, None, batch + (P,))
    for name, t, shape in (
            ('grads', runs.grads, (K, window, P)),
            ('ring_log_norms', runs.ring_log_norms, (K, window)),
            ('lr', runs.lr, (K, n_iters)),
            ('values', runs.values, (K, n_iters)),
            ('log_norms', runs.log_norms, (K, n_iters)),
            ('tail_sum', runs.tail_sum, (K, P)),
            ('grad', grad, batch + (P,)), ('value', value, batch),
            ('log_norm', log_norm, batch)):
        check_tensor(name, t, state.param.dtype, state.param.device, shape)
    if state.params is not None:
        check_tensor('params', runs.params, state.param.dtype,
                     state.param.device, (K, n_iters, P))
    c = state.counter
    if c.dtype != torch.int64 or tuple(c.shape) != (K,) \
            or c.device != state.param.device or not c.is_contiguous():
        raise TypeError('counter must be a contiguous int64 ({},) tensor on '
                        '{}'.format(K, state.param.device))


def adagrad_step_plain(state, grad, value, log_norm):
    """Plain version of the step kernel, in tensor operations on the
    device counters (no host decision, so it too could be captured): for
    each run, the masked ring of the JAX package's ``_window_accum``, the
    update and the outputs of iteration ``counter``, which it then
    advances."""
    s = _runs(state)
    K, window, P = s.grads.shape
    i = s.counter                                          # (K,)
    grad, value, log_norm = (grad.reshape(K, P), value.reshape(K, 1),
                             log_norm.reshape(K, 1))
    slot = torch.remainder(i, window)[:, None]             # (K, 1)
    s.grads.scatter_(1, slot[:, :, None].expand(K, 1, P), grad[:, None])
    s.ring_log_norms.scatter_(1, slot, log_norm)
    ln = s.ring_log_norms
    valid = (torch.arange(window, device=i.device)[None]
             < torch.clamp(i + 1, max=window)[:, None])    # (K, window)
    low = torch.amin(torch.where(valid, ln, math.inf), dim=1, keepdim=True)
    scale = torch.where(valid, torch.exp(low - ln), 0.0)
    accum = torch.sum((scale[:, :, None] * s.grads) ** 2, dim=1)
    lr = s.lr.gather(1, i[:, None])
    s.param.sub_(lr * grad / torch.sqrt(state.epsilon + accum))
    s.values.scatter_(1, i[:, None], value)
    s.log_norms.scatter_(1, i[:, None], log_norm)
    if s.params is not None:
        s.params.scatter_(1, i[:, None, None].expand(K, 1, P),
                          s.param[:, None])
    s.tail_sum.add_(torch.where((i >= state.tail_start)[:, None], s.param,
                                0.0))
    s.counter.add_(1)


def adagrad_step(state, grad, value, log_norm):
    """One windowed-adagrad iteration of every run of `state`, in place:
    the kernel on the card (one block a run), its plain version on the
    CPU.  `grad` (P,) or (K, P), `value` and `log_norm` () or (K,) are in
    the parameter's dtype and device."""
    _check(state, grad, value, log_norm)
    if state.param.device.type == 'cpu':
        return adagrad_step_plain(state, grad, value, log_norm)
    device, dtype = state.param.device, state.param.dtype
    fn = getattr(_lib(), 'adagrad_step_{}'.format(_SUFFIX[dtype]))
    params = state.params.data_ptr() if state.params is not None else None
    K, P = state.counter.shape[0], state.param.shape[-1]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        rc = fn(grad.data_ptr(), value.data_ptr(), log_norm.data_ptr(),
                state.lr.data_ptr(), state.counter.data_ptr(),
                state.param.data_ptr(), state.grads.data_ptr(),
                state.ring_log_norms.data_ptr(), state.values.data_ptr(),
                state.log_norms.data_ptr(), params,
                state.tail_sum.data_ptr(), K, P, state.grads.shape[-2],
                state.values.shape[-1], state.tail_start, state.epsilon,
                stream.cuda_stream)
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
