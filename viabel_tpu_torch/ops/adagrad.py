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
CUDA graph.  An objective without a log-norm passes
``log_norm=None``, and the step writes 0 into the ring and the history,
so no tensor of zeros is made at every iteration.

The shape of each launch is `launch_shape` of (K, P, window, dtype): one
block a run, a thread a column, up to one block's share of a ring row
(`BLOCK_BYTES`), else a thread-block cluster of up to 16 blocks a run;
the window-10 instance (every path's default) holds the ring column in
registers, any other window takes the runtime-window instance.  A launch
the card refuses raises.

Each wrapper takes the plain version only for a tensor on the CPU; for a
CUDA tensor it launches the kernel (building it on first use) or raises,
through `ops._launch`, which counts the launches and the replayed ones.
"""
import ctypes
import math
from typing import NamedTuple, Optional

import torch

from ._launch import Library
from .lw_stats import check_tensor

__all__ = ['AdagradState', 'new_state', 'restore_state', 'host_state',
           'LaunchShape', 'launch_shape', 'adagrad_step',
           'adagrad_step_plain', 'launch_floor']

# the window the kernel unrolls (optimizers.adagrad_optimize's default and
# every path's); any other window takes the runtime-window instance
UNROLLED_WINDOW = 10
# a block's share of a ring row: 512 float32 or 256 float64 columns, a
# thread each; a run with more columns is a cluster of such blocks
BLOCK_BYTES = 2048
MAX_CLUSTER, PORTABLE_CLUSTER = 16, 8

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


class LaunchShape(NamedTuple):
    """How `adagrad_step` launches for K runs of P columns: ``threads`` a
    block, ``cluster`` blocks a run (1: one block a run), ``grid`` = K *
    ``cluster`` blocks.  Block ``b`` serves run ``b // cluster`` as rank
    ``b % cluster``; its thread t takes columns ``rank * threads + t``,
    then every ``cluster * threads`` more.  ``unrolled``: the window-10
    instance."""
    unrolled: bool
    threads: int
    cluster: int
    grid: int

    @property
    def nonportable(self):
        """A cluster above the portable 8 blocks, which the kernel is
        allowed first."""
        return self.cluster > PORTABLE_CLUSTER

    def describe(self):
        return '{} window, {}, {} threads a block'.format(
            'unrolled' if self.unrolled else 'runtime',
            'one block a run' if self.cluster == 1 else
            'a cluster of {} blocks a run{}'.format(
                self.cluster, ' (non-portable)' if self.nonportable else ''),
            self.threads)


def launch_shape(K, P, window, dtype):
    """The launch of the step for K runs of P columns with `window` in
    `dtype`: one block a run while P fits one block's share of a ring row
    (`BLOCK_BYTES`), threads rounded up to a warp; else blocks of that
    share, as many a run as cover P, rounded up to a power of two and at
    most `MAX_CLUSTER`."""
    share = BLOCK_BYTES // torch.empty((), dtype=dtype).element_size()
    if P <= share:
        threads, cluster = -(-P // 32) * 32, 1
    else:
        threads = share
        cluster = min(MAX_CLUSTER, 1 << (-(-P // share) - 1).bit_length())
    return LaunchShape(window == UNROLLED_WINDOW, threads, cluster,
                       K * cluster)


_ptr = ctypes.c_void_p
_int = ctypes.c_int
_SIGNATURES = {
    'adagrad_step': [_ptr] * 12 + [_int, _int, _int, ctypes.c_longlong,
                                   ctypes.c_longlong, ctypes.c_double, _int,
                                   _int, _int],
}
_LIB = Library('adagrad', _SIGNATURES,
               helpers={'launch_floor': [_int, _int, _int, _ptr]})


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
        if t is None and name == 'log_norm':
            continue
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
    advances.  ``log_norm=None`` is a log-norm of 0."""
    if log_norm is None:
        log_norm = torch.zeros_like(value)
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
    the kernel on the card (`launch_shape`'s launch), its plain version on
    the CPU.  `grad` (P,) or (K, P), `value` and `log_norm` () or (K,) are
    in the parameter's dtype and device; `log_norm` None is 0."""
    _check(state, grad, value, log_norm)
    if state.param.device.type == 'cpu':
        return adagrad_step_plain(state, grad, value, log_norm)
    dtype = state.param.dtype
    params = state.params.data_ptr() if state.params is not None else None
    K, P = state.counter.shape[0], state.param.shape[-1]
    window = state.grads.shape[-2]
    shape = launch_shape(K, P, window, dtype)
    _LIB.launch('adagrad_step', state.param.device, dtype, grad.data_ptr(),
                value.data_ptr(),
                None if log_norm is None else log_norm.data_ptr(),
                state.lr.data_ptr(), state.counter.data_ptr(),
                state.param.data_ptr(), state.grads.data_ptr(),
                state.ring_log_norms.data_ptr(), state.values.data_ptr(),
                state.log_norms.data_ptr(), params,
                state.tail_sum.data_ptr(), K, P, window,
                state.values.shape[-1], state.tail_start, state.epsilon,
                int(shape.unrolled), shape.threads, shape.cluster,
                shape=shape)


def launch_floor(shape, device='cuda'):
    """Launch an empty kernel of the step's library on `device`'s current
    stream as `shape` (a `LaunchShape`) would launch the step: the card's
    floor under a launch of that size.  It is no step and counts none."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        rc = _LIB.lib.launch_floor(shape.grid, shape.threads,
                                   shape.cluster, stream.cuda_stream)
    if rc != 0:
        raise RuntimeError('launch_floor ({}) failed: CUDA error {}'.format(
            shape.describe(), rc))
