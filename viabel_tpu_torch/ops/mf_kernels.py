"""The launch plumbing that the value-and-gradient kernels of the mean-field
families on the eight-schools densities share (``csrc/klvi_mf.cu``).

`ops.klvi_mf` (KLVI) and `ops.chivi_mf` (CHIVI) each launch one kernel of
that library; both take the same families, densities, layouts of the
presampled draws and device counter, so what decides whether a kernel
takes an evaluation, the library's entry points, the layout checks and
the bound launch live here:

- `takes`: the family and density the kernels are written for (the
  mean-field t or Gaussian family of dimension 10 on a `models.Model`
  carrying an eight-schools CUDA density);
- `engages`: an evaluation they take (a CUDA float32 or float64 parameter,
  (P,) or (K, P), with its presampled block beside it, the rows of a run
  contiguous);
- `bind`: one kernel's launch at a run's tensors, its arguments made once,
  writing into output buffers allocated once a run;
- `counters`: a kernel's launch counters (`launches`, `replayed`).
"""
import ctypes
import functools

import torch

from ..models.base import Model
from . import _build
from .lw_stats import ModelSpec, check_layout, check_tensor, model_spec

__all__ = ['FAMILIES', 'MODELS', 'DIM', 'takes', 'engages', 'bind',
           'counters', 'pick_rows']

FAMILIES = ('mf_t', 'mf_gaussian')
MODELS = ('eight_schools_cp', 'eight_schools_ncp')
DIM = 10                # the eight-schools dimension the kernels unroll

_ptr = ctypes.c_void_p
# every entry point's arguments up to the model: param, draws, run stride,
# counter, K, n_iters, n_mc, d, the model's spec
_HEAD = [_ptr, _ptr, ctypes.c_longlong, _ptr, ctypes.c_int,
         ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
         ctypes.POINTER(ModelSpec)]
# each entry point's own arguments after the model, and its outputs (the
# value and the gradient first)
_OWN = {
    'klvi_mf': ([ctypes.c_double], 2),            # the entropy's constant
    'chivi_mf': ([ctypes.c_int, ctypes.c_double, ctypes.c_double,
                  ctypes.c_double], 3),           # t?, df, log q's, alpha
}
# each entry point's arguments before the stream: the head, its own, the
# block's threads and its outputs
_SIGNATURES = {name: _HEAD + own + [ctypes.c_int] + [_ptr] * n_out
               for name, (own, n_out) in _OWN.items()}
_SUFFIX = {torch.float32: 'f32', torch.float64: 'f64'}


def counters(name):
    """``(launches, replayed, reset_launches, count_replays)`` of kernel
    `name`: ``launches[name]`` counts its executions, one per launch
    outside a graph capture (`bind` counts them) and, through
    ``count_replays(evaluations)``, one per evaluation that a replayed
    graph runs; ``replayed[name]`` counts the latter alone."""
    launches = {name: 0}
    replayed = {name: 0}

    def reset_launches():
        launches[name] = replayed[name] = 0

    def count_replays(evaluations):
        """Count `evaluations` of the kernel that a replayed graph ran."""
        launches[name] += evaluations
        replayed[name] += evaluations

    return launches, replayed, reset_launches, count_replays


@functools.lru_cache(maxsize=None)
def _lib():
    """The built library with its entry points' C signatures declared."""
    lib = _build.load('klvi_mf')
    for name, argtypes in _SIGNATURES.items():
        for suffix in _SUFFIX.values():
            fn = getattr(lib, '{}_{}'.format(name, suffix))
            fn.argtypes = argtypes + [_ptr]  # + the stream
            fn.restype = ctypes.c_int
    check_layout(lib, 'klvi_mf')
    return lib


def takes(var_family, log_density):
    """Whether the kernels are written for `var_family` on `log_density`:
    the mean-field t or Gaussian family of dimension 10 on a
    `models.Model` carrying an eight-schools CUDA density."""
    return (getattr(var_family, 'name', None) in FAMILIES
            and getattr(var_family, 'dim', None) == DIM
            and isinstance(log_density, Model)
            and log_density.kernel in MODELS)


def pick_rows(draws, counter, batched):
    """Row ``counter[k]`` of each run's block: ``(n_mc, d)`` for a single
    run's ``(n_iters, n_mc, d)`` block, ``(K, n_mc, d)`` for a batch's
    ``(K, n_iters, n_mc, d)``; no counter, row 0."""
    if counter is None:
        return draws[:, 0] if batched else draws[0]
    if batched:
        index = counter[:, None, None, None].expand(
            draws.shape[0], 1, *draws.shape[2:])
        return torch.gather(draws, 1, index).squeeze(1)
    return draws.index_select(0, counter[:1]).squeeze(0)


def layout(param, draws):
    """``(K, n_iters, n_mc, run stride)`` of an evaluation at `param` on
    `draws`; raises unless the kernels can take them."""
    check_tensor('param', param, None, None)
    batched = param.dim() == 2
    if param.shape[-1] != 2 * DIM or param.dim() not in (1, 2):
        raise ValueError('param must be ({0},) or (K, {0}), got {1}'.format(
            2 * DIM, tuple(param.shape)))
    K = param.shape[0] if batched else 1
    if (not isinstance(draws, torch.Tensor) or draws.dtype != param.dtype
            or draws.device != param.device
            or draws.dim() != (4 if batched else 3)
            or draws.shape[-1] != DIM
            or (batched and draws.shape[0] != K)):
        raise ValueError('draws must be a {} block of {} on {} with d = {}; '
                         'got {}'.format(
                             '(K, n_iters, n_mc, d)' if batched
                             else '(n_iters, n_mc, d)', param.dtype,
                             param.device, DIM,
                             tuple(draws.shape)
                             if isinstance(draws, torch.Tensor) else draws))
    n_iters, n_mc = draws.shape[-3], draws.shape[-2]
    if n_iters < 1 or n_mc < 1:
        raise ValueError('draws must hold a row of at least one draw')
    if (draws.stride(-1) != 1 or draws.stride(-2) != DIM
            or draws.stride(-3) != n_mc * DIM):
        raise ValueError('the rows of a run of draws must be contiguous')
    return K, n_iters, n_mc, draws.stride(0) if batched else 0


def engages(param, draws):
    """Whether the kernels take an evaluation at `param` (P,) or (K, P) on
    `draws`, the presampled block of each run: a CUDA parameter of float32
    or float64 and its draws beside it, the rows of a run contiguous."""
    if not (isinstance(param, torch.Tensor)
            and param.device.type == 'cuda' and param.dtype in _SUFFIX):
        return False
    try:
        layout(param, draws)
    except (TypeError, ValueError):
        return False
    return True


def _check_counter(param, counter):
    K = param.shape[0] if param.dim() == 2 else 1
    if counter is not None and (
            counter.dtype != torch.int64 or tuple(counter.shape) != (K,)
            or counter.device != param.device
            or not counter.is_contiguous()):
        raise TypeError('counter must be a contiguous int64 ({},) tensor on '
                        '{}'.format(K, param.device))


def bind(name, counts, model, param, draws, counter, own, max_threads):
    """``(launch, outputs)``: the launch of entry point `name` (of
    `param`'s dtype) at the live `param` on the row of `draws` that the
    live `counter` names (row 0 where it is None), with its `own`
    arguments after the model's, as a function of no arguments, and the
    output buffers it writes, allocated here: the value (one a run), the
    gradient (`param`'s shape) and, for CHIVI, the log-norm (one a run).
    The arguments are made here, outside any capture, so the launch only
    issues the kernel; it raises if CUDA refused it and counts itself in
    ``counts[name]`` outside a graph capture.  A block takes a draw a
    thread, rounded up to a warp, at most `max_threads` (each thread then
    takes every `max_threads`-th draw)."""
    _check_counter(param, counter)
    K, n_iters, n_mc, run_stride = layout(param, draws)
    value = param.new_empty(param.shape[:-1])
    outputs = (value, torch.empty_like(param)) + tuple(
        torch.empty_like(value) for _ in range(_OWN[name][1] - 2))
    spec, data = model_spec(model.kernel, model.kernel_data_like(param),
                            param.device, param.dtype)
    threads = min(max_threads, -(-n_mc // 32) * 32)
    args = (param.data_ptr(), draws.data_ptr(), run_stride,
            None if counter is None else counter.data_ptr(), K, n_iters,
            n_mc, DIM, ctypes.byref(spec), *own, threads,
            *(o.data_ptr() for o in outputs))
    device = param.device
    fn = getattr(_lib(), '{}_{}'.format(name, _SUFFIX[param.dtype]))

    def launch():
        with torch.cuda.device(device):
            rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
            capturing = torch.cuda.is_current_stream_capturing()
        if rc != 0:
            raise RuntimeError('{} launch failed: CUDA error {}'.format(
                name, rc))
        if not capturing:
            counts[name] += 1

    launch.holds = (spec, data)  # alive as long as the launch
    return launch, outputs
