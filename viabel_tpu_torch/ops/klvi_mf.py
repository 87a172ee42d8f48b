"""The KLVI value-and-gradient kernel of the mean-field families on the
eight-schools densities, with its plain version.

One CUDA kernel from ``csrc/klvi_mf.cu`` (see the note at its top):
`klvi_mf` evaluates presampled KLVI with the closed-form entropy
(`objectives.black_box_klvi`) and its gradient in closed form for the
mean-field Student-t or Gaussian family on the centred or non-centred
eight-schools density, for one run or for a batch of K runs, a block a
run.  It takes the iteration's row of the presampled draws itself, from
the adagrad state's device ``counter``, so one launch serves every
iteration of a replayed CUDA graph beside the step kernel
(`ops.adagrad`); the optimizers bind it once a run (`KlviMeanField.bind`)
into value and gradient buffers that the step then reads.

The plain version is the autograd objective itself: ``grad_and_value`` of
the objective's pure ``objective`` on the counter's row (vmapped over a
batch), which every run off the card keeps.

Which evaluations engage the kernel is observed in the input
(`KlviMeanField.engages`, `fused_klvi`): the family's name is ``mf_t`` or
``mf_gaussian``, the log density a `models.Model` whose ``kernel`` is
``eight_schools_cp`` or ``eight_schools_ncp``, the objective presampled
KLVI (`objectives.black_box_klvi` with ``presampled=True``), and the
parameter on a CUDA device in float32 or float64 with its draws beside
it, the rows of a run contiguous.  Anything else keeps its autograd body.

`launches` counts executions of the kernel: one per launch outside a graph
capture, and, through `count_replays`, one per evaluation that a replayed
graph runs; `replayed` counts the latter alone.
"""
import ctypes
import functools

import torch

from ..distributions import _LOG_2PI
from ..models.base import Model
from . import _build
from .lw_stats import ModelSpec, check_layout, check_tensor, model_spec

__all__ = ['FAMILIES', 'MODELS', 'KlviMeanField', 'fused_klvi',
           'klvi_mf_plain', 'launches', 'replayed', 'reset_launches',
           'count_replays']

FAMILIES = ('mf_t', 'mf_gaussian')
MODELS = ('eight_schools_cp', 'eight_schools_ncp')
DIM = 10                # the eight-schools dimension the kernel unrolls
MAX_THREADS = 256       # a draw a thread up to here, then a stride

launches = {'klvi_mf': 0}
replayed = {'klvi_mf': 0}  # the part of `launches` that replays ran


def reset_launches():
    for counts in (launches, replayed):
        for k in counts:
            counts[k] = 0


def count_replays(evaluations):
    """Count `evaluations` of the kernel that a replayed graph ran."""
    launches['klvi_mf'] += evaluations
    replayed['klvi_mf'] += evaluations


def _threads_for(n_mc):
    """A block's threads: a draw a thread, rounded up to a warp, at most
    `MAX_THREADS` (each thread then takes every `MAX_THREADS`-th draw)."""
    return min(MAX_THREADS, -(-n_mc // 32) * 32)


_ptr = ctypes.c_void_p
# the entry point's arguments before the stream
_SIGNATURES = {
    'klvi_mf': [_ptr, _ptr, ctypes.c_longlong, _ptr, ctypes.c_int,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ModelSpec), ctypes.c_double, ctypes.c_int,
                _ptr, _ptr],
}
_SUFFIX = {torch.float32: 'f32', torch.float64: 'f64'}


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


def _entropy_const(family_name, dim):
    """The entropy's parameter-free part: none for the t family (it drops
    df-only constants), ``0.5 d (1 + log 2 pi)`` for the Gaussian."""
    return 0.0 if family_name == 'mf_t' else 0.5 * dim * (1.0 + _LOG_2PI)


def _pick_rows(draws, counter, batched):
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


def klvi_mf_plain(objective, param, draws, counter=None):
    """Plain version of the kernel: ``(value, grad)`` of the pure KLVI
    `objective` by autograd at `param`, (P,) or (K, P), on row
    ``counter[k]`` of each run's presampled block (row 0 without a
    counter)."""
    batched = param.dim() == 2
    rows = _pick_rows(draws, counter, batched)
    value_and_grad = torch.func.grad_and_value(objective)
    if batched:
        value_and_grad = torch.func.vmap(value_and_grad)
    grad, value = value_and_grad(param, rows)
    return value, grad


def _layout(param, draws):
    """``(K, n_iters, n_mc, run stride)`` of an evaluation at `param` on
    `draws`; raises unless the kernel can take them."""
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


def _check_outputs(param, counter, value, grad):
    K = param.shape[0] if param.dim() == 2 else 1
    if counter is not None and (
            counter.dtype != torch.int64 or tuple(counter.shape) != (K,)
            or counter.device != param.device
            or not counter.is_contiguous()):
        raise TypeError('counter must be a contiguous int64 ({},) tensor on '
                        '{}'.format(K, param.device))
    check_tensor('value', value, param.dtype, param.device,
                 tuple(param.shape[:-1]))
    check_tensor('grad', grad, param.dtype, param.device, tuple(param.shape))


def _launcher(family_name, model, param, draws, counter, value, grad):
    """The kernel's launch at these tensors as a function of no arguments,
    its arguments made once (the launch a graph captures reads the live
    tensors)."""
    K, n_iters, n_mc, run_stride = _layout(param, draws)
    device, dtype = param.device, param.dtype
    spec, data = model_spec(model.kernel, model.kernel_data_like(param),
                            device, dtype)
    fn = getattr(_lib(), 'klvi_mf_' + _SUFFIX[dtype])
    args = (param.data_ptr(), draws.data_ptr(), run_stride,
            None if counter is None else counter.data_ptr(), K, n_iters,
            n_mc, DIM, ctypes.byref(spec), _entropy_const(family_name, DIM),
            _threads_for(n_mc), value.data_ptr(), grad.data_ptr())

    def launch():
        with torch.cuda.device(device):
            rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
            capturing = torch.cuda.is_current_stream_capturing()
        if rc != 0:
            raise RuntimeError('klvi_mf launch failed: CUDA error {}'.format(
                rc))
        if not capturing:
            launches['klvi_mf'] += 1

    launch.holds = (spec, data)  # alive as long as the launch
    return launch


class KlviMeanField:
    """The hand-written body of presampled KLVI on a mean-field family and
    an eight-schools CUDA density, which `objectives.black_box_klvi`
    carries as ``fused`` (see `fused_klvi`): its pure scalar `objective`
    (the plain version), the family's name and the model."""

    def __init__(self, objective, family_name, model):
        self.objective = objective
        self.family_name = family_name
        self.model = model

    def engages(self, param, draws):
        """Whether the kernel takes an evaluation at `param` (P,) or (K, P)
        on `draws`, the presampled block of each run: a CUDA parameter of
        float32 or float64 and its draws beside it, the rows of a run
        contiguous.  Otherwise the autograd body runs."""
        if not (isinstance(param, torch.Tensor)
                and param.device.type == 'cuda' and param.dtype in _SUFFIX):
            return False
        try:
            _layout(param, draws)
        except (TypeError, ValueError):
            return False
        return True

    def bind(self, param, draws, counter):
        """``evaluate() -> (value, grad)`` on the card: the evaluation at
        the live `param` on the row that the live `counter` names (row 0
        where `counter` is None), written into a value and a gradient
        buffer allocated here, once a run, and returned.  The launch's arguments are made here, outside any
        capture, so `evaluate` only issues it."""
        value = param.new_empty(param.shape[:-1])
        grad = torch.empty_like(param)
        _check_outputs(param, counter, value, grad)
        launch = _launcher(self.family_name, self.model, param, draws,
                           counter, value, grad)

        def evaluate():
            launch()
            return value, grad

        return evaluate


def fused_klvi(objective, var_family, log_density):
    """The `KlviMeanField` body of presampled KLVI of `var_family` on
    `log_density` with the pure scalar `objective`, or None where the
    kernel cannot take it: a family other than the mean-field t or
    Gaussian of dimension 10, or a log density that is no `models.Model`
    carrying an eight-schools CUDA density."""
    if (getattr(var_family, 'name', None) not in FAMILIES
            or getattr(var_family, 'dim', None) != DIM
            or not isinstance(log_density, Model)
            or log_density.kernel not in MODELS):
        return None
    return KlviMeanField(objective, var_family.name, log_density)
