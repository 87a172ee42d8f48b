"""The hand-written body of a presampled objective on a mean-field family
and an eight-schools density: the value-and-gradient kernels of
``csrc/klvi_mf.cu``, KLVI's (`ops.klvi_mf`) and CHIVI's (`ops.chivi_mf`).

Both kernels take the same families, densities, layouts of the presampled
draws and device counter, and differ only in their own arguments after the
model's and in a block's threads, so one body serves both
(`MeanFieldBody`), with what decides whether a kernel takes an
evaluation:

- `takes`: the family and density the kernels are written for (the
  mean-field t or Gaussian family of dimension 10 on a `models.Model`
  carrying an eight-schools CUDA density);
- `MeanFieldBody.engages`: an evaluation they take (a CUDA float32 or
  float64 parameter, (P,) or (K, P), with its presampled block beside it,
  the rows of a run contiguous);
- `MeanFieldBody.bind`: the kernel's launch at a run's tensors, its
  arguments made once, writing into output buffers allocated once a run.
"""
import ctypes

import torch

from ..models.base import Model
from ._launch import SUFFIX, Library
from .lw_stats import ModelSpec, check_layout, check_tensor, model_spec

__all__ = ['FAMILIES', 'MODELS', 'DIM', 'takes', 'MeanFieldBody',
           'pick_rows']

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
_LIB = Library('klvi_mf', _SIGNATURES, check=check_layout)


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


def _check_counter(param, counter):
    K = param.shape[0] if param.dim() == 2 else 1
    if counter is not None and (
            counter.dtype != torch.int64 or tuple(counter.shape) != (K,)
            or counter.device != param.device
            or not counter.is_contiguous()):
        raise TypeError('counter must be a contiguous int64 ({},) tensor on '
                        '{}'.format(K, param.device))


class MeanFieldBody:
    """The hand-written body that a presampled objective carries as
    ``fused`` and the optimizers run in its place on the card: entry point
    `name` of ``csrc/klvi_mf.cu``, the autograd `objective` it stands for
    (its plain version's input), the `model`, the entry point's `own`
    arguments after the model's, and `max_threads`, a block's threads by
    dtype (a draw a thread, rounded up to a warp, up to there; then each
    thread takes every `max_threads`-th draw)."""

    def __init__(self, name, objective, model, own, max_threads):
        self.name = name
        self.objective = objective
        self.model = model
        self.own = own
        self.max_threads = max_threads

    def engages(self, param, draws):
        """Whether the kernel takes an evaluation at `param` (P,) or (K, P)
        on `draws`, the presampled block of each run: a CUDA parameter of
        float32 or float64 and its draws beside it, the rows of a run
        contiguous; otherwise the autograd body runs."""
        if not (isinstance(param, torch.Tensor)
                and param.device.type == 'cuda' and param.dtype in SUFFIX):
            return False
        try:
            layout(param, draws)
        except (TypeError, ValueError):
            return False
        return True

    def bind(self, param, draws, counter):
        """``evaluate() -> (value, grad, log_norm or None)`` on the card:
        the launch at the live `param` on the row of `draws` that the live
        `counter` names (row 0 where it is None), its arguments made here,
        outside any capture, writing into buffers allocated here, once a
        run: the value (one a run), the gradient (`param`'s shape) and, for
        CHIVI, the log-norm (one a run)."""
        _check_counter(param, counter)
        K, n_iters, n_mc, run_stride = layout(param, draws)
        value = param.new_empty(param.shape[:-1])
        n_out = _OWN[self.name][1]
        outputs = (value, torch.empty_like(param)) + tuple(
            torch.empty_like(value) for _ in range(n_out - 2))
        spec, data = model_spec(self.model.kernel,
                                self.model.kernel_data_like(param),
                                param.device, param.dtype)
        threads = min(self.max_threads[param.dtype], -(-n_mc // 32) * 32)
        args = (param.data_ptr(), draws.data_ptr(), run_stride,
                None if counter is None else counter.data_ptr(), K, n_iters,
                n_mc, DIM, ctypes.byref(spec), *self.own, threads,
                *(o.data_ptr() for o in outputs))
        name, device, dtype = self.name, param.device, param.dtype
        result = outputs + (None,) * (3 - n_out)

        def evaluate():
            _LIB.launch(name, device, dtype, *args)
            return result

        evaluate.holds = (spec, data)  # alive as long as the launch
        return evaluate
