"""The KLVI body of the mean-field families on the eight-schools densities,
with its plain version.

``klvi_mf`` of ``csrc/klvi_mf.cu`` (see the note at its top) evaluates
presampled KLVI with the closed-form entropy (`objectives.black_box_klvi`)
and its gradient in closed form for the mean-field Student-t or Gaussian
family on the centred or non-centred eight-schools density, for one run or
for a batch of K runs, a block a run.  It takes the iteration's row of the
presampled draws itself, from the adagrad state's device ``counter``, so
one launch serves every iteration of a replayed CUDA graph beside the step
kernel (`ops.adagrad`).  `fused_klvi` makes its `mf_kernels.MeanFieldBody`
where the kernel is written for the family and the density
(`mf_kernels.takes`).

The plain version is the autograd objective itself: ``grad_and_value`` of
the objective's pure ``objective`` on the counter's row (vmapped over a
batch), which every run off the card keeps.
"""
import torch

from ..distributions import _LOG_2PI
from .mf_kernels import DIM, MeanFieldBody, pick_rows, takes

__all__ = ['fused_klvi', 'klvi_mf_plain']

MAX_THREADS = 256       # a draw a thread up to here, then a stride


def klvi_mf_plain(objective, param, draws, counter=None):
    """Plain version of the kernel: ``(value, grad)`` of the pure KLVI
    `objective` by autograd at `param`, (P,) or (K, P), on row
    ``counter[k]`` of each run's presampled block (row 0 without a
    counter)."""
    batched = param.dim() == 2
    rows = pick_rows(draws, counter, batched)
    value_and_grad = torch.func.grad_and_value(objective)
    if batched:
        value_and_grad = torch.func.vmap(value_and_grad)
    grad, value = value_and_grad(param, rows)
    return value, grad


def fused_klvi(objective, var_family, log_density):
    """The body of presampled KLVI of `var_family` on `log_density` with
    the pure scalar `objective`, or None where the kernel cannot take it.
    Its own argument is the entropy's parameter-free part: none for the t
    family (it drops df-only constants), ``0.5 d (1 + log 2 pi)`` for the
    Gaussian."""
    if not takes(var_family, log_density):
        return None
    entropy = 0.0 if var_family.name == 'mf_t' else 0.5 * DIM * (
        1.0 + _LOG_2PI)
    return MeanFieldBody('klvi_mf', objective, log_density, (entropy,),
                         {torch.float32: MAX_THREADS,
                          torch.float64: MAX_THREADS})
