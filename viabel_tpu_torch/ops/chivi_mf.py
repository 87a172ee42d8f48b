"""The CHIVI body of the mean-field families on the eight-schools
densities, with its plain version.

``chivi_mf`` of ``csrc/klvi_mf.cu`` (see the note at its top), beside
KLVI's ``klvi_mf`` (`ops.klvi_mf`), evaluates presampled CHIVI without the
n_eff scaling (`objectives.black_box_chivi`), its gradient in closed form
and its log-norm ``max lw`` for the mean-field Student-t or Gaussian
family on the centred or non-centred eight-schools density, for one run or
for a batch of K runs, a block a run, on the counter's row as ``klvi_mf``
does.  `fused_chivi` makes its `mf_kernels.MeanFieldBody` where the kernel
is written for the family and the density (`mf_kernels.takes`).

The plain version is the autograd objective itself: the CHIVI function
(a `torch.func.vjp` of the log-weights) on the counter's row, vmapped over
a batch, which every run off the card keeps.
"""
import torch

from ..distributions import _LOG_2PI, t_lognorm
from .mf_kernels import DIM, MeanFieldBody, pick_rows, takes

__all__ = ['fused_chivi', 'chivi_mf_plain']

# a draw a thread up to here, then a stride (float64 spills at 512)
MAX_THREADS = {torch.float32: 512, torch.float64: 256}


def chivi_mf_plain(objective, param, draws, counter=None):
    """Plain version of the kernel: ``(value, grad, log_norm)`` of the
    autograd CHIVI `objective` (`objectives.black_box_chivi`) at `param`,
    (P,) or (K, P), on row ``counter[k]`` of each run's presampled block
    (row 0 without a counter)."""
    batched = param.dim() == 2
    rows = pick_rows(draws, counter, batched)
    evaluate = torch.func.vmap(objective) if batched else objective
    value, grad, log_norm = evaluate(param, rows)[:3]
    return value, grad, log_norm


def fused_chivi(objective, alpha, var_family, log_density):
    """The body of presampled CHIVI (no n_eff scaling) of `var_family` on
    `log_density`, `objective` the CHIVI function itself, or None where
    the kernel cannot take it.  Its own arguments: whether the family is
    the t, its df, the part of ``log q(z)`` along the path that no draw
    and no parameter moves (``d t_lognorm(df)`` for the t family, ``-d
    log(2 pi) / 2`` for the Gaussian; the kernel takes ``sum log_scale``
    off it) and alpha."""
    if not takes(var_family, log_density):
        return None
    student_t = var_family.name == 'mf_t'
    df = var_family.df
    own = (int(student_t), float(df) if student_t else 0.0,
           DIM * t_lognorm(df) if student_t else -0.5 * DIM * _LOG_2PI,
           float(alpha))
    return MeanFieldBody('chivi_mf', objective, log_density, own,
                         MAX_THREADS)
