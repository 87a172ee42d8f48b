"""The CHIVI value-and-gradient kernel of the mean-field families on the
eight-schools densities, with its plain version.

One CUDA kernel from ``csrc/klvi_mf.cu`` (see the note at its top), beside
the KLVI kernel of `ops.klvi_mf`, whose density code and launch plumbing
(`ops.mf_kernels`) it shares: `chivi_mf` evaluates presampled CHIVI
without the n_eff scaling (`objectives.black_box_chivi`), its gradient in
closed form and its log-norm ``max lw`` for the mean-field Student-t or
Gaussian family on the centred or non-centred eight-schools density, for
one run or for a batch of K runs, a block a run.  As `klvi_mf` it takes
the iteration's row of the presampled draws from the adagrad state's
device ``counter``, so one launch serves every iteration of a replayed
CUDA graph beside the step kernel; the optimizers bind it once a run
(`ChiviMeanField.bind`) into value, gradient and log-norm buffers that
the step then reads.

The plain version is the autograd objective itself: the CHIVI function
(a `torch.func.vjp` of the log-weights) on the counter's row, vmapped over
a batch, which every run off the card keeps.

Which evaluations engage the kernel is observed in the input, as for
`klvi_mf` (`mf_kernels.takes`, `mf_kernels.engages`): presampled CHIVI
without n_eff on the families and densities that kernel takes, and a CUDA
float32 or float64 parameter with its draws beside it.

`launches` counts executions of the kernel as `klvi_mf.launches` does;
`replayed` the part that replayed graphs ran.
"""
import torch

from ..distributions import _LOG_2PI, t_lognorm
from .mf_kernels import DIM, bind, counters, engages, pick_rows, takes

__all__ = ['ChiviMeanField', 'fused_chivi', 'chivi_mf_plain', 'launches',
           'replayed', 'reset_launches', 'count_replays']

# a draw a thread up to here, then a stride (float64 spills at 512)
MAX_THREADS = {torch.float32: 512, torch.float64: 256}

launches, replayed, reset_launches, count_replays = counters('chivi_mf')


def _log_q_const(family_name, df):
    """The part of ``log q(z)`` along the path that no draw and no
    parameter moves: ``d t_lognorm(df)`` for the t family, ``-d log(2 pi)
    / 2`` for the Gaussian (the kernel takes ``sum log_scale`` off it)."""
    if family_name == 'mf_t':
        return DIM * t_lognorm(df)
    return -0.5 * DIM * _LOG_2PI


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


class ChiviMeanField:
    """The hand-written body of presampled CHIVI on a mean-field family and
    an eight-schools CUDA density, which `objectives.black_box_chivi`
    carries as ``fused`` (see `fused_chivi`): the CHIVI `objective` itself
    (the plain version), alpha, the family and the model."""

    count_replays = staticmethod(count_replays)  # the graph driver calls it

    def __init__(self, objective, alpha, var_family, model):
        self.objective = objective
        self.alpha = float(alpha)
        self.family_name = var_family.name
        self.df = var_family.df
        self.model = model

    def engages(self, param, draws):
        """Whether the kernel takes an evaluation at `param` (P,) or (K, P)
        on `draws` (`mf_kernels.engages`); otherwise the autograd body
        runs."""
        return engages(param, draws)

    def bind(self, param, draws, counter):
        """``evaluate() -> (value, grad, log_norm)`` on the card: the
        evaluation at the live `param` on the row that the live `counter`
        names (row 0 where `counter` is None), written into buffers
        allocated here, once a run, and returned (`mf_kernels.bind`)."""
        student_t = self.family_name == 'mf_t'
        own = (int(student_t), float(self.df) if student_t else 0.0,
               _log_q_const(self.family_name, self.df), self.alpha)
        launch, outputs = bind('chivi_mf', launches, self.model, param,
                               draws, counter, own,
                               MAX_THREADS[param.dtype])

        def evaluate():
            launch()
            return outputs

        return evaluate


def fused_chivi(objective, alpha, var_family, log_density):
    """The `ChiviMeanField` body of presampled CHIVI (no n_eff scaling) of
    `var_family` on `log_density`, `objective` the CHIVI function itself,
    or None where the kernel cannot take it (`mf_kernels.takes`)."""
    if not takes(var_family, log_density):
        return None
    return ChiviMeanField(objective, alpha, var_family, log_density)
