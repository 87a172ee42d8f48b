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
(`ops.mf_kernels`, whose launch plumbing the CHIVI kernel of
`ops.chivi_mf` shares): the family's name is ``mf_t`` or ``mf_gaussian``,
the log density a `models.Model` whose ``kernel`` is
``eight_schools_cp`` or ``eight_schools_ncp``, the objective presampled
KLVI (`objectives.black_box_klvi` with ``presampled=True``), and the
parameter on a CUDA device in float32 or float64 with its draws beside
it, the rows of a run contiguous.  Anything else keeps its autograd body.

`launches` counts executions of the kernel: one per launch outside a graph
capture, and, through `count_replays`, one per evaluation that a replayed
graph runs; `replayed` counts the latter alone.
"""
import torch

from ..distributions import _LOG_2PI
from .mf_kernels import (DIM, FAMILIES, MODELS, bind, counters, engages,
                         pick_rows, takes)

__all__ = ['FAMILIES', 'MODELS', 'KlviMeanField', 'fused_klvi',
           'klvi_mf_plain', 'launches', 'replayed', 'reset_launches',
           'count_replays']

MAX_THREADS = 256       # a draw a thread up to here, then a stride

launches, replayed, reset_launches, count_replays = counters('klvi_mf')


def _entropy_const(family_name, dim):
    """The entropy's parameter-free part: none for the t family (it drops
    df-only constants), ``0.5 d (1 + log 2 pi)`` for the Gaussian."""
    return 0.0 if family_name == 'mf_t' else 0.5 * dim * (1.0 + _LOG_2PI)


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


class KlviMeanField:
    """The hand-written body of presampled KLVI on a mean-field family and
    an eight-schools CUDA density, which `objectives.black_box_klvi`
    carries as ``fused`` (see `fused_klvi`): its pure scalar `objective`
    (the plain version), the family's name and the model."""

    count_replays = staticmethod(count_replays)  # the graph driver calls it

    def __init__(self, objective, family_name, model):
        self.objective = objective
        self.family_name = family_name
        self.model = model

    def engages(self, param, draws):
        """Whether the kernel takes an evaluation at `param` (P,) or (K, P)
        on `draws` (`mf_kernels.engages`); otherwise the autograd body
        runs."""
        return engages(param, draws)

    def bind(self, param, draws, counter):
        """``evaluate() -> (value, grad, None)`` on the card: the
        evaluation at the live `param` on the row that the live `counter`
        names (row 0 where `counter` is None), written into a value and a
        gradient buffer allocated here, once a run, and returned (KLVI has
        no log-norm; `mf_kernels.bind`)."""
        launch, (value, grad) = bind(
            'klvi_mf', launches, self.model, param, draws, counter,
            (_entropy_const(self.family_name, DIM),), MAX_THREADS)

        def evaluate():
            launch()
            return value, grad, None

        return evaluate


def fused_klvi(objective, var_family, log_density):
    """The `KlviMeanField` body of presampled KLVI of `var_family` on
    `log_density` with the pure scalar `objective`, or None where the
    kernel cannot take it (`mf_kernels.takes`)."""
    if not takes(var_family, log_density):
        return None
    return KlviMeanField(objective, var_family.name, log_density)
