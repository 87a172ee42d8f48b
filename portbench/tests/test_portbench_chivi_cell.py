"""The CHIVI cell ``es_cp_chivi_fit`` whole on the CPU at small sizes: the
sound run is `correct`, and the check fails the control, a step left
unchanged and two CHIVI faults planted in the timed path (the objective
over half its draws; the step given no log-norm).  Its `cuda` test holds
a float32 fit on the card to the float64 reference."""
import warnings

import pytest
import torch

import viabel_tpu_torch as vt
from viabel_tpu_torch import optimizers
from viabel_tpu_torch.objectives import map_draws

from portbench import correct, run
from portbench.faults import unchanged_step
from portbench.run import Cell, load_json

from .cpu_sizes import manifest

CELL = 'es_cp_chivi_fit'
# its own small sizes, at the configuration's n_mc 500: a step without
# the log-norm reads W2 0.070 at 400 iterations, 1.25x the cell's limit,
# and 0.105 at 1000 (0.25-0.90 at full size on the card)
SMALL = dict(n_iters=1000, n_bound_samples=20000)


@pytest.fixture(autouse=True)
def quiet():
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        yield


def _run_small(seed=2 ** 31 + 12345):
    return run.run(manifest(), CELL, seed, 0.2, 0, device='cpu',
                   overrides=SMALL)


def half_chivi(monkeypatch):
    """CHIVI over the first half of its draws."""
    full_chivi = vt.black_box_chivi

    def half(alpha, fam, model, n_mc, presampled=False):
        full = full_chivi(alpha, fam, model, n_mc, presampled)

        def objective(p, draws):
            return full(p, map_draws(lambda v: v.narrow(-2, 0, n_mc // 2),
                                     draws))

        objective.__dict__.update(full.__dict__)
        return objective

    monkeypatch.setattr(vt, 'black_box_chivi', half)


def log_norm_dropped(monkeypatch):
    """The step given no log-norm, as a KLVI objective gives it."""
    step = optimizers.adagrad_step
    monkeypatch.setattr(optimizers, 'adagrad_step',
                        lambda state, grad, value, log_norm:
                        step(state, grad, value, None))


FAULTS = {'unchanged_step': lambda mp: unchanged_step(mp, CELL),
          'half_chivi': half_chivi, 'log_norm_dropped': log_norm_dropped}


def test_whole_run_on_the_cpu():
    result = _run_small()
    assert result['correct'], result['checks']
    assert result['attempted'] >= 1 and result['failed'] == 0
    assert set(result['metrics']) == {'setup_s', 'fit_s'}


def test_control_fails():
    c = Cell(manifest(), CELL, 'cpu', SMALL)
    assert c.cfg['control'] == 'bfloat16'
    pairs = c.loop.control_pairs(c.reference('bfloat16'), c.reference(), 5)
    limits = load_json('limits', CELL + '.json')
    ok, checks = correct.judge(correct.worst(pairs, limits), limits)
    assert not ok, checks


@pytest.mark.parametrize('fault', sorted(FAULTS))
def test_fault_fails(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    result = _run_small()
    assert result['correct'] is False, result['checks']


@pytest.mark.cuda
def test_float32_fit_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    c = Cell(manifest(), CELL, 'cuda', dict(n_iters=2000,
                                             n_bound_samples=250000))
    seed = 2 ** 32 + 99
    out = c.loop.call(seed)
    pairs = list(zip(out, c.loop.check(c.reference(), seed, out)))
    limits = load_json('limits', CELL + '.json')
    ok, checks = correct.judge(correct.worst(pairs, limits), limits)
    assert ok, checks
