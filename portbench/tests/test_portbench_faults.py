"""The check fails what it must: the control (the reference in the
precision below the configuration's, in the program's place) and a whole
run with the timed path broken underneath (`portbench.faults`), on the
CPU at small sizes.  The readings at the cells' own sizes on the card
come from ``python3 -m portbench.calibrate`` (PERF.md)."""
import warnings

import pytest
import torch

from portbench import correct
from portbench.faults import FAULTS
from portbench.run import Cell, load_json

from .cpu_sizes import SMALL, manifest, run_small


@pytest.fixture(autouse=True)
def quiet():
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        yield


@pytest.mark.parametrize('cell', ['es_cp_fit', 'es_cp_validate',
                                  'es_cp_multistart8'])
def test_control_fails(cell):
    c = Cell(manifest(), cell, 'cpu', SMALL[cell])
    assert c.cfg['control'] == 'bfloat16'
    pairs = c.loop.control_pairs(c.reference('bfloat16'), c.reference(), 5)
    limits = load_json('limits', cell + '.json')
    ok, checks = correct.judge(correct.worst(pairs, limits), limits)
    assert not ok, checks


@pytest.mark.parametrize('fault', sorted(FAULTS))
@pytest.mark.parametrize('cell', sorted(SMALL))
def test_fault_fails(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch, cell)
    result = run_small(cell)
    assert result['correct'] is False, result['checks']


@pytest.mark.cuda
def test_tf32_control_fails_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    cell = 'large_d300_fit'
    c = Cell(manifest(), cell, 'cuda', dict(n_iters=2000,
                                             n_bound_samples=100000))
    assert c.cfg['control'] == 'tf32'
    pairs = c.loop.control_pairs(c.reference('tf32'), c.reference(), 5)
    limits = load_json('limits', cell + '.json')
    ok, checks = correct.judge(correct.worst(pairs, limits), limits)
    assert not ok, checks
