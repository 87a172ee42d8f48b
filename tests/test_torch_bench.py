"""The port's benchmark (`viabel_tpu_torch.bench`) on the CPU at small
sizes: one JSON line with bench.py's `metric`, `unit` and `extra` keys
(read from bench.py's own source, which stays as it is) plus ``device``,
every number finite, and ``python -m viabel_tpu_torch bench`` handing
its ``--device`` to it."""
import ast
import json
import math
import os

import pytest

from viabel_tpu_torch import bench
from viabel_tpu_torch.__main__ import main as tmain

pytestmark = pytest.mark.filterwarnings(
    'ignore::viabel_tpu_torch.bounds.MonteCarloErrorWarning')

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_bench_line():
    """The literal dict bench.py prints: its top keys, its `metric` and
    `unit` strings, and the keys of its `extra`."""
    with open(os.path.join(ROOT, 'bench.py')) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, 'attr', None)
                == 'dumps' and isinstance(node.args[0], ast.Dict)):
            line = node.args[0]
            keys = [k.value for k in line.keys]
            values = dict(zip(keys, line.values))
            return (keys, values['metric'].value, values['unit'].value,
                    [k.value for k in values['extra'].keys])
    raise AssertionError('bench.py prints no JSON dict')


def _numbers(value):
    if isinstance(value, list):
        for v in value:
            yield from _numbers(v)
    elif isinstance(value, (int, float)):
        yield value


def test_bench_prints_bench_py_line_on_the_cpu(capsys):
    got = bench.main(device='cpu', n_iters=50, n_bound=20000, n_starts=8,
                     reps=1)
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and json.loads(out[0]) == got
    keys, metric, unit, extra = _jax_bench_line()
    assert list(got) == keys
    assert got['metric'] == metric == bench.METRIC
    assert got['unit'] == unit
    assert list(got['extra']) == extra + ['device']
    assert got['extra']['device'] == 'cpu'
    # the card's kernel time is a device number: not measured on the CPU
    assert got['extra']['draw_score_device_ms'] is None
    values = [got['value'], got['vs_baseline']] + [
        v for k, v in got['extra'].items()
        if k not in ('device', 'draw_score_device_ms')]
    assert len(got['extra']['klvi_evals_per_s_reps']) == 2
    for v in _numbers(values):
        assert math.isfinite(v), got
    assert got['value'] > 0 and got['extra']['chivi_it_per_s'] > 0


def test_cli_bench_passes_its_device(monkeypatch):
    seen = []
    monkeypatch.setattr(bench, 'main', lambda device: seen.append(device))
    tmain(['bench', '--device', 'cpu'])
    assert [str(d) for d in seen] == ['cpu']
