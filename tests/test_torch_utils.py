"""The port's `utils` (timers and metrics) against viabel_tpu.utils.

`format_seconds` and the printed lines are the JAX package's text;
`ThroughputMeter` is held as tests/test_extras.py holds the JAX one.  The
trace reader is held on a synthetic Chrome trace (kernel records summed,
nothing else) and on a real CPU trace (no kernel records: 0.0), and
`count_compilations` on a CPU fit (no capture) and on `_device.capture`
with a stand-in graph class (a CUDA graph needs a card).
"""
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import viabel_tpu.utils as jutils
import viabel_tpu_torch as pt
import viabel_tpu_torch.utils as tutils
from viabel_tpu_torch import _device

pytestmark = pytest.mark.filterwarnings(
    'ignore::viabel_tpu_torch.bounds.MonteCarloErrorWarning')

def test_all_matches_jax():
    assert tutils.__all__ == jutils.__all__


@pytest.mark.parametrize('secs', np.logspace(-7, 3, 41).tolist()
                         + [0.0, 9.99e-4, 1e-3, 0.9999, 1.0])
def test_format_seconds_matches_jax(secs):
    assert tutils.format_seconds(secs) == jutils.format_seconds(secs)


LINE = re.compile(r'^fit took \d+\.\d{3} (microsec|millisec|sec) to run\n$')


def test_timer_prints_the_jax_line(capsys):
    with jutils.Timer('fit', sync=lambda: jnp.ones(3)):
        pass
    want = capsys.readouterr().out
    out = {}
    with tutils.Timer('fit', sync=lambda: {'a': [torch.ones(3)]}) as t:
        out['x'] = torch.ones(4).sum()
    got = capsys.readouterr().out
    assert LINE.match(want) and LINE.match(got), (want, got)
    assert t.interval >= 0 and t.end >= t.start
    with tutils.Timer() as quiet:
        pass
    assert capsys.readouterr().out == '' and quiet.interval >= 0


def test_throughput_meter():
    """tests/test_extras.py:312-320, on the port's meter."""
    meter = tutils.ThroughputMeter(reps=2)
    out, rec = meter.measure('double', lambda x: x * 2.0, torch.ones(16),
                             iters=100, evals_per_iter=10, samples=1000)
    assert torch.equal(out, torch.full((16,), 2.0))
    assert rec['it_per_s'] > 0 and rec['samples_per_s'] > 0
    np.testing.assert_allclose(rec['evals_per_s'], rec['it_per_s'] * 10,
                               rtol=1e-9)
    assert 'double' in meter.report()
    jmeter = jutils.ThroughputMeter(reps=2)
    jmeter.measure('double', jax.jit(lambda x: x * 2.0), jnp.ones(16),
                   iters=100, evals_per_iter=10, samples=1000)
    assert set(jmeter.records['double']) == set(rec)
    assert (re.sub(r'[0-9.e+-]+', 'N', meter.report())
            == re.sub(r'[0-9.e+-]+', 'N', jmeter.report()))


def _write_trace(path, events):
    with open(path, 'w') as f:
        json.dump({'traceEvents': events}, f)


def test_trace_device_time_sums_kernel_records_only(tmp_path):
    assert tutils.trace_device_time(str(tmp_path)) is None
    events = [
        {'ph': 'X', 'cat': 'kernel', 'name': 'k1', 'dur': 75.5},
        {'ph': 'X', 'cat': 'kernel', 'name': 'combine', 'dur': 4.0},
        {'ph': 'X', 'cat': 'Kernel', 'name': 'older torch', 'dur': 0.5},
        {'ph': 'X', 'cat': 'cpu_op', 'name': 'aten::add', 'dur': 1e6},
        {'ph': 'X', 'cat': 'cuda_runtime', 'name': 'cudaLaunchKernel',
         'dur': 1e5},
        {'ph': 'X', 'cat': 'gpu_memcpy', 'name': 'Memcpy DtoH', 'dur': 1e4},
        {'ph': 'i', 'cat': 'kernel', 'name': 'instant', 'dur': 1e3},
        {'ph': 'M', 'name': 'process_name', 'args': {'name': 'GPU 0'}},
    ]
    _write_trace(str(tmp_path / 'trace_1.pt.trace.json'), events)
    assert tutils.trace_device_time(str(tmp_path)) == pytest.approx(80e-6)
    # the newest trace is read; other files are not traces
    import os
    import time
    later = str(tmp_path / 'trace_2.pt.trace.json')
    _write_trace(later, events[3:])
    stamp = time.time() + 10
    os.utime(later, (stamp, stamp))
    (tmp_path / 'notes.json').write_text('{"traceEvents": []}')
    assert tutils.trace_device_time(str(tmp_path)) == 0.0


def test_trace_device_time_of_a_cpu_profile_is_zero(tmp_path):
    """A CPU run's trace holds CPU operators and no kernel records."""
    log_dir = str(tmp_path / 'trace')
    with tutils.profile_trace(log_dir):
        x = torch.randn(256, 256, dtype=torch.float64)
        (x @ x).sum()
    assert tutils.trace_device_time(log_dir) == 0.0
    with tutils.profile_trace(log_dir):
        pass
    import glob
    assert len(glob.glob(log_dir + '/*.pt.trace.json')) == 2


class _StubGraph:
    def capture_begin(self):
        pass

    def capture_end(self):
        pass


def test_count_compilations_counts_captures(monkeypatch):
    model = pt.models.funnel_model()
    fam = pt.mean_field_t_variational_family(2, 40)
    with tutils.count_compilations() as n:
        pt.validated_vi(model, fam, torch.zeros(4, dtype=torch.float64), 30,
                        n_mc_samples=10, n_bound_samples=2000,
                        device='cpu')
    assert n[0] == 0  # the CPU runs eagerly: nothing is captured
    monkeypatch.setattr(torch.cuda, 'CUDAGraph', _StubGraph)
    ran = []
    with tutils.count_compilations() as outer:
        _device.capture(lambda: ran.append(1), None)
        with tutils.count_compilations() as inner:
            _device.capture(lambda: ran.append(2), None)
            assert inner[0] == 1 and outer[0] == 2
        assert _device._capture_counters == [outer]
    _device.capture(lambda: ran.append(3), None)
    assert ran == [1, 2, 3] and (outer[0], inner[0]) == (2, 1)
    assert _device._capture_counters == []
    # a failed capture counts nothing and leaves no counter behind
    with pytest.raises(ZeroDivisionError):
        with tutils.count_compilations() as failed:
            _device.capture(lambda: 1 / 0, None)
    assert failed[0] == 0 and _device._capture_counters == []
