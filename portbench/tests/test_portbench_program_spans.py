"""The readers of the program's own spans (``vt.*``) on synthetic traces,
built as test_portbench_trace.py builds them, and the readers of the
harness's spans, which must read the same values where program spans
nest inside theirs."""
from types import SimpleNamespace

import pytest

from portbench.run import load_module
from portbench.trace import Record, Trace

US = 1000


def _read(metric, trace, **ctx):
    return load_module('metrics', metric + '.py').read(
        SimpleNamespace(trace=trace, **ctx))


def _pass(t0, program):
    """One validation pass from `t0` (us): the harness's spans, and with
    `program` the program's spans and host records inside them."""
    recs = [
        Record('draw', 'user_annotation', t0 * US, (t0 + 10) * US),
        Record('void philox_kernel(float*)', 'kernel', (t0 + 1) * US,
               (t0 + 7) * US),
        Record('score', 'user_annotation', (t0 + 10) * US, (t0 + 20) * US),
        Record('bounds', 'user_annotation', (t0 + 20) * US, (t0 + 30) * US),
        Record('psis', 'user_annotation', (t0 + 30) * US, (t0 + 60) * US),
        Record('cudaLaunchKernel', 'cuda_runtime', (t0 + 30) * US + 200,
               (t0 + 30) * US + 500),
    ]
    if program:
        recs += [
            Record('vt.bound_pass', 'user_annotation', (t0 + 11) * US,
                   (t0 + 19) * US),
            Record('vt.host_bounds', 'user_annotation', (t0 + 21) * US,
                   (t0 + 29) * US),
            Record('vt.sync', 'user_annotation', (t0 + 22) * US,
                   (t0 + 23) * US),
            # PSIS: three launches, a copy and a fill; a runtime call that
            # puts nothing on the device and an operator do not count
            Record('vt.psis', 'user_annotation', (t0 + 31) * US,
                   (t0 + 45) * US),
            Record('cudaLaunchKernelExC', 'cuda_runtime', (t0 + 33) * US,
                   (t0 + 34) * US),
            Record('cudaMemcpyAsync', 'cuda_runtime', (t0 + 35) * US,
                   (t0 + 36) * US),
            Record('cuLaunchKernel', 'cuda_driver', (t0 + 37) * US,
                   (t0 + 38) * US),
            Record('cudaStreamSynchronize', 'cuda_runtime', (t0 + 39) * US,
                   (t0 + 44) * US),
            Record('aten::topk', 'cpu_op', (t0 + 40) * US, (t0 + 41) * US),
            Record('vt.moments', 'user_annotation', (t0 + 46) * US,
                   (t0 + 55) * US),
            Record('cudaMemsetAsync', 'cuda_runtime', (t0 + 47) * US,
                   (t0 + 48) * US),
            # filed with the operators where the profiler's events carry
            # no activity type
            Record('cudaLaunchKernel', 'cpu_op', (t0 + 49) * US,
                   (t0 + 50) * US),
        ]
    return recs


def _validate_trace(program, passes=2):
    recs = [Record('slice', 'user_annotation', 0, 100 * passes * US)]
    for i in range(passes):
        recs += _pass(100 * i, program)
    # a launch between passes, outside every span
    recs.append(Record('cudaLaunchKernel', 'cuda_runtime', 70 * US,
                       71 * US))
    return Trace(recs)


def test_harness_readers_read_the_same_with_program_spans():
    for metric in ('psis_ms.validate', 'bounds_ms.validate',
                   'draw_ms.validate'):
        bare = _read(metric, _validate_trace(False))
        nested = _read(metric, _validate_trace(True))
        assert bare is not None and nested == bare, metric
    assert _read('psis_ms.validate', _validate_trace(True)) == \
        pytest.approx(0.030)
    assert _read('draw_ms.validate', _validate_trace(True)) == \
        pytest.approx(0.006)


def test_psis_launches():
    # a pass: the harness's launch before vt.psis opens does not count;
    # inside: ExC, the copy, the driver's launch, the fill, a launch
    assert _read('psis_launches.validate', _validate_trace(True)) == 5.0
    assert _read('psis_launches.validate',
                 _validate_trace(True, passes=3)) == 5.0
    assert _read('psis_launches.validate', _validate_trace(False)) is None
    bare = [r for r in _validate_trace(True).spans]
    no_calls = Trace([Record('slice', 'user_annotation', 0, 10 ** 6)]
                     + bare)
    assert _read('psis_launches.validate', no_calls) is None


def _fit_trace(program, iters=4, kernel_us=3, gap_us=2):
    """A traced fit slice: draws, then `iters` iterations of one kernel
    each, then a bound pass; the optimizer's kernels inside ``vt.optimize``
    with the program's spans."""
    t, recs = 0, []
    recs.append(Record('void philox_kernel(float*)', 'kernel', 1 * US,
                       9 * US))
    t = 10
    opt_start = t
    for _ in range(iters):
        recs.append(Record('void adagrad_step_kernel<float>(float*)',
                           'kernel', t * US, (t + kernel_us) * US))
        t += kernel_us + gap_us
    opt_end = t
    recs.append(Record('void score_partials_kernel(float*)', 'kernel',
                       (t + 5) * US, (t + 15) * US))
    end = t + 20
    recs.append(Record('slice', 'user_annotation', 0, end * US))
    if program:
        recs += [Record('vt.fit', 'user_annotation', 0, end * US),
                 Record('vt.draws', 'user_annotation', 0, 10 * US),
                 Record('vt.optimize', 'user_annotation', opt_start * US,
                        opt_end * US),
                 Record('vt.replay', 'user_annotation', (opt_start + 5) * US,
                        (opt_end - 3) * US)]
    return Trace(recs)


def test_optimizer_device_us():
    ctx = dict(iters=4)
    assert _read('optimizer_device_us.fit', _fit_trace(True), **ctx) == \
        pytest.approx(3.0)
    assert _read('optimizer_device_us.fit', _fit_trace(False),
                 **ctx) is None
    # kernels_per_iter.fit reads every kernel whether or not spans are there
    assert _read('kernels_per_iter.fit', _fit_trace(True), **ctx) == \
        _read('kernels_per_iter.fit', _fit_trace(False), **ctx) == 1.5


@pytest.mark.parametrize('n_starts', [None, 8])
def test_optimizer_busy_share(n_starts):
    # 3 us a traced iteration; an untraced fit of 1000 iterations took
    # 4 ms (a batch of 8: 0.5 ms a start), so the optimizer filled 75 %
    mix = {} if n_starts is None else dict(n_starts=n_starts)
    fit_s = 4e-3 / (n_starts or 1)
    ctx = dict(iters=4, cfg=dict(n_iters=1000), mix=mix,
               e2e=dict(fit_s=fit_s))
    assert _read('optimizer_busy_share.fit', _fit_trace(True), **ctx) == \
        pytest.approx(75.0)
    assert _read('optimizer_busy_share.fit', _fit_trace(False),
                 **ctx) is None
