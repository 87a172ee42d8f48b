"""Profiling and throughput metrics (PyTorch port of
viabel_tpu/utils/metrics.py).

`profile_trace` records a `torch.profiler` trace (CPU and, where there is
a card, CUDA activity) and writes it as a Chrome trace; `trace_device_time`
reads the card's kernel time back from it.  `count_compilations` counts
the port's counterpart of a compilation, a CUDA graph capture
(`_device.capture`).
"""
import contextlib
import glob
import json
import os
import time
from time import perf_counter

import torch

from .. import _device
from .timers import synchronize

__all__ = ['profile_trace', 'ThroughputMeter', 'trace_device_time',
           'count_compilations']

_TRACE_SUFFIX = '.pt.trace.json'


@contextlib.contextmanager
def profile_trace(log_dir):
    """Record a `torch.profiler` trace of the enclosed block (CPU activity,
    and CUDA activity where a card is available) and write it under
    `log_dir` as a Chrome trace (viewable in Perfetto), one file a block.
    The card is synchronized before the profiler stops, so the block's
    kernels are in the trace."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield
        finally:
            if cuda:
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, 'trace_{:020d}{}'.format(time.time_ns(), _TRACE_SUFFIX)))


class ThroughputMeter:
    """Measure the steady-state throughput of a computation
    (viabel_tpu/utils/metrics.py:30-73).

    `measure(fn, *args)` runs `fn` once to warm, then `reps` timed runs,
    each waiting for the card (the CUDA devices of the tensors `fn`
    returns), and records the best time.  Counters are derived from the
    supplied work amounts.
    """

    def __init__(self, reps=3):
        self.reps = reps
        self.records = {}

    def measure(self, name, fn, *args, iters=None, evals_per_iter=None,
                samples=None):
        out = fn(*args)
        synchronize(out)
        best = float('inf')
        for _ in range(self.reps):
            t0 = perf_counter()
            out = fn(*args)
            synchronize(out)
            best = min(best, perf_counter() - t0)
        rec = dict(seconds=best)
        if iters is not None:
            rec['it_per_s'] = iters / best
            if evals_per_iter is not None:
                rec['evals_per_s'] = iters * evals_per_iter / best
        if samples is not None:
            rec['samples_per_s'] = samples / best
        self.records[name] = rec
        return out, rec

    def report(self):
        lines = []
        for name, rec in self.records.items():
            parts = ['{:.4g}s'.format(rec['seconds'])]
            for k in ('it_per_s', 'evals_per_s', 'samples_per_s'):
                if k in rec:
                    parts.append('{} = {:.4g}'.format(k, rec[k]))
            lines.append('{}: {}'.format(name, ', '.join(parts)))
        return '\n'.join(lines)


def trace_device_time(log_dir):
    """The card's kernel time (seconds) in the newest `profile_trace`
    under `log_dir`: the durations of the trace's GPU kernel records
    (category ``kernel``) summed, which leaves out the host, the launch
    queue and copies.  Returns None when `log_dir` holds no trace, and 0.0
    for a trace with no kernel records (a CPU run's, or a trace the
    profiler returned without them, which a caller takes again)."""
    paths = glob.glob(os.path.join(log_dir, '*' + _TRACE_SUFFIX))
    if not paths:
        return None
    newest = max(paths, key=lambda p: (os.path.getmtime(p), p))
    with open(newest) as f:
        data = json.load(f)
    events = data.get('traceEvents', []) if isinstance(data, dict) else data
    total_us = sum(e.get('dur', 0) for e in events
                   if e.get('ph') == 'X'
                   and str(e.get('cat', '')).lower() == 'kernel')
    return total_us / 1e6


@contextlib.contextmanager
def count_compilations():
    """Count CUDA graph captures inside the block (yields a one-element
    mutable counter; read ``counter[0]`` after the block).

    A capture is the port's compilation (viabel_tpu/utils/metrics.py:
    109-165 counts XLA's): the adagrad runs on the card and HMC capture
    their loop bodies (every capture of the package goes through
    `_device.capture`) once or twice a run and replay them, and nothing
    is cached across runs::

        with count_compilations() as n:
            validated_vi(model, fam, init, 5000)
        print(n[0])  # the captures of this run's adagrad graphs

    The count is process-wide: it counts the captures of every thread
    while the block runs, and a block nested in another counts its
    captures in both.  On exit the counter stops counting.
    """
    counter = [0]
    _device._capture_counters.append(counter)
    try:
        yield counter
    finally:
        _device._capture_counters[:] = [
            c for c in _device._capture_counters if c is not counter]
