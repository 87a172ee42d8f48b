"""What every loop of calls shares; the loops themselves sit one a file
in ``kinds/<kind>.py``, found by the ``kind`` that a traffic mix
(``traffic/<mix>.json``, the data of the one general generator) names.

A kind's file defines ``Loop``, a subclass of `Loop` here built from the
configuration's program objects and the mix's parameters, and
``end_to_end(times, span, loop)``, the end-to-end values of a window
(the seconds of each call, the seconds from the window's start to the
last call's end) as a dict by metric name; the run reports those of them
that the manifest names for the cell.  A loop gives ``call(seed)``, the
timed call (a fresh generator seeded from the run's seed and the call's
index, its results in the shape `correct` reads), ``check(ref, seed,
out)``, the reference's results of the same call, ``control_pairs(ctl,
ref, seed)``, the control's results beside the reference's, and
``trace_call(seed)``, the traced slice.  Every timed call ends in a
synchronize of the device.
"""
import contextlib
import hashlib
import time

import numpy as np
import torch


def derive(seed, role, index=0):
    """A 63-bit seed for call `index` of `role` in the run of `seed`."""
    h = hashlib.sha256('{}/{}/{}'.format(seed, role, index).encode())
    return int.from_bytes(h.digest()[:8], 'little') >> 1


def sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def summary(param, bounds, khat, mean, cov):
    """One result as `correct` reads it."""
    return dict(param=param, d2=bounds['d2'], W2=bounds['W2'], khat=khat,
                psis_mean=mean, psis_cov=cov)


class Loop:
    """What every kind shares: the configuration's program objects, a
    call by seed, and the spans of a traced call."""
    units = 1          # fits a call completes (starts of a batch)

    def __init__(self, cfg, mix, program, init, device):
        self.cfg, self.mix, self.device = cfg, mix, device
        self.model, self.fam, self.init, self.objective = program
        self.init_host = np.asarray(init, dtype=np.float32)
        self.spans = False

    def generator(self, seed):
        return torch.Generator(device=self.device).manual_seed(seed)

    def span(self, name):
        """A span of the harness around a public call: a profiler
        annotation ended by a synchronize, in a traced slice only."""
        if not self.spans:
            return contextlib.nullcontext()
        return _Span(name, self.device)

    def fit_kwargs(self):
        cfg = self.cfg
        return dict(objective_and_grad=self.objective,
                    n_bound_samples=cfg['n_bound_samples'],
                    window=cfg['window'], learning_rate=cfg['learning_rate'],
                    learning_rate_end=cfg['learning_rate_end'],
                    epsilon=cfg['epsilon'], device=self.device)

    def setup(self, seed):
        """Work the run needs before its first call (none by default)."""

    def trace_call(self, seed):
        """The traced slice: one call of ``trace_iters`` optimizer
        iterations (a whole fit holds more kernel records than the
        profiler's buffers keep); returns the iterations."""
        self.call(seed, self.mix['trace_iters'])
        return self.mix['trace_iters']

    def timed(self, seed):
        t0 = time.perf_counter()
        out = self.call(seed)
        sync(self.device)
        return time.perf_counter() - t0, out


class _Span:
    def __init__(self, name, device):
        self.device = device
        self.rf = torch.profiler.record_function(name)

    def __enter__(self):
        self.rf.__enter__()

    def __exit__(self, *exc):
        sync(self.device)
        self.rf.__exit__(*exc)
