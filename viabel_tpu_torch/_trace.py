"""Profiler spans around the phases of the program.

``span(name, device)`` marks a phase (a fit, its presampled draws, the
optimizer, a bound pass, PSIS, the host's bound algebra) in a
`torch.profiler` trace as a ``vt.<name>`` annotation, which the profiler
puts on the host clock its device records are converted to.  Given a
CUDA `device`, the span ends in a synchronize of it, so the device work
the phase launched ran inside it.

While no profiler records, a span is one shared null context: it makes
no annotation and never synchronizes, so an untraced run does exactly
what it would do without it (a check of one flag, well under a
microsecond, where an ungated ``record_function`` costs about ten).
Spans mark phases, never an optimizer iteration, a graph replay or a
chain transition, and none with a device opens inside a CUDA graph
capture, where a synchronize is not allowed.

`to_host` is every device-to-host read of the fit and validation paths,
each in a ``vt.sync`` span: the number of such spans in a trace counts
the host's round trips to the device.
"""
import contextlib

import torch

__all__ = ['span', 'to_host']

PREFIX = 'vt.'
_OFF = contextlib.nullcontext()


class _Span:
    """A ``vt.`` annotation, ended by a synchronize of a CUDA device."""

    def __init__(self, name, device):
        self.device = device
        self.rf = torch.profiler.record_function(PREFIX + name)

    def __enter__(self):
        self.rf.__enter__()

    def __exit__(self, *exc):
        if self.device is not None and self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        self.rf.__exit__(*exc)


def span(name, device=None):
    """The span ``vt.<name>`` of a phase while a profiler records, ended
    by a synchronize of `device` where it is a CUDA device; otherwise a
    shared null context."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name, None if device is None else torch.device(device))


def to_host(tensor):
    """``tensor.cpu()``, a read that waits for the device, in a
    ``vt.sync`` span."""
    with span('sync'):
        return tensor.cpu()
