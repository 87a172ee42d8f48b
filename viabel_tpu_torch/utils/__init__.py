"""Timing and profiling utilities (PyTorch port of viabel_tpu/utils/).

`span` is the program's own profiler span (`_trace`), importable from
here to mark a phase of one's own code in a `profile_trace`; it stays out
of ``__all__``, which lists what the JAX package's utilities have."""
from .._trace import span  # noqa: F401
from .timers import Timer, format_seconds
from .metrics import (ThroughputMeter, count_compilations,
                      profile_trace, trace_device_time)

__all__ = ['Timer', 'format_seconds', 'ThroughputMeter', 'profile_trace',
           'trace_device_time', 'count_compilations']
