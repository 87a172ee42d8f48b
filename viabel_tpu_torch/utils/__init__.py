"""Timing and profiling utilities (PyTorch port of viabel_tpu/utils/)."""
from .timers import Timer, format_seconds
from .metrics import (ThroughputMeter, count_compilations,
                      profile_trace, trace_device_time)

__all__ = ['Timer', 'format_seconds', 'ThroughputMeter', 'profile_trace',
           'trace_device_time', 'count_compilations']
