"""The one launch path of the port's hand-written kernels: how a library
of ``csrc/`` is declared, how its kernels are launched and how the
launches are counted.

A `Library` declares its entry points once, from its signature table:
``<name>_f32`` and ``<name>_f64`` take the table's arguments, then the
stream, and return CUDA's error code; its uncounted helpers take theirs.
`Library.launch` runs an entry point on the device's current stream and
raises if CUDA refused it.

``launches[name]`` counts the executions of entry point `name`: one per
launch outside a graph capture.  A launch inside a capture runs nothing;
it goes to the record of the capture now open (`recording`, which
`_device.capture` opens and the graph carries), and each replay of that
graph (`_device.replay`) adds the record to `launches` and to
`replayed`, the part of `launches` that replays ran.
"""
import contextlib
import ctypes

import torch

from . import _build

__all__ = ['SUFFIX', 'Library', 'launches', 'replayed', 'reset_launches',
           'recording']

SUFFIX = {torch.float32: 'f32', torch.float64: 'f64'}

launches = {}
replayed = {}
_record = None  # the launches of the capture now open (captures are serial)


def reset_launches():
    for counts in (launches, replayed):
        for name in counts:
            counts[name] = 0


@contextlib.contextmanager
def recording():
    """Collect the launches made under a capture in a dict it yields."""
    global _record
    _record = record = {}
    try:
        yield record
    finally:
        _record = None


def _declare(fn, argtypes):
    fn.argtypes, fn.restype = argtypes, ctypes.c_int


class Library:
    """``csrc/<source>.cu``: each entry point's arguments before the
    stream (`signatures`), each uncounted helper's arguments (`helpers`)
    and a check of the built library's layout, ``check(lib, source)``."""

    def __init__(self, source, signatures, helpers=None, check=None):
        self.source, self.signatures = source, signatures
        self.helpers, self.check = helpers or {}, check
        self._lib = None
        for name in signatures:
            launches.setdefault(name, 0)
            replayed.setdefault(name, 0)

    @property
    def lib(self):
        """The built library, declared and checked on first use."""
        if self._lib is None:
            lib = _build.load(self.source)
            for name, argtypes in self.signatures.items():
                for suffix in SUFFIX.values():
                    _declare(getattr(lib, name + '_' + suffix),
                             argtypes + [ctypes.c_void_p])  # + the stream
            for name, argtypes in self.helpers.items():
                _declare(getattr(lib, name), argtypes)
            if self.check is not None:
                self.check(lib, self.source)
            self._lib = lib
        return self._lib

    def launch(self, name, device, dtype, *args, shape=None):
        """Run ``<name>_<f32|f64>`` of `dtype` with `args` on `device`'s
        current stream and count it; raise naming the kernel, its launch
        `shape` where given (a `describe()`) and the CUDA error if CUDA
        refused it."""
        fn = getattr(self.lib, name + '_' + SUFFIX[dtype])
        with torch.cuda.device(device):
            rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
            capturing = torch.cuda.is_current_stream_capturing()
        if rc != 0:
            raise RuntimeError('{} launch{} failed: CUDA error {}'.format(
                name, '' if shape is None else
                ' ({})'.format(shape.describe()), rc))
        if not capturing:
            launches[name] += 1
        elif _record is not None:
            _record[name] = _record.get(name, 0) + 1
