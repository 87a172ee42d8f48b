"""The one launch path of the port's hand-written kernels (`ops._launch`),
on the CPU: a stand-in library in place of a built one, and stand-ins for
the CUDA calls around a launch, capture and replay."""
import contextlib
import ctypes
import types

import pytest
import torch

import viabel_tpu_torch  # noqa: F401  (declares every library)
from viabel_tpu_torch import _device
from viabel_tpu_torch.ops import _launch

ENTRY_POINTS = ('transform_score_partials', 'lw_partials',
                'combine_partials', 'gaussian_sample_score_partials',
                'philox_normal', 'adagrad_step', 'klvi_mf', 'chivi_mf',
                't_from_uniforms')


class _Fn:
    """A C entry point that returns `rc` and keeps its calls."""

    def __init__(self, rc=0):
        self.rc, self.calls = rc, []
        self.argtypes = self.restype = None

    def __call__(self, *args):
        self.calls.append(args)
        return self.rc


class _Device(contextlib.nullcontext):
    """``torch.cuda.device`` on no device."""


class _Graph:
    def capture_begin(self):
        pass

    def capture_end(self):
        pass

    def replay(self):
        self.replays = getattr(self, 'replays', 0) + 1


@pytest.fixture
def stub(monkeypatch):
    """``(make, capturing)``: ``make(rc)`` declares a stand-in library of
    one entry point ``stub_kernel`` (and a helper ``stub_helper``), whose
    functions return `rc`; ``capturing[0]`` is what the stream reports."""
    capturing = [False]
    loads, checks = [], []
    monkeypatch.setattr(torch.cuda, 'device', _Device)
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=77))
    monkeypatch.setattr(torch.cuda, 'is_current_stream_capturing',
                        lambda: capturing[0])
    monkeypatch.setattr(torch.cuda, 'CUDAGraph', _Graph)

    def make(rc=0):
        lib = types.SimpleNamespace(stub_kernel_f32=_Fn(rc),
                                    stub_kernel_f64=_Fn(rc),
                                    stub_helper=_Fn(rc))

        def load(source):
            loads.append(source)
            return lib

        monkeypatch.setattr(_launch._build, 'load', load)
        library = _launch.Library(
            'stub', {'stub_kernel': [ctypes.c_int]},
            helpers={'stub_helper': [ctypes.c_double]},
            check=lambda lib, source: checks.append((lib, source)))
        return library, lib, loads, checks

    yield make, capturing
    for counts in (_launch.launches, _launch.replayed):
        counts.pop('stub_kernel', None)


def test_registry_holds_every_entry_point():
    assert set(ENTRY_POINTS) <= set(_launch.launches)
    assert set(ENTRY_POINTS) <= set(_launch.replayed)


def test_library_declares_each_entry_point_once(stub):
    make, _ = stub
    library, lib, loads, checks = make()
    assert library.lib is lib and library.lib is lib
    assert loads == ['stub'] and checks == [(lib, 'stub')]
    for fn in (lib.stub_kernel_f32, lib.stub_kernel_f64):
        assert fn.argtypes == [ctypes.c_int, ctypes.c_void_p]  # + stream
        assert fn.restype is ctypes.c_int
    assert lib.stub_helper.argtypes == [ctypes.c_double]
    assert lib.stub_helper.restype is ctypes.c_int


def test_launch_counts_outside_a_capture_and_replays_count_the_record(
        stub):
    make, capturing = stub
    library, lib, _, _ = make()
    library.launch('stub_kernel', 'cuda', torch.float64, 5)
    assert lib.stub_kernel_f64.calls == [(5, 77)]
    assert not lib.stub_kernel_f32.calls
    assert (_launch.launches['stub_kernel'],
            _launch.replayed['stub_kernel']) == (1, 0)

    def body():
        capturing[0] = True
        library.launch('stub_kernel', 'cuda', torch.float32, 6)
        library.launch('stub_kernel', 'cuda', torch.float32, 6)
        capturing[0] = False

    graph = _device.capture(body, None)
    assert graph.launches == {'stub_kernel': 2}
    assert _launch.launches['stub_kernel'] == 1   # the capture ran nothing
    _device.replay(graph)
    _device.replay(graph)
    assert graph.replays == 2
    assert (_launch.launches['stub_kernel'],
            _launch.replayed['stub_kernel']) == (5, 4)
    # a capture that launched nothing replays and counts nothing
    _device.replay(_device.capture(lambda: None, None))
    assert _launch.launches['stub_kernel'] == 5
    _launch.reset_launches()
    assert set(_launch.launches.values()) == {0}
    assert set(_launch.replayed.values()) == {0}


def test_refused_launch_raises_and_counts_nothing(stub):
    make, _ = stub
    library, _, _, _ = make(rc=700)
    before = _launch.launches['stub_kernel']
    with pytest.raises(RuntimeError,
                       match=r'^stub_kernel launch failed: CUDA error 700$'):
        library.launch('stub_kernel', 'cuda', torch.float32, 1)
    shape = types.SimpleNamespace(describe=lambda: 'one block a run')
    with pytest.raises(RuntimeError, match=r'^stub_kernel launch \(one '
                       r'block a run\) failed: CUDA error 700$'):
        library.launch('stub_kernel', 'cuda', torch.float64, 1, shape=shape)
    assert _launch.launches['stub_kernel'] == before
