"""Device resolution and the fp32 matmul policy.

Entry points of the package take ``device=None`` and resolve it here:
``None`` means the CUDA card, and a machine without one raises instead of
quietly running on the CPU.  Tests and small CPU runs pass
``device='cpu'`` explicitly.

fp32 matmul policy: every product in the package runs in full float32 (or
float64).  TF32 keeps about three decimal digits, and reduced-precision
products measurably move converged optima (the JAX package pins
``precision=HIGHEST`` for the same reason: viabel_tpu/families.py:89-99).
`resolve_device` applies the policy whenever it hands out a CUDA device,
so `weighted_moments`, `central_moments` and the covariance products never
run in TF32.

`pick_driver` states how a loop body runs (captured in a CUDA graph and
replayed, or eagerly); `capture` is the package's one way to capture a body
and `replay` its one way to replay one, counting the kernel launches that
the capture recorded (`ops._launch`); `between_captures` keeps other
threads' device work away from a capture.
"""
import contextlib
import threading

import torch

from ._trace import span
from .ops._launch import launches, recording, replayed

__all__ = ['resolve_device', 'fp32_matmul_policy', 'default_generator',
           'pick_driver', 'capture', 'replay', 'between_captures']

# A CUDA graph capture in PyTorch's default ("global") mode fails if any
# thread of the process makes an unsafe CUDA call (an allocation, a
# synchronization) while it is underway.  That hazard is process-wide, so
# the lock is too: every capture of the package goes through `capture`,
# which holds it from ``capture_begin`` to ``capture_end``, and code that
# runs device work on other threads beside one that captures (the HTTP
# service's readers, `serve.PosteriorService`) holds it around that work
# (`between_captures`), so it waits at most one capture, never a whole run.
_capture_lock = threading.Lock()
# the counters of the `utils.count_compilations` blocks now running; each
# capture adds one to every one
_capture_counters = []


def capture(body, stream):
    """``body()`` captured on `stream` as a `torch.cuda.CUDAGraph`, under
    the process-wide capture lock; the graph carries the kernel launches
    the capture recorded (``graph.launches``).  A failed capture raises."""
    graph = torch.cuda.CUDAGraph()
    with span('capture'), torch.cuda.stream(stream), _capture_lock, \
            recording() as record:
        graph.capture_begin()
        try:
            body()
        finally:
            graph.capture_end()
    graph.launches = record
    for counter in _capture_counters:
        counter[0] += 1
    return graph


def replay(graph):
    """Replay a graph that `capture` made on the current stream, and count
    the kernel launches it recorded."""
    graph.replay()
    for name, n in graph.launches.items():
        launches[name] += n
        replayed[name] += n


@contextlib.contextmanager
def between_captures():
    """Hold off every capture of the process while the block runs."""
    with _capture_lock:
        yield


def on_device(device):
    """The context of work on `device`: that card current, or nothing for
    the CPU."""
    if device.type == 'cuda':
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def fp32_matmul_policy():
    """Forbid TF32 in matrix products and convolutions (process-wide)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision('highest')


def resolve_device(device=None):
    """``None`` -> the CUDA card (raises without one); else ``device``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'no CUDA device is available; pass device="cpu" to run on '
                'the CPU')
        device = 'cuda'
    device = torch.device(device)
    if device.type == 'cuda':
        fp32_matmul_policy()
    return device


def default_generator(device, seed=0):
    """A seeded `torch.Generator` on ``device`` (the counterpart of the
    JAX package's default ``PRNGKey(0)``)."""
    return torch.Generator(device=device).manual_seed(seed)


def pick_driver(driver, device, host_callback, presampled=True):
    """How a loop body runs: ``'graph'`` (captured once in a CUDA graph and
    replayed) or ``'eager'``.

    The rule: the graph on the card for a body whose draws are made before
    the loop (`presampled`) and that calls no host-side log density
    (`host_callback`, `models.external`), whose round trip to the host
    cannot be captured; eagerly otherwise, and always on the CPU.
    `driver` names one instead (to compare the two); asking for the graph
    where the rule forbids it raises, so a body is never quietly run
    another way than the one asked for."""
    if driver not in (None, 'eager', 'graph'):
        raise ValueError('driver must be None, "eager" or "graph"')
    capturable = (presampled and not host_callback
                  and torch.device(device).type == 'cuda')
    if driver is None:
        return 'graph' if capturable else 'eager'
    if driver == 'graph' and not capturable:
        if host_callback:
            raise ValueError(
                'a host-side log density (host_callback) cannot be captured '
                'in a CUDA graph: its round trip to the host leaves the '
                'card; use the eager driver')
        raise ValueError('the graph driver runs presampled objectives on the '
                         'card only')
    return driver
