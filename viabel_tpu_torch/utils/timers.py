"""Wall-clock timing (PyTorch port of viabel_tpu/utils/timers.py).

CUDA calls return before the card has done the work, so `Timer` can wait
for the devices of the tensors a callable returns before it reads the
clock.
"""
from time import perf_counter

import torch

__all__ = ['Timer', 'format_seconds']


def format_seconds(secs):
    """Human format for seconds (viabel_tpu/utils/timers.py:14-22)."""
    if secs < 1e-3:
        t, u = secs * 1e6, 'microsec'
    elif secs < 1e0:
        t, u = secs * 1e3, 'millisec'
    else:
        t, u = secs, 'sec'
    return '{:.03f} {}'.format(t, u)


def synchronize(tree):
    """Wait for the CUDA devices of the tensors in `tree` (a tensor, or a
    list, tuple or dict of them, nested); CPU tensors need nothing."""
    devices = set()

    def visit(node):
        if isinstance(node, torch.Tensor):
            if node.is_cuda:
                devices.add(node.device)
        elif isinstance(node, dict):
            for v in node.values():
                visit(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                visit(v)

    visit(tree)
    for device in devices:
        torch.cuda.synchronize(device)


class Timer:
    """Context manager measuring wall-clock time
    (viabel_tpu/utils/timers.py:25-59).

    Parameters
    ----------
    descr : str, optional
        If given, ``'<descr> took <time> to run'`` is printed on exit.
    sync : callable, optional
        Returns tensors (a tensor, or a list, tuple or dict of them) whose
        CUDA devices are synchronized on exit, before the clock is read,
        so that the interval holds the card's work.
    """

    def __init__(self, descr=None, sync=None):
        self.description = descr
        self._sync = sync
        self.interval = None

    def __enter__(self):
        self.start = perf_counter()
        return self

    def __exit__(self, *args):
        if self._sync is not None:
            synchronize(self._sync())
        self.end = perf_counter()
        self.interval = self.end - self.start
        if self.description is not None:
            print('{} took {} to run'.format(self.description,
                                             format_seconds(self.interval)))
