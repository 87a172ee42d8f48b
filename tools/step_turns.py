#!/usr/bin/env python3
"""Time the adagrad step kernel (`adagrad_step`) of several checkouts of
this repository in turns, on one card.

    python3 tools/step_turns.py ROOT [ROOT ...]

Each ROOT is a checkout (for example the parent commit unpacked by
``git archive`` into a git-ignored directory, and ``.``).  The CUDA
library ``csrc/adagrad.cu`` of every ROOT is built first, all at once;
then each ROOT, in its own process, in the order given and again in
reverse (parent, change, change, parent for two), times its step kernel
in float32 with the ring full, the history kept and the tail summed (the
most a step does), two ways: the kernel's own duration on the card with
L2 flushed before each launch by writing 256 MB (``chip_smoke.device_ms``,
mean of 10 launches), and as the optimizer finds it, hot in L2 inside a
replayed CUDA graph of 20 steps (``chip_smoke.graph_device_ms``, 10
replays).  The shapes: one run at P = 20 (eight-schools' mean-field
parameter), P = 5150 and P = 45450 (full-rank d = 100 and d = 300
families), and, where the checkout's step takes a batch of runs, 16 runs
at P = 4 (robust regression's mean-field starts).  Where the checkout
has it, the empty kernel of its step library (``ops.adagrad.launch_floor``)
is timed the same two ways at each shape.  Prints the card's name and
power limit.  Needs a CUDA device; imports nothing of JAX.
"""
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WINDOW, N_TABLE = 10, 4096
SHAPES = ((1, 20), (1, 5150), (1, 45450), (16, 4))  # (runs K, params P)


def child(root, build_only):
    """In a process of its own: `root`'s step kernel, built and timed."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from viabel_tpu_torch.ops import _build
    from viabel_tpu_torch.ops import adagrad as aops
    spec = importlib.util.spec_from_file_location(
        'smoke', os.path.join(HERE, 'chip_smoke.py'))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    if build_only:  # the build steps of _build.load, keeping nvcc's output
        started = _build._start('adagrad')
        if started is not None:
            smoke.log('{}:'.format(root))
            smoke.log_ptxas(_build._finish('adagrad', started))
        return 0
    out = {}
    for K, P in SHAPES:
        batch = (K,) if K > 1 else ()
        grad = torch.randn(batch + (P,), device='cuda')
        value, log_norm = torch.randn(batch, device='cuda'), \
            torch.zeros(batch, device='cuda')
        try:
            state = aops.new_state(
                torch.zeros(batch + (P,), device='cuda'),
                torch.full(batch + (N_TABLE,), 0.01, device='cuda'), WINDOW,
                0.1, True)._replace(tail_start=0)
            state.counter.fill_(WINDOW)
            aops.adagrad_step(state, grad, value, log_norm)
        except (TypeError, ValueError):  # a step that takes one run only
            out['K {} P {}'.format(K, P)] = None
            continue

        def step():
            aops.adagrad_step(state, grad, value, log_norm)

        times = {}
        state.counter.fill_(WINDOW)
        times['L2 flushed'] = smoke.device_ms(step, 'adagrad_step_kernel')
        state.counter.fill_(WINDOW)
        times['in a graph'] = smoke.graph_device_ms(step,
                                                    'adagrad_step_kernel')
        if hasattr(aops, 'launch_floor'):
            shape = aops.launch_shape(K, P, WINDOW, torch.float32)
            times['shape'] = shape.describe()
            times['floor, L2 flushed'] = smoke.device_ms(
                lambda: aops.launch_floor(shape), smoke.FLOOR_KEY)
            times['floor, in a graph'] = smoke.graph_device_ms(
                lambda: aops.launch_floor(shape), smoke.FLOOR_KEY)
        if int(state.counter.max()) >= N_TABLE:
            raise AssertionError('the timings ran past the table')
        out['K {} P {}'.format(K, P)] = times
    print(json.dumps({'root': root, 'device_ms': out}), flush=True)
    return 0


def main(roots):
    if '--child' in roots or '--build' in roots:
        return child(roots[-1], '--build' in roots)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from k3_turns import turns
    return turns(os.path.abspath(__file__), roots)


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
