"""Kernel records in the traced fit, over its optimizer iterations: the
replayed graph's kernels an iteration, the warm-up, the capture and the
bound pass spread over them.  A count that repeats exactly."""


def read(ctx):
    n = len(ctx.trace.kernels())
    return n / ctx.iters if n and ctx.iters else None
