"""Device microseconds an optimizer iteration: the time of the device
operations that started inside the program's ``vt.optimize`` spans
(`optimizers._advance`: the warm-up, the capture and the replays, closed
after the check of the run's counter and a synchronize), over the traced
slice's iterations.  In a batch an iteration is one of all its runs.
None where the program has no such span."""


def read(ctx):
    s, n = ctx.trace.device_s_in_spans('vt.optimize')
    return 1e6 * s / ctx.iters if n and s and ctx.iters else None
