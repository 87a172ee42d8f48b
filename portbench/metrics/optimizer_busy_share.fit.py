"""The share of an untraced fit's wall time that the optimizer's device
work fills: the device time an iteration inside the program's
``vt.optimize`` spans (the traced slice's; the profiler slows the host,
not the kernels), times the configuration's iterations, over the
window's seconds a fit (a batch: ``fit_s`` times its starts).  The
counterpart of ``device_idle_share.fit``, whose traced window the
profiler stretches.  None where the program has no such span."""


def read(ctx):
    s, n = ctx.trace.device_s_in_spans('vt.optimize')
    if not (n and s and ctx.iters):
        return None
    fit_wall = ctx.e2e['fit_s'] * ctx.mix.get('n_starts', 1)
    return 100.0 * s / ctx.iters * ctx.cfg['n_iters'] / fit_wall
