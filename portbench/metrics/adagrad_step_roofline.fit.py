"""The adagrad step kernel's share of its roofline: the least time its
bytes take at the card's peak bandwidth (one run of the configuration's
P parameters, no history), over its mean duration in the traced fit."""
from portbench.roofline import counts, peaks


def read(ctx):
    bw = peaks.peak(ctx.kind, 'bytes_per_s')
    t = ctx.trace.mean_kernel_s('adagrad_step_kernel')
    if not bw or not t:
        return None
    nbytes = counts.adagrad_step_bytes(1, counts.param_count(ctx.cfg),
                                       ctx.cfg['window'])
    return 100.0 * nbytes / bw / t
