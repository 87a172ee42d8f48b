"""K1's share of its roofline: the least time its bytes take at the
card's peak bandwidth (`roofline.counts.k1_bytes` at the pass's n and d,
the schools' y and sigma staged), over its mean duration in the trace
(kernel ``score_partials_kernel``)."""
from portbench.roofline import counts, peaks


def read(ctx):
    bw = peaks.peak(ctx.kind, 'bytes_per_s')
    t = ctx.trace.mean_kernel_s('score_partials_kernel')
    if not bw or not t:
        return None
    nbytes = counts.k1_bytes(ctx.cfg['n_bound_samples'], ctx.cfg['dim'],
                             2 * ctx.cfg['schools'])
    return 100.0 * nbytes / bw / t
