"""The whole validation pass's share of the card's float32 peak: the
pass's products (`roofline.counts.validation_pass_flops`) over the
window's wall seconds a pass."""
from portbench.roofline import counts, peaks


def read(ctx):
    peak = peaks.peak(ctx.kind, 'f32_flops')
    if not peak:
        return None
    flops = counts.validation_pass_flops(ctx.cfg['n_bound_samples'],
                                         ctx.cfg['dim'])
    return 100.0 * flops / (ctx.e2e['validate_ms'] / 1e3 * peak)
