"""The whole validated fit's share of the card's float32 peak (the port
runs its products in full float32): the products the fit needs
(`roofline.counts`) over the window's wall seconds a fit."""
from portbench.roofline import counts, peaks


def read(ctx):
    peak = peaks.peak(ctx.kind, 'f32_flops')
    cfg = ctx.cfg
    if not peak or cfg['family'] != 'full_rank_gaussian' \
            or cfg['model'] != 'linear_regression':
        return None
    flops = counts.full_rank_regression_fit_flops(
        cfg['n_rows'], cfg['dim'], cfg['n_mc'], cfg['n_iters'],
        cfg['n_bound_samples'])
    return 100.0 * flops / (ctx.e2e['fit_s'] * peak)
