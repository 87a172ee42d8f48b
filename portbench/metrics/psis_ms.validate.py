"""Wall milliseconds of the harness's ``psis`` span (`psislw` then
`weighted_moments`, ended by a synchronize), the mean over the traced
passes."""


def read(ctx):
    walls = ctx.trace.span_walls('psis')
    return 1e3 * sum(walls) / len(walls) if walls else None
