"""Wall milliseconds of the harness's ``bounds`` span (`all_bounds`
with ``q_var`` and the family's closed-form moments), the mean over the
traced passes."""


def read(ctx):
    walls = ctx.trace.span_walls('bounds')
    return 1e3 * sum(walls) / len(walls) if walls else None
