"""Device milliseconds of the base draws a pass: the kernels that ran
inside the harness's ``draw`` spans (`fam.base_sample`), per span."""


def read(ctx):
    s, n = ctx.trace.device_s_in_spans('draw')
    return 1e3 * s / n if n and s else None
