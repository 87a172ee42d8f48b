"""The share of a traced fit in which no operation ran on the device: 1
minus the union of the device operations' intervals over the slice."""


def read(ctx):
    return 100.0 * ctx.trace.idle_share()
