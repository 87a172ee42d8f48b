"""The share of the traced validation passes in which no operation ran
on the device (the passes' spans end in synchronizes, as a validating
user's results do when read)."""


def read(ctx):
    return 100.0 * ctx.trace.idle_share()
