"""Seconds of the warm-up unit, on the harness's own clock (layer: set-up)."""


def read(ctx):
    return ctx.setup["warm_s"]
