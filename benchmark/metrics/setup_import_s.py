"""Seconds of the port's import, on the harness's own clock (layer: set-up)."""


def read(ctx):
    return ctx.setup["import_s"]
