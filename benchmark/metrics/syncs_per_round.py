"""Host syncs of the fused runner per round of a lockstep run (layer: loop control).

`jit_runner.run_counts["syncs"]` over the window, divided by the window's
lockstep runs times the configuration's rounds.
"""


def read(ctx):
    w = ctx.window
    return w["syncs"] / w["rounds"] if w["syncs"] and w["rounds"] else None
