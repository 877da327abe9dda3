"""Share (%) of the profiled unit in which no operation ran on the device (layer: device).

The device's busy time comes from the profiled unit's trace; the wall is
the same unit's untraced wall in the window, since the profiler stretches
the host's side of a unit (its traced wall is on the run's earlier line).
"""


def read(ctx):
    u = ctx.unit
    if not u or not u.get("untraced_wall_s"):
        return None
    return 100.0 * (1.0 - u["busy_s"] / u["untraced_wall_s"])
