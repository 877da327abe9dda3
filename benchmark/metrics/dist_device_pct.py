"""Share (%) of the profiled unit's device time launched inside `CellRun.dists_to_cache`.

Layer: distance op.
"""


def read(ctx):
    u = ctx.unit
    if not u or not u["busy_s"] or "dist" not in u["span_device_s"]:
        return None
    return 100.0 * u["span_device_s"]["dist"] / u["busy_s"]
