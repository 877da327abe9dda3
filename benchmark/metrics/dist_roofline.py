"""The masked nearest-neighbour lookup's share (%) of its roofline (layer: distance op).

The least time of the lookups the profiled unit made (`work.Lookup`: the
slowest operation class at its per-SM rate x 132 SMs x the SM clock read
beside the unit, or the bytes at 3.35 TB/s, whichever is larger), over the
device time launched inside `CellRun.dists_to_cache`.
"""
from benchmark import work


def read(ctx):
    u = ctx.unit
    if not u or not u["span_device_s"].get("dist") or not u["lookup"].calls:
        return None
    return 100.0 * work.lookup_bound_s(u["lookup"], ctx.peaks, ctx.sm_clock_mhz) / u["span_device_s"]["dist"]
