"""The cell's needed work over the whole window at the chip's peak, in % (layer: device).

The configuration's `work` names the work that counts: "bert_flops", the
BERT forwards of every distinct row the window's runs scored at 67 TFLOP/s;
"lookup_ops", the window's nearest-neighbour lookups at the per-SM integer
rates (`work.lookup_ops_s`).  Over the window's wall.
"""
from benchmark import work


def read(ctx):
    if not ctx.on_device or not ctx.unit:
        return None
    w, kind = ctx.window, ctx.config.get("work")
    if kind == "bert_flops":
        ideal = w["bert_forwards"] * work.bert_flops(ctx.config) / ctx.peaks["f32_flops_per_s"]
    elif kind == "lookup_ops" and w["lookup"].calls:
        ideal = work.lookup_ops_s(w["lookup"], ctx.peaks, ctx.sm_clock_mhz)
    else:
        return None
    return 100.0 * ideal / w["wall_s"]
