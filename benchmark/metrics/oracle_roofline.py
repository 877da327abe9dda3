"""The BERT oracle's share (%) of the float32 peak (layer: oracle).

The matrix-product FLOPs of one forward at the sequence's real tokens
(`work.bert_flops`) for each distinct row the profiled unit's runs scored
(`work.distinct_rows`), over the device time launched inside the oracle
times 67 TFLOP/s (float32 outside the tensor cores; the configuration
states float32 with TF32 off).
"""
from benchmark import work


def read(ctx):
    u = ctx.unit
    if ctx.config.get("work") != "bert_flops" or not u or not u["span_device_s"].get("oracle"):
        return None
    flops = u["bert_forwards"] * work.bert_flops(ctx.config)
    return 100.0 * flops / (u["span_device_s"]["oracle"] * ctx.peaks["f32_flops_per_s"])
