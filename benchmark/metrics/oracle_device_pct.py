"""Share (%) of the profiled unit's device time launched inside the oracle (layer: oracle).

The oracle is the family's fitness function (`families/<family>.py`'s
ORACLE_TARGETS): BERT's forward for GFP, the table gather for TF-Bind.
"""


def read(ctx):
    u = ctx.unit
    if not u or not u["busy_s"] or "oracle" not in u["span_device_s"]:
        return None
    return 100.0 * u["span_device_s"]["oracle"] / u["busy_s"]
