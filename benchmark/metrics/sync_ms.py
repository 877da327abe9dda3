"""Milliseconds of the window's wall per host sync of the fused runner (layer: loop control).

The syncs are `flexs_tpu_torch.runtime.jit_runner.run_counts["syncs"]`,
counted over the window.
"""


def read(ctx):
    w = ctx.window
    return 1e3 * w["wall_s"] / w["syncs"] if w["syncs"] else None
