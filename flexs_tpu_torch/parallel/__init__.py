"""Sweep engines: grids of (landscape, start, signal strength, seed) cells."""
from flexs_tpu_torch.parallel.sweep import (  # noqa: F401
    run_adaptivity_sweep,
    run_efficiency_sweep,
    run_landscape_robustness_sweep,
    run_robustness_sweep,
    sweep_adalead_nam,
)
