"""Baseline explorers."""
from flexs_tpu_torch.baselines.explorers.adalead import Adalead  # noqa: F401
