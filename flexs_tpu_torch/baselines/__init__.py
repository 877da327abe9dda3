"""Baseline models and explorers."""
from flexs_tpu_torch.baselines import explorers, models  # noqa: F401
