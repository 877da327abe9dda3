"""Baseline surrogate models."""
from flexs_tpu_torch.baselines.models.noisy_abstract_model import (  # noqa: F401
    NoisyAbstractModel,
)
