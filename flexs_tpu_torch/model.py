"""Model base class and the perfect-model wrapper.

Contract (reference flexs/model.py:11-54):
  * `Model` is a `Landscape` with an abstract `train(sequences, labels)`.
  * `LandscapeAsModel` wraps a landscape; its `_fitness_function` calls the
    inner landscape's `_fitness_function` directly so the landscape's cost is
    not double-counted (model.py:49-50); `train` is a no-op.
"""
import abc
from typing import Any, List

import numpy as np

from flexs_tpu_torch.landscape import Landscape
from flexs_tpu_torch.types import SEQUENCES_TYPE


class Model(Landscape, abc.ABC):
    """Base model class: a `Landscape` that can additionally be trained."""

    @abc.abstractmethod
    def train(self, sequences: SEQUENCES_TYPE, labels: List[Any]):
        """Update the model on measured (sequence, label) data."""
        pass


class LandscapeAsModel(Model):
    """Wraps a `Landscape` in a `Model` to allow running a perfect model."""

    def __init__(self, landscape: Landscape):
        """Create a perfect model from `landscape`."""
        super().__init__(f"LandscapeAsModel={landscape.name}")
        self.landscape = landscape

    def _fitness_function(self, sequences: SEQUENCES_TYPE) -> np.ndarray:
        return self.landscape._fitness_function(sequences)

    def fitness_from_tokens(self, tokens):
        return self.landscape.fitness_from_tokens(tokens)

    def train(self, sequences: SEQUENCES_TYPE, labels: List[Any]):
        """No-op."""
        pass
