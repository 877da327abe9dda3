"""Ensemble of landscapes/models.

Contract (reference flexs/ensemble.py:10-59):
  * name = "Ens(name1|name2|...)".
  * `train` trains every member.
  * `_fitness_function` stacks member scores to (num_seqs, num_models) and
    applies `combine_with` (default: mean over models).  BO passes an identity
    `combine_with=lambda x: x` to see per-member scores (reference bo.py:56).
"""
from typing import Callable, List

import numpy as np

from flexs_tpu_torch.landscape import Landscape
from flexs_tpu_torch.model import Model
from flexs_tpu_torch.types import SEQUENCES_TYPE


class Ensemble(Model):
    """Combine several landscapes/models into one model.

    Attributes:
        models: The ensembled members.
        combine_with: Maps a (num_seqs, num_models) score matrix to the
            combined output (default mean over the model axis).
    """

    def __init__(
        self,
        models: List[Landscape],
        combine_with: Callable[[np.ndarray], np.ndarray] = lambda x: np.mean(
            x, axis=1
        ),
    ):
        """Create ensemble over `models`, combined with `combine_with`."""
        name = f"Ens({'|'.join(model.name for model in models)})"
        super().__init__(name)

        self.models = models
        self.combine_with = combine_with

    def train(self, sequences: SEQUENCES_TYPE, labels: np.ndarray):
        """Train each member on the same data."""
        for model in self.models:
            if isinstance(model, Model):
                model.train(sequences, labels)

    def _fitness_function(self, sequences: SEQUENCES_TYPE) -> np.ndarray:
        scores = np.stack(
            [model.get_fitness(sequences) for model in self.models], axis=1
        )
        return self.combine_with(scores)

    def fitness_from_tokens(self, tokens) -> np.ndarray:
        """Token fast path: stack member token scores on the host, then combine.

        Raises NotImplementedError if any member lacks a token path, so
        callers can fall back to the string API wholesale.
        """
        scores = np.stack(
            [_to_numpy(model.fitness_from_tokens(tokens)) for model in self.models],
            axis=1,
        )
        return self.combine_with(scores)


def _to_numpy(scores) -> np.ndarray:
    return scores.cpu().numpy() if hasattr(scores, "cpu") else np.asarray(scores)
