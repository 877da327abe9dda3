"""Landscape base class.

Contract (reference flexs/landscape.py:20-45):
  * `Landscape(name)` sets `self.cost = 0` and `self.name = name`.
  * `get_fitness(sequences)` increments `self.cost` by `len(sequences)` and
    delegates to the subclass `_fitness_function`.
  * Subclasses override `_fitness_function`, never `get_fitness`.

Device extensions: landscapes that compute on tensors implement
`fitness_from_tokens(tokens)` over int[batch, L] token tensors; callers that
use it directly account cost themselves through `add_cost`.
"""
import abc

import numpy as np

from flexs_tpu_torch.types import SEQUENCES_TYPE


class Landscape(abc.ABC):
    """Base class for all landscapes and for `flexs_tpu_torch.Model`.

    Attributes:
        cost (int): Number of sequences whose fitness has been evaluated.
        name (str): Human-readable landscape name used in run logs.
    """

    def __init__(self, name: str):
        """Create Landscape, setting `name` and setting `cost` to zero."""
        self.cost = 0
        self.name = name

    @abc.abstractmethod
    def _fitness_function(self, sequences: SEQUENCES_TYPE) -> np.ndarray:
        pass

    def get_fitness(self, sequences: SEQUENCES_TYPE) -> np.ndarray:
        """Score a list/array of sequence strings, charging one cost each.

        Do not override; override `_fitness_function` instead.
        """
        self.cost += len(sequences)
        return self._fitness_function(sequences)

    def add_cost(self, n: int) -> None:
        """Account `n` oracle queries made through a token fast path."""
        self.cost += int(n)

    def fitness_from_tokens(self, tokens):
        """Score int[batch, L] tokens WITHOUT cost accounting.

        Tensor-backed landscapes override this; the default raises so that
        string-only landscapes are still valid.
        """
        raise NotImplementedError(
            f"{type(self).__name__} does not implement a token fast path"
        )
