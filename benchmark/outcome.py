"""One design run's outputs as the timed path produced them, for the check and the metrics."""
from dataclasses import dataclass

import numpy as np


@dataclass
class Cell:
    """A design run ("cell"): what it ran on, what it reported, and its `RunResult`."""

    key: str  # the landscape
    start: np.ndarray  # int64[L] start tokens
    signal_strength: float
    seed: int
    reported_max: float  # the best true_score the program reported for the cell
    result: tuple  # the cell's RunResult fields (device tensors until `settle`)

    def settle(self) -> "Cell":
        """Move the result to the host, as numpy (after the window: a sync per field)."""
        self.result = tuple(np.asarray(x.cpu()) if hasattr(x, "cpu") else np.asarray(x)
                            for x in self.result)
        return self

    @property
    def tokens(self):
        return self.result[0]

    @property
    def preds(self):
        return self.result[1]

    @property
    def truth(self):
        return self.result[2]

    @property
    def valid(self):
        return self.result[3]

    @property
    def model_cost(self):
        return self.result[4]

    @property
    def landscape_cost(self):
        return self.result[5]

    @property
    def start_truth(self):
        return float(self.result[6])


def split_cells(results, n):
    """Per-cell field tuples of `n` cells from the lockstep `RunResult`s of one unit, in order.

    A sweep's chunks come in cell order; a padded tail chunk repeats cells,
    which are dropped.
    """
    rows = []
    for r in results:
        for c in range(r[0].shape[0]):
            rows.append(tuple(x[c] for x in r))
    return rows[:n]
