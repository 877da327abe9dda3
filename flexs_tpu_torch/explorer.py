"""Explorer base class and the round-loop runner.

Contract (reference flexs/explorer.py):
  * Constructor signature and warnings (explorer.py:25-69): warn if
    `model_queries_per_batch < sequences_batch_size`.
  * `run(landscape, verbose)` (explorer.py:115-184):
      - resets `model.cost = 0`;
      - round 0 measures only the starting sequence (model_score = NaN);
      - each round r: `model.train(all seqs, all true scores)` ->
        `propose_sequences(df)` -> `landscape.get_fitness(proposals)` ->
        append rows; warn (not error) if more than `sequences_batch_size`
        proposals (explorer.py:165-168).
  * Measured-data schema: columns sequence, model_score, true_score, round,
    model_cost, measurement_cost (explorer.py:140-149, 170-181).
  * `_log` rewrites the whole log file each round: one JSON metadata line then
    the full CSV (explorer.py:92-113); metadata keys at explorer.py:129-137.

The fused runner that keeps every round on the device lives in
`flexs_tpu_torch.runtime.jit_runner`.
"""
import abc
import json
import os
import time
import warnings
from datetime import datetime
from typing import Dict, Optional, Tuple

import numpy as np
import pandas as pd

from flexs_tpu_torch.landscape import Landscape
from flexs_tpu_torch.model import Model

try:  # tqdm is optional; the reference uses it for the non-verbose path
    import tqdm

    _trange = tqdm.trange
except ImportError:  # pragma: no cover
    _trange = range


def write_run_log(path: str, metadata: Dict, sequences_data: pd.DataFrame) -> None:
    """One JSON metadata line + the full CSV (reference explorer.py:100-107).

    The run-log format of record, shared by `Explorer._log` and the fused
    runner (runtime/jit_runner.py) so the two can never drift.
    """
    dir_path, _ = os.path.split(path)
    if dir_path:
        os.makedirs(dir_path, exist_ok=True)
    with open(path, "w") as f:
        json.dump(metadata, f)
        f.write("\n")
        sequences_data.to_csv(f, index=False)


class Explorer(abc.ABC):
    """Abstract base explorer.

    Run an explorer through the `run` method.  Implement subclasses by
    overriding `propose_sequences` (do not override `run`).
    """

    def __init__(
        self,
        model: Model,
        name: str,
        rounds: int,
        sequences_batch_size: int,
        model_queries_per_batch: int,
        starting_sequence: str,
        log_file: Optional[str] = None,
    ):
        """Create an Explorer.

        Args:
            model: Surrogate model guiding proposals.
            name: Human-readable explorer name (may encode parameter values).
            rounds: Number of rounds of the propose/measure/retrain loop.
            sequences_batch_size: Ground-truth measurements per round.
            model_queries_per_batch: In-silico model queries allowed per round.
            starting_sequence: Seed sequence for exploration.
            log_file: Optional .csv filepath for run output.
        """
        self.model = model
        self.name = name

        self.rounds = rounds
        self.sequences_batch_size = sequences_batch_size
        self.model_queries_per_batch = model_queries_per_batch
        self.starting_sequence = starting_sequence

        self.log_file = log_file
        if self.log_file is not None:
            dir_path, _ = os.path.split(self.log_file)
            if dir_path:
                os.makedirs(dir_path, exist_ok=True)

        if model_queries_per_batch < sequences_batch_size:
            warnings.warn(
                "`model_queries_per_batch` should be >= `sequences_batch_size`"
            )

    @abc.abstractmethod
    def propose_sequences(
        self, measured_sequences_data: pd.DataFrame
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Propose sequences for the next round of measurement.

        Args:
            measured_sequences_data: DataFrame of all measured sequences with
                columns "sequence", "true_score", "model_score", "round".

        Returns:
            (proposed sequences, their model scores).
        """
        pass

    def _log(
        self,
        sequences_data: pd.DataFrame,
        metadata: Dict,
        current_round: int,
        verbose: bool,
        round_start_time: float,
    ) -> None:
        if self.log_file is not None:
            write_run_log(self.log_file, metadata, sequences_data)

        if verbose:
            print(
                f"round: {current_round}, top: {sequences_data['true_score'].max()}, "
                f"time: {time.time() - round_start_time:02f}s"
            )

    def run(
        self, landscape: Landscape, verbose: bool = True
    ) -> Tuple[pd.DataFrame, Dict]:
        """Run the explorer against `landscape` for `self.rounds` rounds."""
        self.model.cost = 0

        metadata = {
            "run_id": datetime.now().strftime("%H:%M:%S-%m/%d/%Y"),
            "exp_name": self.name,
            "model_name": self.model.name,
            "landscape_name": landscape.name,
            "rounds": self.rounds,
            "sequences_batch_size": self.sequences_batch_size,
            "model_queries_per_batch": self.model_queries_per_batch,
        }

        # Round 0: the starting sequence only, with no model score.
        sequences_data = pd.DataFrame(
            {
                "sequence": self.starting_sequence,
                "model_score": np.nan,
                "true_score": landscape.get_fitness([self.starting_sequence]),
                "round": 0,
                "model_cost": self.model.cost,
                "measurement_cost": 1,
            }
        )
        self._log(sequences_data, metadata, 0, verbose, time.time())

        range_iterator = range if verbose else _trange
        for r in range_iterator(1, self.rounds + 1):
            round_start_time = time.time()
            self.model.train(
                sequences_data["sequence"].to_numpy(),
                sequences_data["true_score"].to_numpy(),
            )

            seqs, preds = self.propose_sequences(sequences_data)
            true_score = landscape.get_fitness(seqs)

            if len(seqs) > self.sequences_batch_size:
                warnings.warn(
                    "Must propose <= `self.sequences_batch_size` sequences per round"
                )

            sequences_data = pd.concat(
                [
                    sequences_data,
                    pd.DataFrame(
                        {
                            "sequence": np.asarray(seqs),
                            "model_score": np.asarray(preds, dtype=np.float64),
                            "true_score": np.asarray(true_score, dtype=np.float64),
                            "round": r,
                            "model_cost": self.model.cost,
                            "measurement_cost": len(sequences_data) + len(seqs),
                        }
                    ),
                ],
                ignore_index=True,
            )
            self._log(sequences_data, metadata, r, verbose, round_start_time)

        return sequences_data, metadata
