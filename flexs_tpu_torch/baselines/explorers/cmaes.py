"""CMAES explorer over a continuous relaxation of one-hot sequences.

Contract (reference baselines/explorers/cmaes.py):
  * name "CMAES_popsize{N}" (:44).
  * Optimizes flattened one-hot space (L * A dims); solutions decode by
    per-position argmax (:61-67).
  * x0 = one-hot of the best measured sequence; initial step size
    sqrt(initial_variance) (:94-96).
  * ask/tell loop until `max_iter` or the model-query budget would be
    exceeded (:99-114); cached sequences (already generated or measured)
    are not re-queried (:86-92).
  * As in the reference, the evolution strategy MINIMIZES the objective
    (the `cma` default — reference cmaes.py:96-114 passes raw fitnesses to
    `tell`), while the proposal step at the end still returns the top
    `sequences_batch_size` of everything generated by model score.

The CMA-ES math runs on the explorer's device (`flexs_tpu_torch.ops.cmaes`),
its draws come from a `torch.Generator` seeded from `seed`, and each
generation's novel decodings are scored in one batched model call instead of
the reference's per-solution singleton `get_fitness` calls.
"""
from typing import Optional, Tuple

import numpy as np
import pandas as pd
import torch

from flexs_tpu_torch.alphabet import as_alphabet
from flexs_tpu_torch.device import resolve_device
from flexs_tpu_torch.explorer import Explorer
from flexs_tpu_torch.model import Model
from flexs_tpu_torch.ops import cmaes as cma_ops


class CMAES(Explorer):
    """Covariance matrix adaptation evolution strategy explorer."""

    def __init__(
        self,
        model: Model,
        rounds: int,
        sequences_batch_size: int,
        model_queries_per_batch: int,
        starting_sequence: str,
        alphabet: str,
        population_size: int = 15,
        max_iter: int = 400,
        initial_variance: float = 0.2,
        seed: int = 0,
        maximize: bool = False,
        log_file: Optional[str] = None,
        device=None,
    ):
        """Create the CMAES explorer.

        Args:
            population_size: Number of proposed solutions per iteration.
            max_iter: Maximum number of iterations.
            initial_variance: Initial sampling variance.
            seed: Seed of the explorer's `torch.Generator` (the reference
                inherits `cma`'s global seeding).
            maximize: False (default) reproduces the reference exactly: raw
                fitnesses go to the minimizing `tell` (reference
                cmaes.py:108-112), so the evolution path drifts DOWNHILL and
                only the top-k bookkeeping rescues proposals.  True negates
                fitness so CMA-ES actually ascends the landscape.
            device: Where the evolution state lives and the draws are made
                (default "cuda"; pass "cpu" to run on the CPU).
        """
        name = f"CMAES_popsize{population_size}"

        super().__init__(
            model,
            name,
            rounds,
            sequences_batch_size,
            model_queries_per_batch,
            starting_sequence,
            log_file,
        )

        self.alphabet = as_alphabet(alphabet)
        self.population_size = population_size
        self.max_iter = max_iter
        self.initial_variance = initial_variance
        self.maximize = maximize
        self.device = resolve_device(device)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)

    def _solutions_to_strings(self, solutions: np.ndarray):
        """Argmax-decode [pop, L*A] solutions to sequence strings."""
        x = solutions.reshape(
            len(solutions), len(self.starting_sequence), len(self.alphabet)
        )
        return self.alphabet.decode(np.argmax(x, axis=2).astype(np.int32))

    def propose_sequences(
        self, measured_sequences: pd.DataFrame
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Propose top `sequences_batch_size` sequences for evaluation."""
        measured_sequence_dict = dict(
            zip(measured_sequences["sequence"], measured_sequences["true_score"])
        )

        top_idx = measured_sequences["true_score"].argmax()
        top_seq = measured_sequences["sequence"].to_numpy()[top_idx]
        top_val = measured_sequences["true_score"].to_numpy()[top_idx]
        sequences = {top_seq: top_val}

        # Start at the one-hot of the best measured sequence.
        tokens = self.alphabet.encode_one(top_seq)
        x0 = np.zeros((len(top_seq), len(self.alphabet)), dtype=np.float32)
        x0[np.arange(len(top_seq)), tokens] = 1
        state = cma_ops.init(
            x0.flatten(), float(np.sqrt(self.initial_variance)), self.device
        )

        initial_cost = self.model.cost
        for _ in range(self.max_iter):
            if (
                self.model.cost - initial_cost + self.population_size
                > self.model_queries_per_batch
            ):
                break

            solutions = cma_ops.ask_numpy(state, self._generator, self.population_size)
            strings = self._solutions_to_strings(solutions)

            # One batched model call for the novel decodings; cache hits are
            # free (same accounting as the reference's memoized objective).
            fitnesses = np.empty(len(strings))
            novel_idx = []
            for i, s in enumerate(strings):
                if s in sequences:
                    fitnesses[i] = sequences[s]
                elif s in measured_sequence_dict:
                    fitnesses[i] = measured_sequence_dict[s]
                else:
                    novel_idx.append(i)
            if novel_idx:
                # Duplicates within one generation get one query each, same
                # as the reference's per-solution objective calls.
                novel = [strings[i] for i in novel_idx]
                scores = np.asarray(self.model.get_fitness(novel))
                fitnesses[novel_idx] = scores

            sequences.update(zip(strings, fitnesses))
            tell_vals = -fitnesses if self.maximize else fitnesses
            state = cma_ops.tell_numpy(state, solutions, tell_vals)

        new_seqs = np.array(list(sequences.keys()))
        preds = np.array(list(sequences.values()))
        sorted_order = np.argsort(preds)[: -self.sequences_batch_size : -1]

        return new_seqs[sorted_order], preds[sorted_order]
