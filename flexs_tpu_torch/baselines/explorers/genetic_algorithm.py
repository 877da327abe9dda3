"""Genetic algorithm explorer (top-proportion and Wright-Fisher selection).

Contract (reference baselines/explorers/genetic_algorithm.py):
  * name "GeneticAlgorithm_pop_size={N}_parents={strategy}" (:45-48).
  * Valid strategies "top-proportion" (uniform choice among the top
    `parent_selection_proportion * population_size` scorers, :88-91) and
    "wright-fisher" (multinomial over softmax(score / beta), :93-96 — the
    reference shells out to torch.multinomial purely for sampling; here it is
    a seeded numpy Generator call).
  * Initial population drawn from measured data by the same strategy
    (:105-111).
  * Loop while cost delta + population_size < model_queries_per_batch
    (:115-119): children = per-position rate-1/L mutants of selected parents,
    filtered against measured/generated sets (:126-134), batch-scored, then
    replace the worst `len(children)` population members (:137-143).
  * Returns top `sequences_batch_size` generated sequences by model score.

Children are generated in one vectorized mutation op over the whole parent
batch and scored in one model call per generation; every draw comes from a
seeded numpy Generator in the JAX package's order.
"""
from typing import Optional, Tuple

import numpy as np
import pandas as pd

from flexs_tpu_torch.alphabet import as_alphabet
from flexs_tpu_torch.explorer import Explorer
from flexs_tpu_torch.model import Model


class GeneticAlgorithm(Explorer):
    """Genetic algorithm with single-point mutations and configurable selection."""

    def __init__(
        self,
        model: Model,
        rounds: int,
        starting_sequence: str,
        sequences_batch_size: int,
        model_queries_per_batch: int,
        alphabet: str,
        population_size: int,
        parent_selection_strategy: str,
        children_proportion: float,
        log_file: Optional[str] = None,
        parent_selection_proportion: Optional[float] = None,
        beta: Optional[float] = None,
        seed: Optional[int] = None,
    ):
        """Create genetic algorithm."""
        name = (
            f"GeneticAlgorithm_pop_size={population_size}_"
            f"parents={parent_selection_strategy}"
        )

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

        valid = ["top-proportion", "wright-fisher"]
        if parent_selection_strategy not in valid:
            raise ValueError(f"parent_selection_strategy must be one of {valid}")
        if (
            parent_selection_strategy == "top-proportion"
            and parent_selection_proportion is None
        ):
            raise ValueError(
                "if top-proportion, parent_selection_proportion cannot be None"
            )
        if parent_selection_strategy == "wright-fisher" and beta is None:
            raise ValueError("if wright-fisher, beta cannot be None")
        self.parent_selection_strategy = parent_selection_strategy
        self.beta = beta

        self.children_proportion = children_proportion
        self.parent_selection_proportion = parent_selection_proportion

        self.rng = np.random.default_rng(seed)

    def _choose_parents(self, scores: np.ndarray, num_parents: int) -> np.ndarray:
        """Return parent indices according to the selection strategy."""
        if self.parent_selection_strategy == "top-proportion":
            k = int(self.parent_selection_proportion * self.population_size)
            return self.rng.choice(np.argsort(scores)[-k:], num_parents)

        # wright-fisher: multinomial over softmax(score / beta); subtract the
        # max before exponentiating for stability (same distribution).
        logits = scores / self.beta
        probs = np.exp(logits - logits.max())
        probs /= probs.sum()
        return self.rng.choice(len(scores), size=num_parents, replace=True, p=probs)

    def propose_sequences(
        self, measured_sequences: pd.DataFrame
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Propose top `sequences_batch_size` sequences for evaluation."""
        measured_sequence_set = set(measured_sequences["sequence"])

        # Initial population selected from measured data.
        initial_pop_inds = self._choose_parents(
            measured_sequences["true_score"].to_numpy(), self.population_size
        )
        pop = measured_sequences["sequence"].to_numpy()[initial_pop_inds]
        scores = measured_sequences["true_score"].to_numpy()[initial_pop_inds]

        sequences = {}
        initial_cost = self.model.cost
        while (
            self.model.cost - initial_cost + self.population_size
            < self.model_queries_per_batch
        ):
            num_children = int(self.children_proportion * self.population_size)
            parents = pop[self._choose_parents(scores, num_children)]

            # Vectorized rate-1/L mutation of the whole parent batch at once.
            tokens = self.alphabet.encode(list(parents))
            mask = self.rng.random(tokens.shape) < 1 / tokens.shape[1]
            rand = self.rng.integers(
                0, len(self.alphabet), tokens.shape, dtype=np.int32
            )
            decoded = self.alphabet.decode(np.where(mask, rand, tokens))

            children, batch_seen = [], set()
            for child in decoded:
                if (
                    child not in measured_sequence_set
                    and child not in sequences
                    and child not in batch_seen
                ):
                    batch_seen.add(child)
                    children.append(child)

            if len(children) == 0:
                continue

            children = np.array(children)
            child_scores = np.asarray(self.model.get_fitness(children))

            # Replace the worst population members with the new children.
            argsorted_scores = np.argsort(scores)
            pop[argsorted_scores[: len(children)]] = children
            scores[argsorted_scores[: len(children)]] = child_scores

            sequences.update(zip(children, child_scores))

        new_seqs = np.array(list(sequences.keys()))
        preds = np.array(list(sequences.values()))
        sorted_order = np.argsort(preds)[: -self.sequences_batch_size : -1]

        return new_seqs[sorted_order], preds[sorted_order]
