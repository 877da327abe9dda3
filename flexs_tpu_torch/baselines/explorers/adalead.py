"""Adalead explorer: the FLEXS flagship greedy hill-climber (host loop).

Contract (reference baselines/explorers/adalead.py):
  * name "Adalead_mu={mu}_threshold={threshold}" (:51).
  * Parents: measured sequences with true_score >= f_max * (1 - sign(f_max) *
    threshold), resized to `sequences_batch_size` (:102-111).
  * Optional recombination: `rho` rounds of pairwise crossover with
    per-position switch probability `recomb_rate` (:69-94, :117-118).
  * Rollouts: from each root, repeatedly generate ONE novel random mutant per
    alive node (rate mu/L, rejection-sampled against measured + generated
    sets, :134-151), batch-score the children, and keep rolling from children
    whose model fitness >= their root's (:156-162).  All under the
    `model_queries_per_batch` budget (:115, :127-131).
  * Raises ValueError if nothing was generated (:164-168).
  * Returns the top sequences by model score with the reference's
    `argsort(preds)[:-B:-1]` idiom, which yields B-1 (:171-175).

All roots roll out together: mutation is one vectorized numpy op over the
alive set, and each rollout step is ONE batched model call.  Randomness is
a seeded numpy Generator, drawn in the JAX package's order.
"""
from typing import Optional, Tuple

import numpy as np
import pandas as pd

from flexs_tpu_torch.alphabet import as_alphabet
from flexs_tpu_torch.explorer import Explorer
from flexs_tpu_torch.model import Model


class Adalead(Explorer):
    """Adaptive greedy search: threshold-select parents, then greedy rollouts."""

    def __init__(
        self,
        model: Model,
        rounds: int,
        sequences_batch_size: int,
        model_queries_per_batch: int,
        starting_sequence: str,
        alphabet: str,
        mu: int = 1,
        recomb_rate: float = 0,
        threshold: float = 0.05,
        rho: int = 0,
        eval_batch_size: int = 20,
        seed: Optional[int] = None,
        log_file: Optional[str] = None,
    ):
        """Create an Adalead explorer.

        Args:
            mu: Expected mutations per sequence (mu/L per position).
            recomb_rate: Crossover probability per position.
            threshold: Parent-selection band below the max fitness.
            rho: Number of recombination passes per budget-loop iteration.
            eval_batch_size: Kept for API parity; all roots are batched
                together regardless.
            seed: Seed for the numpy Generator (reference is unseedable).
        """
        name = f"Adalead_mu={mu}_threshold={threshold}"

        super().__init__(
            model,
            name,
            rounds,
            sequences_batch_size,
            model_queries_per_batch,
            starting_sequence,
            log_file,
        )
        self.threshold = threshold
        self.recomb_rate = recomb_rate
        self.alphabet = as_alphabet(alphabet)
        self.mu = mu
        self.rho = rho
        self.eval_batch_size = eval_batch_size
        self.rng = np.random.default_rng(seed)

    def _recombine_population(self, tokens: np.ndarray) -> np.ndarray:
        """Pairwise crossover over a shuffled population (token matrix).

        The switch state at each position is the parity of crossover events
        up to and including it (reference :69-94).
        """
        if len(tokens) == 1:
            return tokens
        perm = self.rng.permutation(len(tokens))
        tokens = tokens[perm]
        pairs = len(tokens) // 2
        a = tokens[0 : 2 * pairs : 2]
        b = tokens[1 : 2 * pairs : 2]
        crossover = self.rng.random(a.shape) < self.recomb_rate
        switch = np.cumsum(crossover, axis=1) % 2 == 1
        child_a = np.where(switch, a, b)
        child_b = np.where(switch, b, a)
        out = np.empty_like(tokens[: 2 * pairs])
        out[0::2] = child_a
        out[1::2] = child_b
        if len(tokens) % 2 == 1:
            out = np.concatenate([out, tokens[-1:]], axis=0)
        return out

    def _novel_mutants(self, tokens: np.ndarray, forbidden: set, max_tries: int = 64):
        """One novel random mutant per row, rejection-sampled in parallel.

        Returns (mutant tokens, novelty mask, mutant strings).  Rows that
        fail to find a novel mutant within `max_tries` vectorized rounds are
        masked out (the reference loops forever).
        """
        n, length = tokens.shape
        mu_per_res = self.mu / length
        result = tokens.copy()
        found = np.zeros(n, dtype=bool)
        strings = [None] * n
        for _ in range(max_tries):
            todo = ~found
            if not todo.any():
                break
            idx = np.nonzero(todo)[0]
            base = tokens[idx]
            mask = self.rng.random(base.shape) < mu_per_res
            rand = self.rng.integers(0, len(self.alphabet), base.shape)
            cand = np.where(mask, rand, base)
            decoded = self.alphabet.decode(cand)
            batch_seen = set()
            for row, i, s in zip(cand, idx, decoded):
                if s not in forbidden and s not in batch_seen:
                    batch_seen.add(s)
                    result[i] = row
                    strings[i] = s
                    found[i] = True
        return result, found, strings

    def propose_sequences(
        self, measured_sequences: pd.DataFrame
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Propose top `sequences_batch_size` sequences for evaluation."""
        measured_sequence_set = set(measured_sequences["sequence"])

        # Parent selection band (reference :102-111), sign-aware.
        top_fitness = measured_sequences["true_score"].max()
        top_inds = measured_sequences["true_score"] >= top_fitness * (
            1 - np.sign(top_fitness) * self.threshold
        )
        parents = np.resize(
            measured_sequences["sequence"][top_inds].to_numpy(),
            self.sequences_batch_size,
        )

        sequences = {}
        previous_model_cost = self.model.cost
        while self.model.cost - previous_model_cost < self.model_queries_per_batch:
            parent_tokens = self.alphabet.encode(list(parents))
            for _ in range(self.rho):
                parent_tokens = self._recombine_population(parent_tokens)

            roots = self.alphabet.decode(parent_tokens)
            root_fitnesses = np.asarray(self.model.get_fitness(roots))

            alive_tokens = parent_tokens
            alive_roots = root_fitnesses

            while (
                len(alive_tokens) > 0
                and self.model.cost - previous_model_cost + len(alive_tokens)
                < self.model_queries_per_batch
            ):
                forbidden = measured_sequence_set | sequences.keys()
                child_tokens, found, child_strings = self._novel_mutants(
                    alive_tokens, forbidden
                )
                if not found.any():
                    break
                child_tokens = child_tokens[found]
                child_strings = [s for s, f in zip(child_strings, found) if f]
                child_roots = alive_roots[found]

                fitnesses = np.asarray(self.model.get_fitness(child_strings))
                sequences.update(zip(child_strings, fitnesses))

                survive = fitnesses >= child_roots
                alive_tokens = child_tokens[survive]
                alive_roots = child_roots[survive]

        if len(sequences) == 0:
            raise ValueError(
                "No sequences generated. If `model_queries_per_batch` is small, "
                "try making `eval_batch_size` smaller"
            )

        # Propose the top sequences generated (reference idiom: B-1 of them).
        new_seqs = np.array(list(sequences.keys()))
        preds = np.array(list(sequences.values()))
        sorted_order = np.argsort(preds)[: -self.sequences_batch_size : -1]

        return new_seqs[sorted_order], preds[sorted_order]
