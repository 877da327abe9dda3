"""Random explorer.

Contract (reference baselines/explorers/random.py):
  * name "Random_mu={mu}" (:46).
  * Each round: mutate random measured sequences at per-residue rate mu/L
    until strictly more than `model_queries_per_batch` novel sequences are
    collected (:70-79), score them all with the model in one call (:81), and
    return either the top `sequences_batch_size` by model score (elitist) or
    a uniform random subset (:83-88).

Candidates are generated in vectorized numpy chunks (per-residue Bernoulli
masks over whole batches), drawn from a seeded numpy Generator in the JAX
package's order, and scored in one model call per round.
"""
from typing import Optional, Tuple

import numpy as np
import pandas as pd

from flexs_tpu_torch.alphabet import as_alphabet
from flexs_tpu_torch.explorer import Explorer
from flexs_tpu_torch.model import Model


class Random(Explorer):
    """Propose random mutants of previously measured sequences.

    The model is only used to score (elitist mode) — never to guide search.
    """

    def __init__(
        self,
        model: Model,
        rounds: int,
        starting_sequence: str,
        sequences_batch_size: int,
        model_queries_per_batch: int,
        alphabet: str,
        mu: float = 1,
        elitist: bool = False,
        seed: Optional[int] = None,
        log_file: Optional[str] = None,
    ):
        """Create a random search explorer.

        Args:
            mu: Average number of mutations per generated sequence.
            elitist: If True propose the model's top-scored candidates,
                else a uniform random subset.
            seed: Seed for the numpy Generator.
        """
        name = f"Random_mu={mu}"

        super().__init__(
            model,
            name,
            rounds,
            sequences_batch_size,
            model_queries_per_batch,
            starting_sequence,
            log_file,
        )
        self.mu = mu
        self.rng = np.random.default_rng(seed)
        self.alphabet = as_alphabet(alphabet)
        self.elitist = elitist

    def propose_sequences(
        self, measured_sequences: pd.DataFrame
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Propose `sequences_batch_size` sequences for measurement."""
        old_sequences = measured_sequences["sequence"].to_numpy()
        old_sequence_set = set(old_sequences)
        length = len(old_sequences[0])
        mu_per_res = self.mu / length

        new_seqs = []
        new_set = set()
        target = self.model_queries_per_batch + 1  # reference loop exits at >
        # Generate candidates in vectorized chunks until enough novel ones.
        while len(new_seqs) < target:
            chunk = max(256, target - len(new_seqs))
            parents = self.rng.choice(old_sequences, size=chunk)
            tokens = self.alphabet.encode(list(parents))
            mask = self.rng.random(tokens.shape) < mu_per_res
            rand = self.rng.integers(0, len(self.alphabet), tokens.shape)
            mutants = self.alphabet.decode(np.where(mask, rand, tokens))
            for s in mutants:
                if s not in old_sequence_set and s not in new_set:
                    new_set.add(s)
                    new_seqs.append(s)
                    if len(new_seqs) >= target:
                        break

        new_seqs = np.array(new_seqs)
        preds = self.model.get_fitness(new_seqs)

        if self.elitist:
            idxs = np.argsort(preds)[: -self.sequences_batch_size : -1]
        else:
            idxs = self.rng.integers(0, len(new_seqs), size=self.sequences_batch_size)

        return new_seqs[idxs], preds[idxs]
