"""CbAS and DbAS explorers (VAE-guided adaptive sampling).

Contract (reference baselines/explorers/cbas_dbas.py):
  * name "{algo}_Q={Q}_generator={generator.name}" (:46); algo in
    {"cbas", "dbas"} (:57-59).
  * Round 1 proposes random rate-2/L mutants of the start (:91-104).
  * Later rounds: elite set = last round's sequences >= Q-quantile true
    score, padded to >= 100 samples with rate-`mutation_rate` mutants
    (:67-83, :106-121); train the VAE on it and snapshot vae_0 (:125-144).
  * Budget loop (:148-192): generate `cycle_batch_size` novel proposals,
    score with the model, ratchet gamma up to max(Q-percentile, gamma);
    weights = exp(logp_vae0 - logp_vaet) for CbAS (:167-175) or 1 for DbAS
    (:177-179); zero weights below gamma (:181); retrain the VAE on the
    growing weighted pool (:183-192).
  * Returns the top generated sequences by model score via the
    reference's `argsort(preds)[:-B:-1]` idiom (:199), which yields B-1
    proposals (and zero when B == 1) — a preserved reference quirk.

Every draw of the explorer comes from a seeded numpy Generator in the JAX
package's order; the VAE runs on its own device.
"""
from typing import Optional, Tuple

import numpy as np
import pandas as pd

from flexs_tpu_torch.alphabet import as_alphabet
from flexs_tpu_torch.explorer import Explorer
from flexs_tpu_torch.model import Model
from flexs_tpu_torch.utils.vae import VAE


class CbAS(Explorer):
    """Conditioning by Adaptive Sampling (and its DbAS ablation)."""

    def __init__(
        self,
        model: Model,
        generator: VAE,
        rounds: int,
        starting_sequence: str,
        sequences_batch_size: int,
        model_queries_per_batch: int,
        alphabet: str,
        algo: str = "cbas",
        Q: float = 0.7,
        cycle_batch_size: int = 100,
        mutation_rate: float = 0.2,
        seed: Optional[int] = None,
        log_file: Optional[str] = None,
    ):
        """Create a CbAS/DbAS explorer.

        Args:
            generator: VAE generator.
            algo: "cbas" (importance-weighted) or "dbas".
            Q: Percentile used as fitness threshold.
            cycle_batch_size: Number of proposals per inner cycle.
            mutation_rate: Per-residue mutation probability when padding
                the elite set.
            seed: PRNG seed (the reference uses the global `random` module).
        """
        name = f"{algo}_Q={Q}_generator={generator.name}"
        super().__init__(
            model,
            name,
            rounds,
            sequences_batch_size,
            model_queries_per_batch,
            starting_sequence,
            log_file,
        )

        if algo not in ["cbas", "dbas"]:
            raise ValueError("`algo` must be one of 'cbas' or 'dbas'")
        self.algo = algo

        self.generator = generator
        self.alphabet = as_alphabet(alphabet)
        self.Q = Q
        self.cycle_batch_size = cycle_batch_size
        self.mutation_rate = mutation_rate
        self._rng = np.random.default_rng(seed)

    def _random_mutants(self, parents, rate: float, count: int) -> np.ndarray:
        """`count` rate-`rate` mutants of randomly chosen parents (batched)."""
        idx = self._rng.integers(0, len(parents), size=count)
        tokens = self.alphabet.encode([parents[i] for i in idx])
        mask = self._rng.random(tokens.shape) < rate
        rand = self._rng.integers(0, len(self.alphabet), tokens.shape, dtype=np.int32)
        return np.asarray(self.alphabet.decode(np.where(mask, rand, tokens)))

    def _extend_samples(self, samples, weights):
        """Pad the sample pool to >= 100 with novel random mutants."""
        samples = list(samples)
        weights = list(weights)
        sequences = set(samples)
        while len(sequences) < 100:
            batch = self._random_mutants(samples, self.mutation_rate, 100)
            for sample in batch:
                if len(sequences) >= 100:
                    break
                if sample not in sequences:
                    samples.append(sample)
                    weights.append(1)
                    sequences.add(sample)
        return np.array(samples), np.array(weights)

    def propose_sequences(
        self, measured_sequences_data: pd.DataFrame
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Propose top `sequences_batch_size` sequences for evaluation."""
        last_round = measured_sequences_data["round"].max()
        if last_round == 0:
            # No data yet: random sequences in a small neighborhood.
            sequences = set()
            while len(sequences) < self.sequences_batch_size:
                batch = self._random_mutants(
                    [self.starting_sequence],
                    2 / len(self.starting_sequence),
                    self.sequences_batch_size,
                )
                for s in batch:
                    if len(sequences) < self.sequences_batch_size:
                        sequences.add(s)
            sequences = np.array(list(sequences))
            return sequences, self.model.get_fitness(sequences)

        last_round_sequences = measured_sequences_data[
            measured_sequences_data["round"] == last_round
        ]

        gamma = np.percentile(last_round_sequences["true_score"], 100 * self.Q)
        initial_batch = last_round_sequences["sequence"][
            last_round_sequences["true_score"] >= gamma
        ].to_numpy()
        initial_weights = np.ones(len(initial_batch))

        initial_batch, initial_weights = self._extend_samples(
            initial_batch, initial_weights
        )
        all_samples, all_weights = initial_batch, initial_weights

        self.generator.train_model(initial_batch, initial_weights)

        # Snapshot the freshly trained generator as vae_0 (one state-dict
        # copy; no Keras recompile dance needed, reference :125-144).
        vae_0 = self.generator.get_weights()

        sequences = {}
        previous_model_cost = self.model.cost
        while self.model.cost - previous_model_cost < self.model_queries_per_batch:
            proposals = self.generator.generate(
                self.cycle_batch_size, all_samples, all_weights
            )

            scores = np.asarray(self.model.get_fitness(proposals))
            gamma = max(np.percentile(scores, self.Q * 100), gamma)

            if self.algo == "cbas":
                log_probs_0 = self.generator.calculate_log_probability(
                    proposals, vae=vae_0
                )
                log_probs_t = self.generator.calculate_log_probability(proposals)
                weights = np.nan_to_num(np.exp(log_probs_0 - log_probs_t))
            else:  # dbas
                weights = np.ones(len(proposals))

            weights[scores < gamma] = 0

            all_samples = np.append(all_samples, proposals)
            all_weights = np.append(all_weights, weights)

            self.generator.train_model(all_samples, all_weights)

            sequences.update(zip(proposals, scores))

        new_seqs = np.array(list(sequences.keys()))
        preds = np.array(list(sequences.values()))
        sorted_order = np.argsort(preds)[: -self.sequences_batch_size : -1]

        return new_seqs[sorted_order], preds[sorted_order]
