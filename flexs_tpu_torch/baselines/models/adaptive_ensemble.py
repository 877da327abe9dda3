"""AdaptiveEnsemble: holdout-reweighted model ensemble.

Parity contract (reference baselines/models/adaptive_ensemble.py):
  * `r2_weights(model_preds, labels)` = normalized Pearson r^2 per model
    (:12-27).
  * Name "AdaptiveEns(name1|name2|...)" (:55).
  * `train` (:71-95): with < 10 samples, train members on everything and
    keep current weights; otherwise hold out `adaptive_val_size` of the data,
    train members on the rest, and reweight from holdout predictions.
  * `_fitness_function` (:97-102): `combine_with(weights, scores)` over the
    (num_seqs, num_models) score matrix; default weighted sum.

The split draws from a seeded numpy Generator and the weights are numpy
f64 reductions on the host, as in the JAX package, so members with equal
predictions give equal splits and weights in both packages.  The members
run wherever they live (the card, by default).
"""
from typing import List

import numpy as np

from flexs_tpu_torch.landscape import Landscape
from flexs_tpu_torch.model import Model
from flexs_tpu_torch.types import SEQUENCES_TYPE


def _pearson_r2(preds, labels):
    """Per-row Pearson r^2 of preds [M, N] against labels [N]."""
    pc = preds - preds.mean(axis=1, keepdims=True)
    lc = labels - labels.mean()
    cov = np.sum(pc * lc[None, :], axis=1)
    denom = np.sqrt(np.sum(pc * pc, axis=1) * np.sum(lc * lc)) + 1e-12
    r = cov / denom
    return r * r


def r2_weights(model_preds: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """Normalized Pearson r^2 scores for a (num_models, num_samples) matrix."""
    r2s = _pearson_r2(
        np.asarray(model_preds, np.float64), np.asarray(labels, np.float64)
    )
    return r2s / r2s.sum()


class AdaptiveEnsemble(Model):
    """Ensemble with weights adapted to holdout accuracy every round."""

    def __init__(
        self,
        models: List[Landscape],
        combine_with="sum",
        adapt_weights_with="r2_weights",
        adaptive_val_size: float = 0.2,
        seed: int = 0,
    ):
        """Create an adaptively weighted ensemble.

        Args:
            models: Member models.
            combine_with: (weights, (num_seqs, num_models) scores) -> combined
                scores; default weighted sum.
            adapt_weights_with: ((num_models, num_samples) preds, labels) ->
                weights; default `r2_weights`.
            adaptive_val_size: Fraction of training data held out for
                reweighting.
            seed: Seed for the holdout split (the reference split is
                unseeded).
        """
        name = f"AdaptiveEns({'|'.join(model.name for model in models)})"
        super().__init__(name)

        self.models = models
        self.weights = np.ones(len(models)) / len(models)

        if combine_with == "sum":
            combine_with = lambda w, x: np.sum(w * x, axis=1)  # noqa: E731
        self.combine_with = combine_with

        if adapt_weights_with == "r2_weights":
            adapt_weights_with = r2_weights
        self.adapt_weights_with = adapt_weights_with

        self.adaptive_val_size = adaptive_val_size
        self._rng = np.random.default_rng(seed)

    def train(self, sequences: SEQUENCES_TYPE, labels):
        """Train members, then reweight on a holdout split (if >= 10 samples)."""
        sequences = np.asarray(sequences)
        labels = np.asarray(labels)

        if len(sequences) < 10:
            for model in self.models:
                model.train(sequences, labels)
            return

        perm = self._rng.permutation(len(sequences))
        n_val = max(1, int(round(len(sequences) * self.adaptive_val_size)))
        val, train = perm[:n_val], perm[n_val:]

        for model in self.models:
            model.train(sequences[train], labels[train])

        preds = np.stack(
            [model.get_fitness(sequences[val]) for model in self.models], axis=0
        )
        self.weights = self.adapt_weights_with(preds, labels[val])

    def _fitness_function(self, sequences: SEQUENCES_TYPE) -> np.ndarray:
        scores = np.stack(
            [model.get_fitness(sequences) for model in self.models], axis=1
        )
        return self.combine_with(self.weights, scores)
