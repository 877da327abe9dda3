"""Noisy abstract model: a tunable-quality surrogate around a true landscape.

Contract (reference baselines/models/noisy_abstract_model.py):
  * name "NAMb_ss{signal_strength}" (:36).
  * `train` caches measured (sequence, label) pairs (:62-67).
  * For a cached query, return the cached value (:73-75).
  * For an uncached query: d = distance to nearest cached neighbour (:42-60),
    alpha = ss^d, fitness = alpha * f(x) + (1 - alpha) * eps where eps is
    Exp(mean = nearest neighbour's true fitness), or a random cached value if
    that fitness is negative (:80-94).  New predictions are themselves cached
    so repeated queries are deterministic (:96-99).
  * The model queries the true landscape through the public `get_fitness`,
    so landscape cost increases by 2 per new query (signal + neighbour).

The noise comes from a seeded numpy Generator in the JAX package's draw
order, so a seeded run reproduces that package's run row for row.  The
cache lives on the device as bit-packed rows; the nearest neighbour of a
whole query batch is one packed-Hamming matrix with a first-index argmin.
FLEXS problems are fixed-length with substitution-only operators, so
Hamming == Levenshtein on realized data; an exact-DP fallback handles
mixed lengths (`ops.hamming.edit_distance_matrix`).
"""
from typing import Optional

import numpy as np
import torch

from flexs_tpu_torch.device import resolve_device
from flexs_tpu_torch.landscape import Landscape
from flexs_tpu_torch.model import Model
from flexs_tpu_torch.ops.hamming import edit_distance_matrix, min_hamming_and_argmin
from flexs_tpu_torch.ops.packed_hamming import (
    pack_tokens,
    packed_hamming_matrix,
    packing_spec,
)
from flexs_tpu_torch.ops.padding import next_bucket
from flexs_tpu_torch.types import SEQUENCES_TYPE

# Compact symbol ids: 31 usable ids (covers AAS=20); 5 bits per packed symbol.
_SYMBOL_CAP = 32


class NoisyAbstractModel(Model):
    r"""Ground-truth landscape corrupted by distance-modulated noise.

    $\hat f(x) = \alpha^d f(x) + (1 - \alpha^d)\,\epsilon$, with $d$ the
    distance to the closest measured sequence and $\alpha$ the signal
    strength.
    """

    def __init__(
        self,
        landscape: Landscape,
        signal_strength: float = 0.9,
        seed: Optional[int] = None,
        device=None,
    ):
        """Create a noisy abstract model around `landscape`.

        Args:
            landscape: The ground truth oracle.
            signal_strength: Alpha in [0, 1]; 1 = perfect model.
            seed: Optional seed for the noise generator (the reference uses
                unseeded global numpy randomness).
            device: Where the neighbour search runs (default "cuda").
        """
        super().__init__(f"NAMb_ss{signal_strength}")

        self.landscape = landscape
        self.ss = signal_strength
        self.device = resolve_device(device)
        self.cache = {}
        self._truth = {}  # sequence -> true fitness (recorded when scored)
        self._rng = np.random.default_rng(seed)

        # Stable byte -> compact token mapping (persists across calls).
        self._byte_map = np.full(256, -1, dtype=np.int32)
        self._next_id = 0

        self._cache_seqs = []
        self._packed = None  # int64[capacity, K] packed cache rows on device
        self._length = None  # uniform sequence length, None if mixed
        self._mixed_rows = None  # host token matrix when lengths are mixed

    def _tokenize(self, sequences):
        raw = np.frombuffer("".join(sequences).encode("ascii"), dtype=np.uint8)
        new_bytes = np.unique(raw[self._byte_map[raw] < 0])
        for b in new_bytes:
            if self._next_id >= _SYMBOL_CAP - 1:
                raise ValueError("NoisyAbstractModel supports <= 31 distinct symbols")
            self._byte_map[b] = self._next_id
            self._next_id += 1
        return self._byte_map[raw]

    def _pack(self, sequences):
        tokens = self._tokenize(sequences).reshape(len(sequences), self._length)
        return pack_tokens(torch.as_tensor(tokens, device=self.device), _SYMBOL_CAP)

    def _append_cache(self, sequences):
        if not sequences:
            return
        lengths = {len(s) for s in sequences}
        if self._length is None and self._mixed_rows is None:
            self._length = lengths.pop() if len(lengths) == 1 else None
        if self._length is not None and (
            len(lengths) > 1 or (lengths and lengths != {self._length})
        ):
            # Fall back to the exact-DP host path for mixed lengths.
            self._to_mixed_mode()

        if self._length is not None:
            rows = self._pack(sequences)
            n = len(self._cache_seqs)
            needed = n + len(rows)
            if self._packed is None or needed > len(self._packed):
                grown = rows.new_zeros((next_bucket(needed, minimum=4096), rows.shape[1]))
                if self._packed is not None:
                    grown[:n] = self._packed[:n]
                self._packed = grown
            self._packed[n:needed] = rows
        else:
            self._append_mixed(sequences)
        self._cache_seqs.extend(sequences)

    def _to_mixed_mode(self):
        self._mixed_rows = None
        self._length = None
        self._packed = None
        saved, self._cache_seqs = self._cache_seqs, []
        self._append_mixed(saved)
        self._cache_seqs = saved

    def _append_mixed(self, sequences):
        if not sequences:
            return
        width = max(len(s) for s in sequences)
        if self._mixed_rows is not None:
            width = max(width, self._mixed_rows.shape[1])
        mat = np.full((len(sequences), width), -1, dtype=np.int32)
        for i, s in enumerate(sequences):
            mat[i, : len(s)] = self._tokenize([s])
        if self._mixed_rows is None:
            self._mixed_rows = mat
        else:
            old = self._mixed_rows
            if old.shape[1] < width:
                pad = np.full((old.shape[0], width - old.shape[1]), -1, np.int32)
                old = np.concatenate([old, pad], axis=1)
            self._mixed_rows = np.concatenate([old, mat], axis=0)

    def train(self, sequences: SEQUENCES_TYPE, labels: np.ndarray):
        """Cache measured (sequence, label) pairs for future lookup."""
        fresh = [s for s in sequences if s not in self.cache]
        self.cache.update(zip(sequences, labels))
        self._truth.update(zip(sequences, np.asarray(labels, dtype=np.float64)))
        seen = set()
        fresh_unique = [s for s in fresh if not (s in seen or seen.add(s))]
        self._append_cache(fresh_unique)

    def _min_distances(self, sequences):
        """Batched (distance, neighbour sequence) to the current cache."""
        if not self._cache_seqs:
            # Reference :44-45: empty cache => distance 0, neighbour = self.
            return np.zeros(len(sequences), dtype=np.int64), list(sequences)

        n = len(self._cache_seqs)
        uniform = self._length is not None and all(
            len(s) == self._length for s in sequences
        )
        if uniform:
            bits, per_word, _ = packing_spec(self._length, _SYMBOL_CAP)
            dists = packed_hamming_matrix(
                self._pack(sequences), self._packed[:n], bits, per_word
            )
            mins, idx = (x.cpu().numpy() for x in min_hamming_and_argmin(dists))
        else:
            # Off-length QUERIES take a local exact-DP path against a
            # temporary matrix view; they must not demote the uniform cache.
            if self._mixed_rows is not None:
                c = self._mixed_rows
            else:
                c = self._tokenize(self._cache_seqs).reshape(n, self._length)
            qwidth = max(c.shape[1], max(len(s) for s in sequences))
            q = np.full((len(sequences), qwidth), -1, dtype=np.int32)
            for i, s in enumerate(sequences):
                q[i, : len(s)] = self._tokenize([s])
            if c.shape[1] < qwidth:
                pad = np.full((c.shape[0], qwidth - c.shape[1]), -1, np.int32)
                c = np.concatenate([c, pad], axis=1)
            dists = edit_distance_matrix(q, c)
            idx = np.argmin(dists, axis=1)
            mins = dists[np.arange(len(sequences)), idx]

        return mins.astype(np.int64), [self._cache_seqs[i] for i in idx]

    def _fitness_function(self, sequences):
        sequences = np.array(sequences)
        fitnesses = np.empty(len(sequences))

        cached = np.array([seq in self.cache for seq in sequences])
        fitnesses[cached] = np.array(
            [self.cache[seq] for seq in sequences[cached]]
        )

        uncached = [str(s) for s in sequences[~cached]]
        if uncached:
            distances, neighbors = self._min_distances(uncached)

            # One batched oracle call for the signals (the reference makes 2
            # singleton landscape calls per sequence: same cost accounting).
            signals = np.asarray(
                self.landscape.get_fitness(uncached), dtype=np.float64
            )
            self._truth.update(zip(uncached, signals))
            # Every neighbour is a cache member whose truth was recorded when
            # it was first scored; the reference's cost of one landscape
            # query per lookup is still charged.
            missing = [s for s in set(neighbors) if s not in self._truth]
            if missing:
                for s, v in zip(missing, self.landscape._fitness_function(missing)):
                    self._truth[s] = float(v)
            self.landscape.add_cost(len(neighbors))
            neighbor_fit = np.array(
                [self._truth[s] for s in neighbors], dtype=np.float64
            )

            noise = np.where(
                neighbor_fit >= 0,
                self._rng.exponential(scale=np.maximum(neighbor_fit, 0) + 1e-300),
                0.0,
            )
            neg = neighbor_fit < 0
            if neg.any():
                values = list(self.cache.values())
                noise[neg] = self._rng.choice(values, size=int(neg.sum()))

            alpha = self.ss ** distances.astype(np.float64)
            new_fitnesses = alpha * signals + (1 - alpha) * noise
            fitnesses[~cached] = new_fitnesses

            # Cache predictions for determinism (reference :96-99).
            self.cache.update(zip(uncached, new_fitnesses))
            seen = set()
            fresh = [s for s in uncached if not (s in seen or seen.add(s))]
            self._append_cache(fresh)

        return np.array(fitnesses)
