"""DyNA-PPO environments (batched constructive + mutative).

Contract (reference explorers/environments/dyna_ppo.py):
  * `DynaPPOEnvironment`: `batch_size` episodes stepped in lockstep; state
    is one-hot [L, A+1] with a mask column marking unwritten positions
    (:44-48); each step writes one residue into every episode (:129-136);
    on completion the whole batch is scored in one call against the ground
    truth landscape or the surrogate model depending on
    `fitness_model_is_gt` (:142-152); reward = fitness - lam * density
    with lam = 0.1 (:154-160).  Deviation (documented): the reference
    terminates one step early, leaving the final residue as the mask
    argmax fallback (:139-141); here all L residues are generated.
  * `sequence_density(seq)`: sum of fitness/distance over all previously
    seen sequences within distance 2 (:106-114).  The reference scans the
    cache with per-pair C editdistance calls; here the whole batch's
    distances to the cache are ONE banded-Levenshtein DP on the
    environment's device (flexs_tpu_torch.ops.hamming.
    banded_edit_distance_matrix: exact edit distance up to the radius,
    saturated beyond it), so shift-by-one neighbors are weighted exactly
    as the reference's `editdistance.eval` weights them; the weighted sum
    is float64 numpy on the host, in cache order.  Deviation (documented,
    as in the JAX package): densities are computed BEFORE the batch joins
    the cache, so same-batch neighbors do not penalize each other; the
    reference updates all_seqs first (:142-163 upstream) and they do.
  * `DynaPPOEnvironmentMutative`: single-sequence mutation walk with the
    density-augmented reward and gt/model switch (:166-336).
"""
from typing import Tuple

import numpy as np
import torch

from flexs_tpu_torch.alphabet import as_alphabet
from flexs_tpu_torch.landscape import Landscape
from flexs_tpu_torch.model import Model
from flexs_tpu_torch.device import resolve_device
from flexs_tpu_torch.ops.hamming import banded_edit_distance_matrix
from flexs_tpu_torch.ops.padding import next_bucket, pad_rows


class _SeqDensityCache:
    """Fitness-weighted density over all observed sequences.

    The cache's tokens live on `device` in insertion order, in a buffer
    grown by `pad_rows` to power-of-two capacities (filler rows -1); the
    fitnesses are a float64 host array in the same order.
    """

    def __init__(self, alphabet, dist_radius: int = 2, device=None):
        self.alphabet = alphabet
        self.dist_radius = dist_radius
        self.device = resolve_device(device)
        self.all_seqs = {}
        self._index = {}
        self._fitness = np.zeros(0, np.float64)
        self._tokens = None  # int64[capacity, L] on device

    def update(self, seqs, fitnesses):
        fitnesses = np.asarray(fitnesses, np.float64)
        self.all_seqs.update(zip(seqs, fitnesses))
        new = [s for s in dict.fromkeys(seqs) if s not in self._index]
        n = len(self._index)
        if new:
            tokens = torch.as_tensor(self.alphabet.encode(new), device=self.device).long()
            capacity = next_bucket(n + len(new), minimum=64)
            if self._tokens is None:
                self._tokens = torch.full((0, tokens.shape[1]), -1, dtype=torch.long,
                                          device=self.device)
            if self._tokens.shape[0] < capacity:
                self._tokens = pad_rows(self._tokens, capacity, fill=-1)
            self._tokens[n:n + len(new)] = tokens
            self._index.update((s, n + i) for i, s in enumerate(new))
            self._fitness = pad_rows(self._fitness, capacity)
        for s, f in zip(seqs, fitnesses):
            self._fitness[self._index[s]] = f

    def distances(self, seqs) -> np.ndarray:
        """Banded edit distances int32[len(seqs), cache size] on the host."""
        q = torch.as_tensor(self.alphabet.encode(list(seqs)), device=self.device).long()
        c = self._tokens[: len(self._index)]
        return banded_edit_distance_matrix(q, c, band=self.dist_radius).cpu().numpy()

    def densities(self, seqs) -> np.ndarray:
        """density(seq) = sum_{s: 0 < d(s, seq) <= r} fitness(s) / d."""
        if not self.all_seqs:
            return np.zeros(len(seqs))
        dists = self.distances(seqs)
        weights = np.where(
            (dists > 0) & (dists <= self.dist_radius), 1.0 / np.maximum(dists, 1), 0.0
        )
        return weights @ self._fitness[: len(self._index)]


class DynaPPOEnvironment:
    """Batched constructive environment: one residue per step per episode."""

    def __init__(
        self,
        alphabet: str,
        seq_length: int,
        model: Model,
        landscape: Landscape,
        batch_size: int,
        device=None,
    ):
        """Create a batched constructive environment.

        Args:
            alphabet: Usually UCGA.
            seq_length: Length of sequences to build.
            model: Surrogate model (model-based rounds).
            landscape: True fitness landscape (experiment-based rounds).
            batch_size: Episodes run in lockstep.
            device: Where the density cache's distances are computed
                (default "cuda"; pass "cpu" to run on the CPU).
        """
        self.alphabet = as_alphabet(alphabet)
        self.batch_size = batch_size
        self.seq_length = seq_length
        self.num_actions = len(self.alphabet)
        self.obs_dim = seq_length * (len(self.alphabet) + 1)

        self.model = model
        self.landscape = landscape
        self.fitness_model_is_gt = False
        self.lam = 0.1
        self._density = _SeqDensityCache(self.alphabet, device=device)

        self.partial_seq_len = 0
        self.states = None

    @property
    def all_seqs(self):
        """Cache of every sequence seen (for fitness lookups)."""
        return self._density.all_seqs

    def get_cached_fitness(self, seq: str) -> float:
        """Fitness recorded when `seq`'s episode completed."""
        return self._density.all_seqs[seq]

    def set_fitness_model_to_gt(self, fitness_model_is_gt: bool):
        """True => experiment-based (landscape) scoring; False => model."""
        self.fitness_model_is_gt = fitness_model_is_gt

    def sequence_density(self, seq: str) -> float:
        """Density of observed sequences within distance 2 of `seq`."""
        return float(self._density.densities([seq])[0])

    def reset(self) -> np.ndarray:
        """Start a fresh batch of empty sequences."""
        self.partial_seq_len = 0
        self.states = np.zeros(
            (self.batch_size, self.seq_length, len(self.alphabet) + 1), np.float32
        )
        self.states[:, np.arange(self.seq_length), -1] = 1
        return self.states.reshape(self.batch_size, -1).copy()

    def step(self, actions) -> Tuple[np.ndarray, np.ndarray, bool]:
        """Write one residue per episode; score the batch at full length."""
        actions = np.asarray(actions).flatten()
        self.states[:, self.partial_seq_len, -1] = 0
        self.states[np.arange(self.batch_size), self.partial_seq_len, actions] = 1
        self.partial_seq_len += 1

        obs = self.states.reshape(self.batch_size, -1).copy()
        if self.partial_seq_len < self.seq_length:
            return obs, np.zeros(self.batch_size), False

        tokens = np.argmax(self.states[:, :, :-1], axis=2).astype(np.int32)
        complete = self.alphabet.decode(tokens)
        if self.fitness_model_is_gt:
            fitnesses = np.asarray(self.landscape.get_fitness(complete))
        else:
            fitnesses = np.asarray(self.model.get_fitness(complete))

        densities = self._density.densities(complete)
        self._density.update(complete, fitnesses)
        rewards = fitnesses - self.lam * densities
        return obs, rewards, True


class DynaPPOEnvironmentMutative:
    """Mutative walk with density-augmented reward and gt/model switch."""

    def __init__(
        self,
        alphabet: str,
        starting_seq: str,
        model: Model,
        landscape: Landscape,
        max_num_steps: int,
        device=None,
    ):
        """Create the mutative environment (density cache on `device`, default "cuda")."""
        self.alphabet = as_alphabet(alphabet)
        self.model = model
        self.landscape = landscape
        self.fitness_model_is_gt = False
        self.previous_fitness = -float("inf")

        self.seq = starting_seq
        self.seq_len = len(starting_seq)
        self.num_actions = self.seq_len * len(self.alphabet)
        self.lam = 0.1
        self._density = _SeqDensityCache(self.alphabet, device=device)

        self.num_steps = 0
        self.max_num_steps = max_num_steps
        self.episode_seqs = set()
        self.state = None
        self.fitness = None

    @property
    def all_seqs(self):
        return self._density.all_seqs

    def set_fitness_model_to_gt(self, fitness_model_is_gt: bool):
        """True => landscape scoring; False => surrogate scoring."""
        self.fitness_model_is_gt = fitness_model_is_gt

    def sequence_density(self, seq: str) -> float:
        return float(self._density.densities([seq])[0])

    def _one_hot(self, seq: str) -> np.ndarray:
        tokens = self.alphabet.encode_one(seq)
        out = np.zeros((self.seq_len, len(self.alphabet)), np.float32)
        out[np.arange(self.seq_len), tokens] = 1
        return out

    def get_state_string(self) -> str:
        return self.alphabet.decode_one(
            np.argmax(self.state, axis=1).astype(np.int32)
        )

    def _score(self, seq: str) -> float:
        oracle = self.landscape if self.fitness_model_is_gt else self.model
        return float(np.asarray(oracle.get_fitness([seq]))[0])

    def reset(self) -> np.ndarray:
        self.previous_fitness = -float("inf")
        self.state = self._one_hot(self.seq)
        self.fitness = self._score(self.seq)
        self.episode_seqs = set()
        self.num_steps = 0
        return self.state.copy()

    def step(self, action: int) -> Tuple[np.ndarray, float, bool]:
        """Apply one mutation; terminate on no-op/repeat/reward decrease."""
        if self.num_steps >= self.max_num_steps:
            return self.state.copy(), 0.0, True

        pos = action // len(self.alphabet)
        res = action % len(self.alphabet)
        self.num_steps += 1

        if self.state[pos, res] == 1:
            return self.state.copy(), 0.0, True

        self.state[pos] = 0
        self.state[pos, res] = 1
        state_string = self.get_state_string()
        self.fitness = self._score(state_string)

        density = self.sequence_density(state_string)
        self._density.update([state_string], [self.fitness])
        reward = self.fitness - self.lam * density

        if state_string in self.episode_seqs:
            return self.state.copy(), -1.0, True
        self.episode_seqs.add(state_string)

        if reward < self.previous_fitness:
            return self.state.copy(), reward, True

        self.previous_fitness = reward
        return self.state.copy(), reward, False
