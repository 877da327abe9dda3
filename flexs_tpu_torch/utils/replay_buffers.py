"""Replay buffers for RL explorers (DQN) and BO.

Contract (reference flexs/utils/replay_buffers.py):
  * `ReplayBuffer(obs_dim, size, batch_size)` ring buffer with
    `store(obs, act, rew, next_obs)`, uniform `sample_batch()` without
    replacement, `len()` == current fill (:142-178).
  * `PrioritizedReplayBuffer(obs_dim, size, batch_size, alpha)`:
    proportional prioritized sampling with stratified segments,
    importance-sampling weights normalized by the max weight, and
    `update_priorities` (:181-280).

The reference drives OpenAI-baselines Python segment trees, O(log N) per
scalar op (:9-140).  Here priorities live in a flat numpy array, a whole
stratified batch is drawn with one cumsum + searchsorted, and the IS weights
of the batch are computed at once.  The buffers are host numpy, drawn from a
seeded numpy Generator in the JAX package's order, so both packages sample
the same indices for the same seed.
"""
from typing import Dict, List, Optional

import numpy as np


class ReplayBuffer:
    """A simple numpy ring replay buffer."""

    def __init__(
        self,
        obs_dim: int,
        size: int,
        batch_size: int = 128,
        seed: Optional[int] = None,
    ):
        """Create a buffer for `size` transitions of `obs_dim` observations."""
        self.obs_buf = np.zeros([size, obs_dim], dtype=np.float32)
        self.next_obs_buf = np.zeros([size, obs_dim], dtype=np.float32)
        self.acts_buf = np.zeros([size, obs_dim], dtype=np.float32)
        self.rews_buf = np.zeros([size], dtype=np.float32)
        self.max_size, self.batch_size = size, batch_size
        self.ptr, self.size = 0, 0
        self._rng = np.random.default_rng(seed)

    def store(
        self, obs: np.ndarray, act: np.ndarray, rew: float, next_obs: np.ndarray
    ):
        """Store one timestep."""
        self.obs_buf[self.ptr] = obs
        self.next_obs_buf[self.ptr] = next_obs
        self.acts_buf[self.ptr] = act
        self.rews_buf[self.ptr] = rew
        self.ptr = (self.ptr + 1) % self.max_size
        self.size = min(self.size + 1, self.max_size)

    def sample_batch(self) -> Dict[str, np.ndarray]:
        """Sample `batch_size` timesteps uniformly without replacement."""
        idxs = self._rng.choice(self.size, size=self.batch_size, replace=False)
        return dict(
            obs=self.obs_buf[idxs],
            next_obs=self.next_obs_buf[idxs],
            acts=self.acts_buf[idxs],
            rews=self.rews_buf[idxs],
        )

    def __len__(self) -> int:
        """len(buffer) == number of stored transitions."""
        return self.size


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritized replay with stratified sampling.

    Attributes:
        max_priority: Running max of raw priorities (new entries get it).
        alpha: Priority exponent.
    """

    def __init__(
        self,
        obs_dim: int,
        size: int,
        batch_size: int = 32,
        alpha: float = 0.6,
        seed: Optional[int] = None,
    ):
        """Create a prioritized buffer (`alpha >= 0`)."""
        assert alpha >= 0

        super().__init__(obs_dim, size, batch_size, seed=seed)
        self.max_priority = 1.0
        self.alpha = alpha
        self._priorities = np.zeros(size, dtype=np.float64)

    def store(self, obs: np.ndarray, act, rew: float, next_obs: np.ndarray):
        """Store a transition at max priority."""
        self._priorities[self.ptr] = self.max_priority**self.alpha
        super().store(obs, act, rew, next_obs)

    def _sample_proportional(self) -> np.ndarray:
        """Stratified proportional sampling, fully vectorized.

        One uniform draw per equal-probability segment, mapped to indices
        through the cumulative priority mass (replaces per-draw segment-tree
        descent, reference :254-267).
        """
        p = self._priorities[: self.size]
        cumsum = np.cumsum(p)
        total = cumsum[-1]
        segment = total / self.batch_size
        bounds = segment * (
            np.arange(self.batch_size) + self._rng.random(self.batch_size)
        )
        return np.searchsorted(cumsum, bounds, side="right").clip(0, self.size - 1)

    def sample_batch(self, beta: float = 0.4) -> Dict[str, np.ndarray]:
        """Sample a prioritized batch with importance-sampling weights."""
        assert len(self) >= self.batch_size
        assert beta > 0

        indices = self._sample_proportional()

        p = self._priorities[: self.size]
        total = p.sum()
        # IS weights, normalized by the maximum weight (reference :269-280).
        p_min = p[p > 0].min() / total
        max_weight = (p_min * self.size) ** (-beta)
        p_sample = p[indices] / total
        weights = (p_sample * self.size) ** (-beta) / max_weight

        return dict(
            obs=self.obs_buf[indices],
            next_obs=self.next_obs_buf[indices],
            acts=self.acts_buf[indices],
            rews=self.rews_buf[indices],
            weights=weights,
            indices=indices,
        )

    def update_priorities(self, indices: List[int], priorities: np.ndarray):
        """Update priorities of sampled transitions."""
        indices = np.asarray(indices)
        priorities = np.asarray(priorities, dtype=np.float64)
        assert len(indices) == len(priorities)
        assert (priorities > 0).all()
        assert (0 <= indices).all() and (indices < len(self)).all()

        self._priorities[indices] = priorities**self.alpha
        self.max_priority = max(self.max_priority, float(priorities.max()))
