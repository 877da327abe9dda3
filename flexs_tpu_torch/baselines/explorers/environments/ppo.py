"""Mutation-walk environment for the PPO explorer.

Contract (reference explorers/environments/ppo.py):
  * Observation: one-hot [L, A] sequence + current fitness; action: flat
    index pos * A + res (:55-76).
  * Step semantics (:104-141): force-terminate past `max_num_steps`;
    terminate with reward 0 on a no-op action (mutating a position to its
    current residue); terminate with reward -1 on revisiting a sequence
    within the episode; terminate with reward = fitness when fitness
    decreases; otherwise transition with reward = fitness.
  * Every step (and reset) queries the model once — the query budget is
    enforced by the explorer through `model.cost`.

This is a plain Python class (no TF-Agents dependency); the policy itself
is the agent in flexs_tpu_torch.rl.ppo.
"""
from typing import Tuple

import numpy as np

from flexs_tpu_torch.alphabet import as_alphabet
from flexs_tpu_torch.model import Model


class PPOEnvironment:
    """Single-sequence mutation walk with stop-on-decrease dynamics."""

    TRANSITION = 0
    TERMINATION = 1

    def __init__(
        self,
        alphabet: str,
        starting_seq: str,
        model: Model,
        max_num_steps: int,
    ):
        """Create the environment.

        Args:
            alphabet: Usually UCGA.
            starting_seq: Sequence the walk initially mutates.
            model: Model or landscape that evaluates each sequence.
            max_num_steps: Hard per-episode step cap (usually
                `model_queries_per_batch`).
        """
        self.alphabet = as_alphabet(alphabet)
        self.model = model
        self.seq = starting_seq
        self.seq_len = len(starting_seq)
        self.num_actions = self.seq_len * len(self.alphabet)
        self.max_num_steps = max_num_steps

        self.previous_fitness = -float("inf")
        self.num_steps = 0
        self.episode_seqs = set()
        self.state = None
        self.fitness = None

    def _one_hot(self, seq: str) -> np.ndarray:
        tokens = self.alphabet.encode_one(seq)
        out = np.zeros((self.seq_len, len(self.alphabet)), np.float32)
        out[np.arange(self.seq_len), tokens] = 1
        return out

    def get_state_string(self) -> str:
        """Decode the current one-hot state."""
        return self.alphabet.decode_one(
            np.argmax(self.state, axis=1).astype(np.int32)
        )

    def reset(self) -> np.ndarray:
        """Start a new episode from `self.seq`; costs one model query."""
        self.previous_fitness = -float("inf")
        self.state = self._one_hot(self.seq)
        self.fitness = float(np.asarray(self.model.get_fitness([self.seq]))[0])
        self.episode_seqs = set()
        self.num_steps = 0
        return self.state.copy()

    def step(self, action: int) -> Tuple[np.ndarray, float, bool]:
        """Apply a flat mutation action; returns (state, reward, done)."""
        if self.num_steps >= self.max_num_steps:
            return self.state.copy(), 0.0, True

        pos = action // len(self.alphabet)
        res = action % len(self.alphabet)
        self.num_steps += 1

        # No-op: trying to set the residue already there.
        if self.state[pos, res] == 1:
            return self.state.copy(), 0.0, True

        self.state[pos] = 0
        self.state[pos, res] = 1
        state_string = self.get_state_string()
        self.fitness = float(
            np.asarray(self.model.get_fitness([state_string]))[0]
        )

        if state_string in self.episode_seqs:
            return self.state.copy(), -1.0, True
        self.episode_seqs.add(state_string)

        if self.fitness < self.previous_fitness:
            return self.state.copy(), self.fitness, True

        self.previous_fitness = self.fitness
        return self.state.copy(), self.fitness, False
