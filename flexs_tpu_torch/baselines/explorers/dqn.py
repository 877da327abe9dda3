"""DQN explorer.

Contract (reference baselines/explorers/dqn.py, through the JAX package's
`baselines/explorers/dqn.py`):
  * name "DQN_Explorer" (:88).
  * Q network: Linear(2*A*L -> A*L) -> relu -> BN -> Linear(A*L -> L) ->
    relu -> BN -> Linear(L -> 1) -> relu (:23-44).  The reference keeps the
    net in eval() mode, so its batch norms always normalize with stored
    statistics (mean 0, var 1 at init), never with batch statistics.  As in
    the JAX package, whose optimizer differentiates the whole variables
    dict, Adam trains those stored means and variances like weights, and
    the L1 clip spans their gradients too: here they are parameters of the
    net (`BatchNorm(trainable_stats=True)`).
  * Q(s, a) for ALL one-hot actions of a state batch (:140-149).  The
    first layer of concat(s, e_a) is W_s s + W_a[:, a] + b, so it is
    computed once per state and broadcast over the actions instead of
    running the [B * A * L, 2 * A * L] repeat-trick product.
  * epsilon-greedy mutation walk over a single state; "staying in place"
    masked out by zeroing moves at currently-set one-hot positions
    (:190-244); epsilon = max(0.1, 0.5 - cost/(batch*rounds)) (:252-255).
  * PER memory (alpha 0.6); `train_epochs` Adam(1e-3) steps after the L1
    gradient clip at 1.0, with a FRESH Adam state at every training call
    (:170-186, :268-273); TD target = r + gamma * max_a' Q(s', a') of the
    same network, no target network, unweighted MSE.
  * Proposes top `sequences_batch_size` generated sequences by model score.

The walk rolls `sequences_batch_size` steps at a time and scores each
chunk in one model call (the JAX package's restructuring, see
`propose_sequences`).  The walk's and the memory's draws come from a seeded
numpy Generator in the JAX package's order; the Q network's init from a
`torch.Generator` seeded from `seed`.
"""
from typing import Optional, Tuple

import numpy as np
import pandas as pd
import torch
from torch import nn

from flexs_tpu_torch.alphabet import as_alphabet
from flexs_tpu_torch.baselines.models.torch_model import (
    BatchNorm,
    adam_init,
    adam_step_,
    flat_grad,
    flatten_parameters,
    linear,
)
from flexs_tpu_torch.device import resolve_device
from flexs_tpu_torch.explorer import Explorer
from flexs_tpu_torch.model import Model
from flexs_tpu_torch.utils.replay_buffers import PrioritizedReplayBuffer


class QNetwork(nn.Module):
    """Q(s, a) network over concatenated one-hot state and action (Flax's layer names)."""

    def __init__(self, seq_len: int, alphabet_len: int, generator: torch.Generator):
        super().__init__()
        dim = alphabet_len * seq_len
        self.dim = dim
        self.Dense_0 = linear(2 * dim, dim, generator)
        self.BatchNorm_0 = BatchNorm(dim, device=generator.device, trainable_stats=True)
        self.Dense_1 = linear(dim, seq_len, generator)
        self.BatchNorm_1 = BatchNorm(seq_len, device=generator.device, trainable_stats=True)
        self.Dense_2 = linear(seq_len, 1, generator)

    def head(self, h: torch.Tensor) -> torch.Tensor:
        """Everything after the first layer's pre-activation h [..., dim] -> [...]."""
        x = self.BatchNorm_0(torch.relu(h))
        x = self.BatchNorm_1(torch.relu(self.Dense_1(x)))
        return torch.relu(self.Dense_2(x))[..., 0]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Q of concat(state, action) rows f32[B, 2 * dim] -> f32[B]."""
        return self.head(self.Dense_0(x))

    def all_actions(self, states: torch.Tensor) -> torch.Tensor:
        """Q(s, a) f32[B, dim] of every one-hot action a for states f32[B, dim]."""
        w = self.Dense_0.weight  # [dim, 2 * dim]
        h_state = torch.matmul(states, w[:, : self.dim].T) + self.Dense_0.bias  # [B, dim]
        h = h_state[:, None, :] + w[:, self.dim:].T[None, :, :]  # [B, action, dim]
        return self.head(h)


# Elements of a [states, actions, width] first-layer block that the next
# states' Q values may take at once (1 GiB of float32); more states are
# taken in chunks.
NEXT_Q_ELEMENTS = 1 << 28


def max_next_q(q_network: QNetwork, next_obs: torch.Tensor) -> torch.Tensor:
    """max_a Q(s', a) f32[B] of next states f32[B, dim], in chunks of states.

    A chunk holds at most `NEXT_Q_ELEMENTS` elements of the [chunk, dim,
    dim] first-layer block, so a wide alphabet and sequence (3MSI's dim is
    1,320) never needs more memory than that.
    """
    per_state = q_network.dim * q_network.dim
    step = max(1, NEXT_Q_ELEMENTS // per_state)
    return torch.cat([
        q_network.all_actions(next_obs[i:i + step]).amax(dim=1)
        for i in range(0, next_obs.shape[0], step)
    ])


def train_step(q_network: QNetwork, opt_state, obs, acts, rews, next_obs,
               gamma: float) -> torch.Tensor:
    """One Adam(1e-3) step of the TD loss after the global L1 clip at 1.0; the loss.

    TD target r + gamma * max_a' Q(s', a') of the same network (no target
    network), unweighted MSE; the clip spans every gradient, the BatchNorm
    statistics' too (the JAX package's optax chain).  `opt_state` is an
    `adam_init` state over the net's flat parameters.
    """
    q_sa = q_network(torch.cat([obs, acts], dim=1))
    with torch.no_grad():
        target = max_next_q(q_network, next_obs) * gamma + rews
    # The reference uses an unweighted MSELoss (:167-171); the PER
    # importance weights are sampled but unused there, as here.
    loss = torch.mean(torch.square(q_sa - target))
    grads = flat_grad(loss, q_network)
    # Clip by the global L1 norm (every gradient, the statistics' too).
    norm = torch.sum(torch.abs(grads))
    grads = grads * torch.clamp(1.0 / (norm + 1e-12), max=1.0)
    adam_step_(opt_state, grads[None], 1e-3)
    return loss.detach()


class DQN(Explorer):
    """DQN explorer: epsilon-greedy mutation walk guided by a Q network."""

    def __init__(
        self,
        model: Model,
        rounds: int,
        sequences_batch_size: int,
        model_queries_per_batch: int,
        starting_sequence: str,
        alphabet: str,
        log_file: Optional[str] = None,
        memory_size: int = 100000,
        train_epochs: int = 20,
        gamma: float = 0.9,
        seed: int = 0,
        device=None,
    ):
        """Create the DQN explorer.

        Args:
            memory_size: Size of agent replay memory.
            train_epochs: Minibatch updates per training call.
            gamma: Discount factor.
            seed: Seed of the walk's numpy Generator and of the Q network's
                init (the reference uses unseeded global randomness).
            device: Where the Q network lives and trains (default "cuda";
                pass "cpu" to run on the CPU).
        """
        name = "DQN_Explorer"
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
        self.alphabet_size = len(self.alphabet)
        self.memory_size = memory_size
        self.gamma = gamma
        self.best_fitness = 0
        self.train_epochs = train_epochs
        self.epsilon_min = 0.1
        self.top_sequence = []
        self.num_actions = 0

        self.seq_len = len(starting_sequence)
        self._dim = self.alphabet_size * self.seq_len
        self._rng = np.random.default_rng(seed)
        self.device = resolve_device(device)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)

        self.state = None
        self.memory = None
        self.q_network: Optional[QNetwork] = None
        self._flat = None

    # -- device programs ----------------------------------------------------
    @torch.no_grad()
    def all_action_q(self, states: np.ndarray) -> np.ndarray:
        """Q values f32[B, dim] of every one-hot action for states f32[B, dim]."""
        states = torch.as_tensor(np.asarray(states, np.float32), device=self.device)
        return self.q_network.all_actions(states).cpu().numpy()

    def _train(self, obs, acts, rews, next_obs) -> torch.Tensor:
        """`train_epochs` Adam steps on stacked PER batches [E, B, ...]; mean loss."""
        opt_state = adam_init(self._flat[None])
        losses = [
            train_step(self.q_network, opt_state, *batch, self.gamma)
            for batch in zip(obs, acts, rews, next_obs)
        ]
        return torch.stack(losses).mean()

    # -- setup --------------------------------------------------------------
    def initialize_data_structures(self):
        """(Re)build state, Q network, and replay memory."""
        one_hot = np.zeros((self.seq_len, self.alphabet_size), dtype=np.float32)
        tokens = self.alphabet.encode_one(self.starting_sequence)
        one_hot[np.arange(self.seq_len), tokens] = 1
        self.state = one_hot

        self.q_network = QNetwork(self.seq_len, self.alphabet_size, self._generator)
        self._flat = flatten_parameters(self.q_network)
        self.memory = PrioritizedReplayBuffer(
            self._dim,
            self.memory_size,
            self.sequences_batch_size,
            0.6,
            seed=int(self._rng.integers(2**31)),
        )

    def train_actor(self, train_epochs: int) -> float:
        """Train the Q network on `train_epochs` PER batches."""
        batches = [self.memory.sample_batch() for _ in range(train_epochs)]

        def stack(k):
            return torch.as_tensor(
                np.stack([b[k] for b in batches]).astype(np.float32), device=self.device
            )

        loss = self._train(stack("obs"), stack("acts"), stack("rews"), stack("next_obs"))
        return float(loss)

    # -- walk ---------------------------------------------------------------
    def get_action_and_mutant(self, epsilon: float):
        """Pick an action (epsilon-greedy over masked Q values), mutate state."""
        q = self.all_action_q(self.state.reshape(1, -1)).reshape(
            self.seq_len, self.alphabet_size
        )

        # Mask out "stay in place" moves.
        moves = q * (1 - self.state)

        if moves.sum() > 0:
            if self._rng.random() < epsilon:
                nz = np.argwhere(moves != 0)
                x, y = nz[self._rng.integers(len(nz))]
            else:
                x, y = np.unravel_index(np.argmax(moves), moves.shape)
            action = np.zeros_like(moves)
            action[x, y] = moves[x, y]
        else:
            # Fresh networks can output all zeros; take a uniform move.
            action = np.zeros_like(moves)
            action[
                self._rng.integers(self.seq_len),
                self._rng.integers(self.alphabet_size),
            ] = 1

        mutant = self.state.copy()
        (pos,) = np.nonzero(action.sum(axis=1))
        mutant[pos] = 0
        mutant[pos, np.argmax(action[pos], axis=1)] = 1
        self.state = mutant
        return action, mutant

    def propose_sequences(
        self, measured_sequences_data: pd.DataFrame
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Propose top `sequences_batch_size` sequences for evaluation.

        The epsilon-greedy walk is reward-INDEPENDENT (the state always
        moves to the chosen mutant, reference :225-243), so the walk rolls
        forward `sequences_batch_size` steps at a time and each chunk's
        mutants are scored in ONE batched model call instead of one
        singleton call per step (reference :258-297).  Q training fires
        after each chunk: the reference's every-`sequences_batch_size`-
        queries cadence (:268-273).  Documented deviation: epsilon anneals
        per chunk rather than per step, and best-fitness / PER storage
        update after each chunk's scoring instead of per step.
        """
        if self.memory is None:
            self.initialize_data_structures()

        all_measured_seqs = set(measured_sequences_data["sequence"].values)
        sequences = {}

        remaining = self.model_queries_per_batch
        while remaining > 0:
            n_steps = min(self.sequences_batch_size, remaining)
            eps = max(
                self.epsilon_min,
                0.5 - self.model.cost / (self.sequences_batch_size * self.rounds),
            )
            # Phase 1: roll the walk (Q-network only, no oracle queries).
            prev_states = np.empty((n_steps, self.seq_len, self.alphabet_size))
            actions = np.empty_like(prev_states)
            next_states = np.empty_like(prev_states)
            for i in range(n_steps):
                prev_states[i] = self.state
                actions[i], next_states[i] = self.get_action_and_mutant(eps)
            # Phase 2: one batched scoring call for the whole chunk.
            tokens = np.argmax(next_states, axis=2).astype(np.int32)
            strings = self.alphabet.decode(tokens)
            rewards = np.asarray(self.model.get_fitness(strings), dtype=np.float64)
            remaining -= n_steps
            # Phase 3: bookkeeping + PER storage + train trigger.
            for i, seq in enumerate(strings):
                sequences[seq] = rewards[i]
                if seq not in all_measured_seqs:
                    if rewards[i] >= self.best_fitness:
                        self.top_sequence.append(
                            (rewards[i], next_states[i], self.model.cost)
                        )
                    self.best_fitness = max(self.best_fitness, float(rewards[i]))
                    self.memory.store(
                        prev_states[i].ravel(),
                        actions[i].ravel(),
                        float(rewards[i]),
                        next_states[i].ravel(),
                    )
                    all_measured_seqs.add(seq)
            if len(self.memory) >= self.sequences_batch_size:
                self.train_actor(self.train_epochs)
            self.num_actions += n_steps

        new_seqs = np.array(list(sequences.keys()))
        preds = np.array(list(sequences.values()))
        sorted_order = np.argsort(preds)[: -self.sequences_batch_size : -1]

        return new_seqs[sorted_order], preds[sorted_order]
