"""Minimal PPO agent (actor-critic, clipped surrogate objective) in PyTorch.

Contract (the JAX package's `rl/ppo.py`, which replaces the reference's
TF-Agents PPOAgent, reference ppo.py:80-91 and dyna_ppo.py:193-211):
  * `ActorCritic`: separate tanh towers of `fc_layers` widths for the actor
    (logits over the actions) and the critic (one value), over flattened
    observations.
  * Running observation normalization: Chan's parallel Welford combine in
    float64 numpy, count starting at 1e-4 and M2 at 1; `train` normalizes
    with the statistics in effect at collection time, then folds the batch
    in.
  * `act`: logits of masked actions set to -inf, one categorical draw per
    row (Gumbel-max, from the agent's `torch.Generator`), with the draw's
    log-probability and the critic's value.
  * `train`: GAE(lambda) advantages cut at episode ends, normalized;
    `train_epochs` full-batch Adam steps (optax's arithmetic, state kept
    across calls) on the clipped surrogate (epsilon 0.2) + 0.5 * value MSE
    - 0.01 * entropy, the masked log-probabilities set to 0 before the
    entropy product (0 * -inf is NaN in the gradient).

The fused RL runners' PPO (the JAX package's `runtime/ppo_runner.py:453-507`
and both DynaPPO runners, which each carry their own copy) is here once,
on tensors with a leading cell axis and a validity mask: `gae` (a reverse
time loop with episode cuts), `normalize_advantages` and `welford_merge`
over the valid rows, `normalize_obs`, `act_cells` (each cell's own net and
generator) and `ppo_update` (full-batch clipped-surrogate epochs under
Adam, the gradient summed over row chunks).  Those runners keep their
statistics in float32 and fold a batch in before normalizing it, as the
JAX runners do.
"""
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch import nn

from flexs_tpu_torch.baselines.models.torch_model import (
    adam_init,
    adam_step_,
    flat_grad,
    flatten_parameters,
    linear,
)
from flexs_tpu_torch.device import resolve_device


class ActorCritic(nn.Module):
    """Separate fc actor and critic towers over flattened observations.

    Layers keep Flax's names and order: `Dense_0..` the actor's hidden
    layers, then its logits, then the critic's hidden layers and value.
    """

    def __init__(self, obs_dim: int, num_actions: int, fc_layers: Sequence[int],
                 generator: torch.Generator):
        super().__init__()
        widths = [obs_dim, *fc_layers]
        layers = [linear(a, b, generator) for a, b in zip(widths, widths[1:])]
        layers.append(linear(widths[-1], num_actions, generator))
        layers += [linear(a, b, generator) for a, b in zip(widths, widths[1:])]
        layers.append(linear(widths[-1], 1, generator))
        self.depth = len(fc_layers)
        for i, layer in enumerate(layers):
            self.add_module(f"Dense_{i}", layer)

    def forward(self, obs: torch.Tensor):
        """(logits f32[B, actions], value f32[B]) of observations f32[B, obs_dim]."""
        layers = list(self.children())
        k = self.depth
        a = obs
        for layer in layers[:k]:
            a = torch.tanh(layer(a))
        logits = layers[k](a)
        v = obs
        for layer in layers[k + 1: 2 * k + 1]:
            v = torch.tanh(layer(v))
        return logits, layers[2 * k + 1](v)[..., 0]


class PPOAgent:
    """Clipped-surrogate PPO over integer action spaces."""

    def __init__(
        self,
        obs_dim: int,
        num_actions: int,
        fc_layers: Sequence[int] = (128,),
        learning_rate: float = 3e-4,
        train_epochs: int = 10,
        clip_eps: float = 0.2,
        gamma: float = 0.99,
        gae_lambda: float = 0.95,
        value_coef: float = 0.5,
        entropy_coef: float = 0.01,
        normalize_observations: bool = True,
        seed: int = 0,
        device=None,
    ):
        """Create the agent on `device` (default "cuda"; pass "cpu" to run on the CPU).

        Defaults follow standard PPO practice (lr 3e-4, small entropy
        bonus, running observation normalization; TF-Agents normalizes
        observations and rewards by default too).
        """
        self.num_actions = num_actions
        self.learning_rate = learning_rate
        self.gamma = gamma
        self.gae_lambda = gae_lambda
        self.train_epochs = train_epochs
        self.clip_eps = clip_eps
        self.value_coef = value_coef
        self.entropy_coef = entropy_coef

        self.normalize_observations = normalize_observations
        self._obs_count = 1e-4
        self._obs_mean = np.zeros(obs_dim, np.float64)
        self._obs_m2 = np.ones(obs_dim, np.float64)

        self.device = resolve_device(device)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)
        self.net = ActorCritic(obs_dim, num_actions, tuple(fc_layers), self._generator)
        self._opt_state = adam_init(flatten_parameters(self.net)[None])

    # -- observation normalization -------------------------------------------
    def _update_obs_stats(self, obs: np.ndarray):
        # Chan's parallel Welford combine: one vectorized batch update.
        obs = np.asarray(obs, np.float64)
        n_b = obs.shape[0]
        if n_b == 0:
            return
        mean_b = obs.mean(axis=0)
        m2_b = ((obs - mean_b) ** 2).sum(axis=0)
        n_a = self._obs_count
        total = n_a + n_b
        delta = mean_b - self._obs_mean
        self._obs_mean = self._obs_mean + delta * (n_b / total)
        self._obs_m2 = self._obs_m2 + m2_b + delta**2 * (n_a * n_b / total)
        self._obs_count = total

    def _normalize(self, obs):
        if not self.normalize_observations:
            return obs
        var = self._obs_m2 / max(self._obs_count, 1.0)
        return (obs - self._obs_mean) / np.sqrt(var + 1e-8)

    def _tensor(self, a, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device).to(dtype)

    # -- acting -------------------------------------------------------------
    @torch.no_grad()
    def act(self, obs: np.ndarray, action_mask: Optional[np.ndarray] = None):
        """Sample actions for a [B, obs_dim] observation batch.

        Returns (actions, logprobs, values) as numpy arrays.
        """
        obs = self._tensor(self._normalize(np.asarray(obs)))
        logits, value = self.net(obs)
        if action_mask is not None:
            logits = torch.where(self._tensor(action_mask, torch.bool), logits, -torch.inf)
        # Gumbel-max: argmax(logits + Gumbel) is a categorical draw.
        exponential = torch.empty_like(logits).exponential_(generator=self._generator)
        action = torch.argmax(logits - torch.log(exponential), dim=1)
        logprob = torch.log_softmax(logits, dim=1).gather(1, action[:, None])[:, 0]
        return action.cpu().numpy(), logprob.cpu().numpy(), value.cpu().numpy()

    # -- training -----------------------------------------------------------
    def compute_gae(self, rewards, values, dones, last_value=0.0):
        """GAE(lambda) advantages + returns over a flat step sequence.

        `dones[t]` marks the step that ENDS an episode; bootstrapping stops
        there.
        """
        T = len(rewards)
        adv = np.zeros(T, np.float32)
        last_adv = 0.0
        next_value = last_value
        for t in reversed(range(T)):
            # The (1 - done) factor cuts both the bootstrap and the
            # advantage recursion at the episode boundary.
            nonterminal = 1.0 - float(dones[t])
            delta = rewards[t] + self.gamma * next_value * nonterminal - values[t]
            last_adv = delta + self.gamma * self.gae_lambda * nonterminal * last_adv
            adv[t] = last_adv
            next_value = values[t]
        returns = adv + values
        return adv, returns

    def loss(self, obs, actions, old_logprobs, adv, returns, masks) -> torch.Tensor:
        """The clipped-surrogate PPO loss of one full batch."""
        logits, values = self.net(obs)
        logits = torch.where(masks, logits, -torch.inf)
        logps = torch.log_softmax(logits, dim=1)
        logprob = logps.gather(1, actions[:, None])[:, 0]
        ratio = torch.exp(logprob - old_logprobs)
        clipped = torch.clamp(ratio, 1 - self.clip_eps, 1 + self.clip_eps)
        policy_loss = -torch.mean(torch.minimum(ratio * adv, clipped * adv))
        value_loss = torch.mean(torch.square(values - returns))
        # Sanitize BEFORE multiplying: exp(logps) * logps is 0 * -inf = NaN
        # at masked entries.
        safe_logps = torch.where(masks, logps, 0.0)
        entropy = -torch.mean(torch.sum(torch.exp(safe_logps) * safe_logps * masks, dim=1))
        return policy_loss + self.value_coef * value_loss - self.entropy_coef * entropy

    def train(self, batch: Dict[str, np.ndarray]) -> float:
        """Run `train_epochs` full-batch PPO updates on a trajectory batch.

        batch keys: obs [T, obs_dim], actions [T], logprobs [T],
        rewards [T], dones [T], values [T]; optional masks [T, A].
        """
        adv, returns = self.compute_gae(
            np.asarray(batch["rewards"], np.float32),
            np.asarray(batch["values"], np.float32),
            np.asarray(batch["dones"]),
        )
        adv = (adv - adv.mean()) / (adv.std() + 1e-8)

        # Normalize with the stats in effect at COLLECTION time (act() used
        # them for old_logprobs/values), so the PPO ratio is exactly 1 at
        # epoch 0; fold this batch into the stats afterwards.
        obs = self._tensor(self._normalize(np.asarray(batch["obs"])))
        self._update_obs_stats(batch["obs"])
        actions = self._tensor(batch["actions"], torch.long)
        old_logprobs = self._tensor(batch["logprobs"])
        masks = batch.get("masks")
        if masks is None:
            masks = torch.ones((obs.shape[0], self.num_actions), dtype=torch.bool,
                               device=self.device)
        else:
            masks = self._tensor(masks, torch.bool)
        adv, returns = self._tensor(adv), self._tensor(returns)

        loss = torch.tensor(np.nan)
        for _ in range(self.train_epochs):
            loss = self.loss(obs, actions, old_logprobs, adv, returns, masks)
            adam_step_(self._opt_state, flat_grad(loss, self.net)[None], self.learning_rate)
        return float(loss.detach())


# -- The fused runners' PPO, on a leading cell axis ------------------------


class PPOConfig(NamedTuple):
    """The fused runners' PPO hyperparameters (the JAX runners' defaults)."""

    train_epochs: int = 10
    learning_rate: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    value_coef: float = 0.5
    entropy_coef: float = 0.01


class ObsStats(NamedTuple):
    """Running Welford statistics of the observations, one row per cell (float32)."""

    count: torch.Tensor  # f32[C]
    mean: torch.Tensor  # f32[C, D]
    m2: torch.Tensor  # f32[C, D]


def init_obs_stats(cells: int, dim: int, device) -> ObsStats:
    """Count 1e-4, mean 0, M2 1 (the JAX runners' start)."""
    return ObsStats(
        torch.full((cells,), 1e-4, device=device),
        torch.zeros((cells, dim), device=device),
        torch.ones((cells, dim), device=device),
    )


def normalize_obs(stats: ObsStats, obs: torch.Tensor) -> torch.Tensor:
    """obs f32[C, ..., D] standardized by each cell's running mean and variance."""
    shape = (obs.shape[0],) + (1,) * (obs.dim() - 2) + (obs.shape[-1],)
    var = stats.m2 / torch.clamp(stats.count, min=1.0)[:, None]
    return (obs - stats.mean.view(shape)) / torch.sqrt(var.view(shape) + 1e-8)


def welford_merge(stats: ObsStats, obs: torch.Tensor, valid: torch.Tensor) -> ObsStats:
    """Fold the valid rows of obs f32[C, N, D] (valid bool[C, N]) into each cell's statistics.

    Chan's parallel combine, in the JAX runner's order of operations
    (`ppo_runner.py:133-144`); a cell with no valid row keeps its statistics.
    """
    w = valid.float()[..., None]
    n_b = valid.sum(dim=1).float()
    mean_b = (obs * w).sum(dim=1) / torch.clamp(n_b, min=1.0)[:, None]
    m2_b = (torch.square(obs - mean_b[:, None]) * w).sum(dim=1)
    delta = mean_b - stats.mean
    tot = stats.count + n_b
    n_b, tot, count = n_b[:, None], tot[:, None], stats.count[:, None]
    return ObsStats(
        tot[:, 0],
        stats.mean + delta * n_b / tot,
        stats.m2 + m2_b + torch.square(delta) * count * n_b / tot,
    )


def gae(rewards: torch.Tensor, values: torch.Tensor, dones: torch.Tensor, gamma: float,
        gae_lambda: float) -> torch.Tensor:
    """GAE(lambda) advantages f32[..., T] over the last (time) axis, cut where `dones`.

    The reverse scan of `ppo_runner.py:457-471`: bootstrap and recursion stop
    at a step marked done, and the carry starts at 0 past the last step.
    Rows that are not valid steps must come as done with reward and value 0
    (their advantage is then 0 and they carry nothing).  Every operation is
    elementwise over the leading axes, so a cell's advantages do not depend
    on the other cells.
    """
    adv = torch.empty_like(rewards)
    last = torch.zeros(rewards.shape[:-1], device=rewards.device)
    next_value = torch.zeros_like(last)
    nonterminal = 1.0 - dones.float()
    for t in reversed(range(rewards.shape[-1])):
        nt = nonterminal[..., t]
        delta = rewards[..., t] + gamma * next_value * nt - values[..., t]
        last = delta + gamma * gae_lambda * nt * last
        adv[..., t] = last
        next_value = values[..., t]
    return adv


def normalize_advantages(adv: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """adv f32[C, N] less the mean of each cell's valid rows, over their std (+1e-8)."""
    n = torch.clamp(valid.sum(dim=1), min=1).float()[:, None]
    mean = torch.where(valid, adv, 0.0).sum(dim=1, keepdim=True) / n
    var = torch.where(valid, torch.square(adv - mean), 0.0).sum(dim=1, keepdim=True) / n
    return (adv - mean) / (torch.sqrt(var) + 1e-8)


@torch.no_grad()
def act_cells(nets: Sequence[ActorCritic], obs: torch.Tensor, cells):
    """(actions int64[C, n], log-probabilities, values) of obs f32[C, n, D].

    `cells` holds (cell, generator) pairs: each listed cell's own net acts
    on its rows, with one categorical draw per row (Gumbel-max from the
    cell's generator, as `jax.random.categorical` draws); the rows of the
    other cells read 0.  Cell by cell, so no cell's numbers depend on
    another's.
    """
    C, n = obs.shape[:2]
    zero_l = torch.zeros(n, dtype=torch.long, device=obs.device)
    zero_f = torch.zeros(n, device=obs.device)
    out = {c: (zero_l, zero_f, zero_f) for c in range(C)}
    for c, g in cells:
        logits, value = nets[c](obs[c])
        expo = torch.empty_like(logits).exponential_(generator=g)
        action = torch.argmax(logits - torch.log(expo), dim=1)
        logp = torch.log_softmax(logits, dim=1).gather(1, action[:, None])[:, 0]
        out[c] = (action, logp, value)
    return tuple(torch.stack([out[c][k] for c in range(C)]) for k in range(3))


def clipped_surrogate_loss(net: ActorCritic, obs, actions, old_logp, adv, returns, weights,
                           cfg: PPOConfig) -> torch.Tensor:
    """The fused runners' PPO loss of rows weighted by `weights` (summing to 1 over a batch).

    -sum(min(r A, clip(r) A) w) + c_v sum((V - R)^2 w) - c_e (-sum(sum(p log p) w)),
    `ppo_runner.py:484-500` with its 1 / n_valid folded into the weights.
    """
    logits, values = net(obs)
    logps = torch.log_softmax(logits, dim=1)
    logprob = logps.gather(1, actions[:, None])[:, 0]
    ratio = torch.exp(logprob - old_logp)
    clipped = torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps)
    policy_loss = -torch.sum(torch.minimum(ratio * adv, clipped * adv) * weights)
    value_loss = torch.sum(torch.square(values - returns) * weights)
    entropy = -torch.sum(torch.sum(torch.exp(logps) * logps, dim=1) * weights)
    return policy_loss + cfg.value_coef * value_loss - cfg.entropy_coef * entropy


def ppo_update(net: ActorCritic, opt_state, chunk: Callable[[int], tuple], n_chunks: int,
               cfg: PPOConfig) -> List[float]:
    """`cfg.train_epochs` full-batch Adam steps of `clipped_surrogate_loss` on one cell's net.

    `chunk(i)` gives rows i of the batch as (obs, actions, old_logp, adv,
    returns, weights); each epoch's gradient is the sum of the chunks'
    (the JAX DynaPPO runners accumulate theirs the same way).  `opt_state`
    is the net's `adam_init` state over its flat parameters, kept across
    calls.  Returns each epoch's loss as a device scalar list.
    """
    losses = []
    for _ in range(cfg.train_epochs):
        grads, loss = None, 0.0
        for i in range(n_chunks):
            part = clipped_surrogate_loss(net, *chunk(i), cfg)
            g = flat_grad(part, net)
            grads = g if grads is None else grads + g
            loss = loss + part.detach()
        adam_step_(opt_state, grads[None], cfg.learning_rate)
        losses.append(loss)
    return losses
