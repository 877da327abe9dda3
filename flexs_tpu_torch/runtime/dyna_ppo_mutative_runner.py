"""Mutative DyNA-PPO + NoisyAbstractModel runs with every round's work on the device.

The port of the JAX package's `runtime/dyna_ppo_mutative_runner.py` (its
lines 96-844), the reference's mutative DynaPPO variant (dyna_ppo.py:
322-524): each episode starts from a complete sequence and mutates one
residue a step until the reward stops increasing; the final sequence is
recorded and the environment reseeds from the recorded pool's top band.

Structure per round (reference dyna_ppo.py:470-524):
  * experiment phase: episode batches scored on the TRUE landscape until
    the landscape-cost delta reaches the annealed budget ((R - r + 1) *
    B) // (2 * R) of 0-based round r (`:633-638`: half the proposal
    budget at round one, interpolated down); one PPO call; the recorded
    pool is then cleared;
  * `num_model_rounds` model phases, each spending budget /
    num_model_rounds model queries; PPO trains after each; final
    sequences are recorded for the proposals.  Once the model phases
    together have spent the budget, the remaining ones get budget 0, and
    a phase with no batch leaves the policy, Adam state and statistics as
    they are (`:654-666`);
  * proposals: the top B - exp_budget recorded sequences by recorded
    fitness, novel against the measured set (`:670-679`); each one's
    cache row takes its measured truth.

Episode semantics (reference environments/dyna_ppo.py:166-336): an action
is flat position * A + residue; a no-op action terminates with reward 0
before any scoring; otherwise the mutant is scored (1 query: the
landscape in the experiment phase, the model in model phases), enters the
density cache, and reward = fitness - 0.1 * density (radius 2, Hamming by
default or exact Levenshtein with density_metric="edit", the constructive
runner's `_edit_density`; densities are taken before the row joins the
cache); a revisit within the episode terminates with reward -1; a reward
below the previous step's terminates with that reward.  An episode reset
scores the seed through the MODEL (one query per episode,
environments/dyna_ppo.py:243-252); an ended batch reseeds each lane
uniformly from the recorded sequences with fitness >= 0.9 * top (all of
them when that band is empty, dyna_ppo.py:420-446).

Documented deviations of the JAX runner, kept: E lockstep episodes per
batch instead of one environment, episodes capped at `episode_len` steps,
the density radius above, and each phase collecting whole batches into a
buffer of max_exp_b = ceil((B // 2) / E) + 8 or max_model_b =
ceil(phase_budget / E) + 2 batches (`:143-156`; rows past an episode's end
weigh 0 in training).

A phase is a loop over batches while the cell's phase cost is under its
budget, around a static `episode_len` step loop (`:375`, `:566`): one host
sync a batch, which reads the costs and fills.  C cells run in lockstep
(`jit_runner.AsyncCellRun`): a cell whose phase is over changes no state
and draws nothing.  Each cell has its own `ActorCritic`, Adam state,
statistics and density cache; forwards, densities and PPO updates run
cell by cell, the density over the cell's own filled rows, so a cell's
result depends only on its own (params, start, signal strength, seed).
"""
from typing import Callable, Optional, Sequence

import torch

from flexs_tpu_torch.baselines.models.torch_model import adam_init, flatten_parameters, one_hot
from flexs_tpu_torch.rl import ppo
from flexs_tpu_torch.runtime.dyna_ppo_runner import (
    LAM,
    SURROGATE_ERROR,
    DensityCache,
)
from flexs_tpu_torch.runtime.jit_runner import (
    AdaleadConfig,
    AsyncCellRun,
    DeviceRunner,
    Pool,
    RunResult,
    one_cell,
    run_cells,
)
from flexs_tpu_torch.runtime.ppo_runner import reseed_band, train_cells, uniform_pick


def experiment_budget(rounds: int, batch: int, r: int) -> int:
    """The annealed experiment budget of 0-based round r: ((R - r + 1) * B) // (2 * R)."""
    return ((rounds - r + 1) * batch) // (2 * rounds)


class _MutativeRun(AsyncCellRun):
    """Mutative DynaPPO's rounds of C cells in lockstep."""

    def __init__(self, fitness_fn, fitness_params, start_tokens, cfg, ss, gens,
                 env_batch_size: int, episode_len: int, num_model_rounds: int,
                 density_metric: str, ppo_cfg: ppo.PPOConfig):
        if cfg.surrogate is not None:
            raise ValueError(SURROGATE_ERROR)
        B, budget, R = cfg.sequences_batch_size, cfg.model_queries_per_batch, cfg.rounds
        E, T = self.E, self.T = env_batch_size, episode_len
        # Each episode pays >= 1 model query at its reset, so a model batch
        # spends >= E of its phase's budget; an experiment batch may spend
        # nothing of its (landscape) budget, hence the 8 spare batches.
        self.max_exp_b = -(-(B // 2) // E) + 8
        self.phase_budget = budget // num_model_rounds
        self.max_model_b = -(-self.phase_budget // E) + 2
        self.num_model_rounds = num_model_rounds
        per_round = (self.max_exp_b + num_model_rounds * self.max_model_b) * E * (T + 1)
        super().__init__(fitness_fn, fitness_params, start_tokens, cfg, ss, gens,
                         cache_rows=R * per_round + B * R)
        A = cfg.alphabet_size
        self.dim = self.L * A
        self.ppo_cfg = ppo_cfg
        self.nets = [ppo.ActorCritic(self.dim, self.dim, (128,), g) for g in gens]
        self.opt_states = [adam_init(flatten_parameters(net)[None]) for net in self.nets]
        self.stats = ppo.init_obs_stats(self.C, self.dim, self.dev)
        self.den = DensityCache(self, R * per_round, density_metric)
        self.gen_cap = (self.max_exp_b + num_model_rounds * self.max_model_b) * E + 1
        self.seeds = self.start[:, None].expand(self.C, E, self.L).clone()
        self.round_index = 0

    def episode_batch(self, live, live_t, true_landscape: bool):
        """E mutative episodes in each live cell: the step rows [C, T, E, ...] and final states.

        `live` (host bools) and `live_t` (bool[C]) mark the cells that run.
        """
        C, E, T, A, dev = self.C, self.E, self.T, self.cfg.alphabet_size, self.dev
        alive = live_t[:, None].expand(C, E).clone()
        tokens, (fitness, _) = self.seeds, self.query(self.seeds, alive, live)
        prev_reward = torch.full((C, E), -torch.inf, device=dev)
        ep_pk = torch.zeros((C, E, T, self.words), dtype=torch.long, device=dev)
        steps = []
        for t in range(T):
            obs = ppo.normalize_obs(self.stats, one_hot(tokens, A).reshape(C, E, self.dim))
            action, logp, value = ppo.act_cells(self.nets, obs, self.live_gens(live, draws=1))
            pos, res = action // A, action % A
            noop = tokens.gather(2, pos[..., None])[..., 0] == res
            mutated = tokens.scatter(2, pos[..., None], res[..., None])
            do_score = alive & ~noop
            new_tokens = torch.where(do_score[..., None], mutated, tokens)
            new_pk = self.pack(new_tokens)
            if true_landscape:
                fit_q = self.oracle(new_tokens, do_score)
            else:
                fit_q, _ = self.query(new_tokens, do_score, live)
            new_fitness = torch.where(do_score, fit_q, fitness)
            density = self.den.density(new_tokens, new_pk, live)
            self.den.pool.upsert(self, new_pk, new_fitness, do_score, live, tokens=new_tokens)
            reward_val = new_fitness - LAM * density
            # Seen within this episode (its mutated states so far)?
            seen = ((new_pk[:, :, None] == ep_pk[:, :, :t]).all(dim=-1)).any(dim=2)
            ep_pk[:, :, t] = new_pk
            decreasing = reward_val < prev_reward
            reward = torch.where(noop, 0.0, torch.where(seen, -1.0, reward_val))
            done = noop | seen | decreasing
            steps.append((tokens, action, logp, value, reward, alive))
            prev_reward = torch.where(alive & ~done, reward_val, prev_reward)
            alive = alive & ~done
            tokens, fitness = new_tokens, new_fitness
        return [torch.stack(x, dim=1) for x in zip(*steps)], tokens, fitness

    def run_phase(self, max_batches: int, true_landscape: bool, budgets, gen: Pool):
        """Episode batches while each cell's phase cost is under its budget, then PPO."""
        C, E, dev = self.C, self.E, self.dev

        def cost():
            return (self.landscape_cost, self.landscape_cost_t) if true_landscape \
                else (self.model_cost, self.model_cost_t)

        start, start_t = list(cost()[0]), cost()[1].clone()
        budgets_t = torch.as_tensor(budgets, device=dev)
        batches = [0] * C
        batches_t = torch.zeros(C, dtype=torch.long, device=dev)
        buf = None
        while True:
            costs, costs_t = cost()
            live = [costs[c] - start[c] < budgets[c] and batches[c] < max_batches
                    for c in range(C)]
            if not any(live):
                break
            live_t = (costs_t - start_t < budgets_t) & (batches_t < max_batches)
            rows, final_tokens, final_fit = self.episode_batch(live, live_t, true_landscape)
            if buf is None:
                buf = [torch.zeros((C, max_batches + 1) + x.shape[1:], dtype=x.dtype, device=dev)
                       for x in rows]
            at = torch.where(live_t, batches_t, max_batches)
            for b, x in zip(buf, rows):
                b[self.cells[:, 0], at] = x
            batches_t += live_t
            # Record the final sequences; reseed each lane from the top band.
            live_rows = live_t[:, None].expand(C, E)
            gen.upsert(self, self.pack(final_tokens), final_fit, live_rows, live,
                       tokens=final_tokens)
            bound = max(1, max(gen.bounds))
            band = reseed_band(gen.fit[:, :bound], gen.live_rows())
            pick = uniform_pick(self, band, E, self.live_gens(live, draws=1))
            seeds = gen.tokens[self.cells, pick]
            self.seeds = torch.where(live_rows[..., None], seeds, self.seeds)
            for c in range(C):
                batches[c] += live[c]
            n_den, n_gen = self.read_counts(self.den.pool.n, gen.n)
            self.den.pool.bounds, gen.bounds = n_den, n_gen
        if buf is not None:
            self.train(buf, batches)

    def train(self, buf, batches):
        """One PPO call of each cell that ran a batch, on its own batches' rows."""
        tokens, actions, logps, values, rewards, valid = buf  # [C, MB + 1, T, E, ...]
        C, T, E = self.C, self.T, self.E
        cfg = self.ppo_cfg

        def lanes(x, c, n):
            """[n, T, E, ...] -> [n * E, T, ...] lanes of cell c."""
            return x[c, :n].transpose(1, 2).reshape((n * E, T) + x.shape[4:])

        def rows(c):
            n = batches[c]
            ok = lanes(valid, c, n)
            nxt = torch.cat([ok[:, 1:], torch.zeros_like(ok[:, :1])], dim=1)
            rew = torch.where(ok, lanes(rewards, c, n), 0.0)
            val = torch.where(ok, lanes(values, c, n), 0.0)
            adv = ppo.gae(rew, val, ~nxt, cfg.gamma, cfg.gae_lambda)
            returns = adv + val
            flat_ok = ok.reshape(-1)
            norm = ppo.normalize_advantages(adv.reshape(1, -1), flat_ok[None])[0]
            obs = one_hot(lanes(tokens, c, n), self.cfg.alphabet_size).reshape(n * E * T, self.dim)
            return (obs, lanes(actions, c, n).reshape(-1), lanes(logps, c, n).reshape(-1),
                    norm * flat_ok, returns.reshape(-1) * flat_ok, flat_ok)

        self.stats = train_cells(self.nets, self.opt_states, self.stats,
                                 [c for c in range(C) if batches[c] > 0], rows, cfg)

    def round(self):
        cfg, C = self.cfg, self.C
        B, budget = cfg.sequences_batch_size, cfg.model_queries_per_batch
        exp_budget = experiment_budget(cfg.rounds, B, self.round_index)
        self.round_index += 1
        self.read_counts()
        self.run_phase(self.max_exp_b, True, [exp_budget] * C,
                       Pool(self, self.gen_cap, -torch.inf, tokens=True))
        # The experiment phase's recorded pool is cleared.
        gen = Pool(self, self.gen_cap, -torch.inf, tokens=True)
        pre_model = list(self.model_cost)
        for _ in range(self.num_model_rounds):
            budgets = [0 if self.model_cost[c] - pre_model[c] >= budget else self.phase_budget
                       for c in range(C)]
            self.run_phase(self.max_model_b, False, budgets, gen)

        # At least B pool columns (unfilled ones rank last, invalid), so a
        # round proposes B rows even when its pool holds fewer.
        bound = min(self.gen_cap, max(B, max(gen.bounds)))
        filled = torch.arange(bound, device=self.dev) < gen.n[:, None]
        novel = self.novel_to_measured(gen.pk[:, :bound], self.measured_pk()) & filled
        proposals, top_vals, _, valid = self.top_b(
            gen.tokens[:, :bound], torch.where(novel, gen.fit[:, :bound], -torch.inf), gen.n)
        valid = valid & (torch.arange(B, device=self.dev) < max(B - exp_budget, 0))
        return self.measure_queued(proposals, top_vals, valid, slots=self.cache_slots(proposals))


def run_dyna_ppo_mutative_nam_cells(
    fitness_fn: Callable,
    fitness_params,
    start_tokens: torch.Tensor,
    cfg: AdaleadConfig,
    signal_strengths,
    generators: Sequence[torch.Generator],
    env_batch_size: int = 16,
    episode_len: int = 20,
    num_model_rounds: int = 1,
    train_epochs: int = 10,
    learning_rate: float = 3e-4,
    gamma: float = 0.99,
    gae_lambda: float = 0.95,
    clip_eps: float = 0.2,
    value_coef: float = 0.5,
    entropy_coef: float = 0.01,
    density_metric: str = "hamming",
) -> RunResult:
    """Run C mutative DynaPPO experiments in lockstep.

    The arguments are `run_adalead_nam_cells`' plus the explorer's and
    PPO's hyperparameters (the JAX runner's defaults); `density_metric` is
    "hamming" or "edit".  A trained surrogate in `cfg` raises ValueError.
    Returns a `RunResult` with a leading cell axis.
    """
    ppo_cfg = ppo.PPOConfig(train_epochs, learning_rate, gamma, gae_lambda, clip_eps,
                            value_coef, entropy_coef)
    return run_cells(_MutativeRun(fitness_fn, fitness_params, start_tokens, cfg,
                                  signal_strengths, list(generators), env_batch_size,
                                  episode_len, num_model_rounds, density_metric, ppo_cfg))


def run_dyna_ppo_mutative_nam(fitness_fn: Callable, fitness_params, start_tokens: torch.Tensor,
                              cfg: AdaleadConfig, signal_strength: float,
                              generator: torch.Generator, env_batch_size: int = 16,
                              episode_len: int = 20, num_model_rounds: int = 1, train_epochs: int = 10,
                              learning_rate: float = 3e-4, gamma: float = 0.99,
                              gae_lambda: float = 0.95, clip_eps: float = 0.2,
                              value_coef: float = 0.5, entropy_coef: float = 0.01,
                              density_metric: str = "hamming") -> RunResult:
    """One mutative DynaPPO experiment (`run_dyna_ppo_mutative_nam_cells` at C = 1).

    The hyperparameters follow the JAX function's order, positionally or by
    keyword.
    """
    return one_cell(
        run_dyna_ppo_mutative_nam_cells, fitness_fn, fitness_params, start_tokens, cfg,
        signal_strength, generator, env_batch_size=env_batch_size, episode_len=episode_len,
        num_model_rounds=num_model_rounds, train_epochs=train_epochs, learning_rate=learning_rate,
        gamma=gamma, gae_lambda=gae_lambda, clip_eps=clip_eps, value_coef=value_coef,
        entropy_coef=entropy_coef, density_metric=density_metric,
    )


class DeviceDynaPPOMutativeNAM(DeviceRunner):
    """(df, metadata) wrapper over `run_dyna_ppo_mutative_nam`."""

    label = "device DynaPPOMutative"
    single_run = staticmethod(run_dyna_ppo_mutative_nam)

    def __init__(
        self,
        landscape,
        alphabet,
        rounds: int,
        sequences_batch_size: int,
        model_queries_per_batch: int,
        starting_sequence: str,
        env_batch_size: int = 16,
        episode_len: int = 20,
        num_model_rounds: int = 1,
        train_epochs: int = 10,
        signal_strength: float = 0.9,
        model: str = "nam",
        seed: int = 0,
        density_metric: str = "hamming",
        log_file: Optional[str] = None,
        device=None,
    ):
        """The fused mutative DynaPPO runner for `landscape` on `device` (default "cuda").

        `model` is "nam" or "perfect"; `density_metric` "hamming" (the
        default fast radius) or "edit" (the reference's exact Levenshtein).
        """
        if model not in ("nam", "perfect"):
            raise ValueError("model must be 'nam' or 'perfect'")
        super().__init__(
            landscape, alphabet, rounds, sequences_batch_size, model_queries_per_batch,
            starting_sequence, signal_strength, seed, model, None, log_file, device,
        )
        self.run_kwargs = dict(
            env_batch_size=env_batch_size, episode_len=episode_len,
            num_model_rounds=num_model_rounds, train_epochs=train_epochs,
            density_metric=density_metric,
        )
        self.name = f"DeviceDynaPPOMutative_Agent_10_{num_model_rounds}"
