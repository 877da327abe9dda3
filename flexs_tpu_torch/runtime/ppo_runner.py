"""PPO + NoisyAbstractModel runs with every round's work on the device.

The port of the JAX package's `runtime/ppo_runner.py` (its lines 49-690),
which fuses the host PPO explorer (baselines/explorers/ppo.py, cited
against the reference there) over one mutation environment:

  * env step (environments/ppo.py:81-109, the JAX runner's `:11-24`): the
    action sets one residue of the walked sequence; a no-op action (the
    residue is already there) terminates with reward 0 and no model query;
    otherwise the mutant is scored (1 query); a revisit within the episode
    terminates with reward -1; a fitness decrease terminates with reward =
    fitness; otherwise reward = fitness and the walk goes on.  An episode
    also ends when the round's budget is spent or it reaches `budget`
    steps;
  * at an episode's end its final sequence is recorded (a dict: last
    fitness wins) and the walk reseeds uniformly among the recorded
    sequences within 90% of the best, or among all of them when that band
    is empty (`:353-390`); the next step first scores the seed (1 query);
  * after the budget is spent, one PPO call on the round's whole
    trajectory (`rl.ppo`: GAE(0.99, 0.95) cut at episode ends, advantages
    normalized over the valid steps, the observation statistics merged
    and then applied, 10 full-batch clipped-surrogate epochs under
    Adam(3e-4) kept across rounds);
  * proposals: the top B recorded sequences by recorded fitness that are
    novel against the measured set (`:509-520`); after measurement each
    proposal's cache row takes its truth (`:533-545`).

Cells and loop control: C cells advance in lockstep on a leading cell axis
(`jit_runner.AsyncCellRun`), the JAX runner's per-step `lax.cond`s
(`:284`, `:312`, `:387`) are masks per cell, and the step loop runs while
any cell's round budget holds, a cell whose budget is spent changing no
state and drawing nothing.  Each step takes one host sync, the cells' model
costs.  Actions are Gumbel-max draws from the cell's generator, as
`jax.random.categorical` draws, and each cell has its own `ActorCritic`,
Adam state and observation statistics, run cell by cell, so a cell's
result depends only on its own (params, start, signal strength, seed).
Runs are distributional matches of the JAX runner's.
"""
from typing import Callable, Optional, Sequence

import torch

from flexs_tpu_torch.baselines.models.torch_model import adam_init, flatten_parameters, one_hot
from flexs_tpu_torch.rl import ppo
from flexs_tpu_torch.runtime import surrogate as surrogate_lib
from flexs_tpu_torch.runtime.jit_runner import (
    AdaleadConfig,
    AsyncCellRun,
    DeviceRunner,
    Pool,
    RunResult,
    one_cell,
    run_cells,
)

# Rows of one chunk of a PPO update's batch (its gradient is summed over chunks).
CHUNK_ROWS = 8192


def uniform_pick(run: AsyncCellRun, band, count: int, gens):
    """int64[C, count]: uniform picks among each cell's True entries of band bool[C, n].

    A pick is the k-th True entry, k = floor(u * n_true), u uniform from
    the cell's generator; a cell with no True entry picks entry 0.
    """
    (u,) = run.draw_buffers(gens, (run.C, count), torch.float32)
    for c, g in gens:
        u[c].uniform_(0, 1, generator=g)
    cum = torch.cumsum(band.long(), dim=1)
    n = cum[:, -1:]
    k = torch.minimum((u * n).long(), (n - 1).clamp(min=0))
    return torch.searchsorted(cum, k + 1).clamp(max=band.shape[1] - 1)


def reseed_band(fit, live_rows):
    """bool[C, n]: the live rows within 90% of the best live row, or all live rows if none.

    0.9 * top exceeds top when top < 0, which empties the band; the
    reference then seeds from every recorded sequence (ppo.py:108-113).
    """
    top = torch.where(live_rows, fit, -torch.inf).amax(dim=1, keepdim=True)
    band = live_rows & (fit >= 0.9 * top)
    return torch.where(band.any(dim=1, keepdim=True), band, live_rows)


def train_cells(nets, opt_states, stats, cells, rows, cfg: ppo.PPOConfig):
    """One PPO call of each listed cell on its own rows; the cells' new statistics.

    `rows(c)` gives cell c's rows: (obs f32[N, D], actions int64[N], old
    log-probabilities, normalized advantages, returns, valid bool[N]); the
    cell's statistics absorb its valid observations before normalizing
    them (the JAX runners' order), and its weights are 1 / n_valid on
    valid rows.
    """
    counts, means, m2s = list(stats.count), list(stats.mean), list(stats.m2)
    for c in cells:
        obs, actions, old_logp, adv, returns, valid = rows(c)
        mine = ppo.ObsStats(stats.count[c:c + 1], stats.mean[c:c + 1], stats.m2[c:c + 1])
        mine = ppo.welford_merge(mine, obs[None], valid[None])
        obs_n = ppo.normalize_obs(mine, obs[None])[0]
        weights = valid.float() / torch.clamp(valid.sum(), min=1).float()
        n = obs.shape[0]

        def chunk(i, obs_n=obs_n, actions=actions, old_logp=old_logp, adv=adv,
                  returns=returns, weights=weights):
            part = slice(i * CHUNK_ROWS, (i + 1) * CHUNK_ROWS)
            return (obs_n[part], actions[part], old_logp[part], adv[part], returns[part],
                    weights[part])

        ppo.ppo_update(nets[c], opt_states[c], chunk, -(-n // CHUNK_ROWS), cfg)
        counts[c], means[c], m2s[c] = mine.count[0], mine.mean[0], mine.m2[0]
    return ppo.ObsStats(torch.stack(counts), torch.stack(means), torch.stack(m2s))


class _PPORun(AsyncCellRun):
    """PPO's rounds of C cells in lockstep, one actor-critic per cell."""

    def __init__(self, fitness_fn, fitness_params, start_tokens, cfg, ss, gens,
                 ppo_cfg: ppo.PPOConfig):
        B, budget, R = cfg.sequences_batch_size, cfg.model_queries_per_batch, cfg.rounds
        super().__init__(fitness_fn, fitness_params, start_tokens, cfg, ss, gens,
                         cache_rows=R * (budget + B))
        self.ppo_cfg = ppo_cfg
        self.dim = dim = self.L * cfg.alphabet_size
        # Each step either queries or records a free no-op that forces a
        # reset (>= 1 query) next step; every episode costs >= 1 query.
        self.traj_cap, self.rec_cap, self.ep_cap = 2 * budget + 4, budget + 2, budget + 2
        self.nets = [ppo.ActorCritic(dim, dim, (128,), g) for g in gens]
        self.opt_states = [adam_init(flatten_parameters(net)[None]) for net in self.nets]
        self.stats = ppo.init_obs_stats(self.C, dim, self.dev)
        self.seed_tokens = self.start.clone()

    def round(self):
        cfg, dev, C, L, A = self.cfg, self.dev, self.C, self.L, self.cfg.alphabet_size
        budget, T = cfg.model_queries_per_batch, self.traj_cap
        self.train_surrogate()
        round_start = list(self.model_cost)
        round_start_t = self.model_cost_t.clone()

        # Trajectory, recorded pool and episode seen-set; the last row of
        # each buffer is its trash row.
        traj_tokens = torch.zeros((C, T + 1, L), dtype=torch.long, device=dev)
        traj = {k: torch.zeros((C, T + 1), device=dev) for k in ("logp", "reward", "value")}
        traj_action = torch.zeros((C, T + 1), dtype=torch.long, device=dev)
        traj_done = torch.zeros((C, T + 1), dtype=torch.bool, device=dev)
        rec = Pool(self, self.rec_cap, -torch.inf, tokens=True)
        ep_pk = torch.zeros((C, self.ep_cap + 1, self.words), dtype=torch.long, device=dev)
        n_ep = torch.zeros(C, dtype=torch.long, device=dev)
        n_traj = torch.zeros(C, dtype=torch.long, device=dev)
        n_steps = torch.zeros(C, dtype=torch.long, device=dev)
        walk = self.seed_tokens.clone()
        fitness = torch.zeros(C, device=dev)
        prev_fitness = torch.full((C,), -torch.inf, device=dev)
        needs_reset = torch.ones(C, dtype=torch.bool, device=dev)
        steps = [0] * C
        cells = self.cells[:, 0]

        while True:
            live = [self.model_cost[c] - round_start[c] < budget for c in range(C)]
            if not any(live):
                break
            live_t = (torch.ones(C, dtype=torch.bool, device=dev) if all(live)
                      else self.model_cost_t - round_start_t < budget)
            # An episode's first step scores its seed.
            reset = needs_reset & live_t
            seed_fit, _ = self.query(self.seed_tokens[:, None], reset[:, None], live)
            walk = torch.where(reset[:, None], self.seed_tokens, walk)
            fitness = torch.where(reset, seed_fit[:, 0], fitness)
            prev_fitness = torch.where(reset, -torch.inf, prev_fitness)
            n_steps = torch.where(reset, 0, n_steps)
            n_ep = torch.where(reset, 0, n_ep)

            # The policy's action on the normalized one-hot observation.
            obs = ppo.normalize_obs(self.stats, one_hot(walk, A).reshape(C, 1, self.dim))
            action, logp, value = ppo.act_cells(self.nets, obs, self.live_gens(live, draws=1))
            action, logp, value = action[:, 0], logp[:, 0], value[:, 0]
            pos, res = action // A, action % A
            no_op = walk.gather(1, pos[:, None])[:, 0] == res
            new_walk = walk.scatter(1, pos[:, None], res[:, None])

            # Score the mutant (a no-op costs nothing and ends the episode).
            score = live_t & ~no_op
            fit, _ = self.query(new_walk[:, None], score[:, None], live)
            new_fitness = torch.where(no_op, fitness, fit[:, 0])
            new_pk = self.pack(new_walk)[:, None]
            seen = self.masked_dists(new_pk, ep_pk, n_ep, min(max(steps) + 1, self.ep_cap))
            revisit = ~no_op & (seen.amin(dim=2)[:, 0] == 0)
            decreased = ~no_op & ~revisit & (new_fitness < prev_fitness)
            done = (no_op | revisit | decreased
                    | (self.model_cost_t - round_start_t >= budget) | (n_steps + 1 >= budget))
            reward = torch.where(no_op, 0.0, torch.where(revisit, -1.0, new_fitness))

            # Record the step (non-live cells write their trash rows).
            at = torch.where(live_t, n_traj, T)
            traj_tokens[cells, at] = walk
            traj_action[cells, at] = action
            traj_done[cells, at] = done
            for key, val in (("logp", logp), ("reward", reward), ("value", value)):
                traj[key][cells, at] = val
            n_traj = torch.where(live_t, torch.clamp(n_traj + 1, max=T - 1), n_traj)
            ep_pk[cells, torch.where(live_t, n_ep, self.ep_cap)] = new_pk[:, 0]
            n_ep = torch.where(live_t, torch.clamp(n_ep + 1, max=self.ep_cap - 1), n_ep)
            walk = torch.where(live_t[:, None], new_walk, walk)
            fitness = torch.where(live_t & ~no_op, new_fitness, fitness)
            prev_fitness = torch.where(live_t & ~done, torch.maximum(prev_fitness, new_fitness),
                                       prev_fitness)

            # Episode end: record the final sequence, reseed from the band.
            ended = live_t & done
            rec.upsert(self, self.pack(walk)[:, None], fitness[:, None], ended[:, None], live,
                       tokens=walk[:, None])
            band = reseed_band(rec.fit[:, : max(1, max(rec.bounds))], rec.live_rows())
            pick = uniform_pick(self, band, 1, self.live_gens(live, draws=1))
            self.seed_tokens = torch.where(ended[:, None], rec.tokens[cells, pick[:, 0]],
                                           self.seed_tokens)
            needs_reset = torch.where(live_t, done, needs_reset)
            n_steps = torch.where(live_t, n_steps + 1, n_steps)
            for c in range(C):
                steps[c] += live[c]
            self.read_counts()

        self.train(traj_tokens, traj_action, traj, traj_done, steps)

        # Proposals: the top B recorded sequences novel against the measured set.
        bound = max(1, max(rec.bounds))
        novel = self.novel_to_measured(rec.pk[:, :bound], self.measured_pk()) & rec.live_rows()
        proposals, top_vals, _, valid = self.top_b(
            rec.tokens[:, :bound], torch.where(novel, rec.fit[:, :bound], -torch.inf), rec.n)
        slots = self.cache_slots(proposals)
        return self.measure_queued(proposals, top_vals, valid, slots=slots)

    def train(self, traj_tokens, traj_action, traj, traj_done, steps):
        """One PPO call of every cell on its round's trajectory."""
        C, T = self.C, self.traj_cap
        lengths = [min(s, T - 1) for s in steps]
        span = max(lengths)
        valid = torch.arange(span, device=self.dev) < torch.as_tensor(lengths, device=self.dev)[:, None]
        rewards = torch.where(valid, traj["reward"][:, :span], 0.0)
        values = torch.where(valid, traj["value"][:, :span], 0.0)
        dones = torch.where(valid, traj_done[:, :span], True)
        cfg = self.ppo_cfg
        adv = ppo.gae(rewards, values, dones, cfg.gamma, cfg.gae_lambda)
        returns = adv + values

        def rows(c):
            n = lengths[c]
            norm = ppo.normalize_advantages(adv[c:c + 1, :n], valid[c:c + 1, :n])[0]
            obs = one_hot(traj_tokens[c, :n], self.cfg.alphabet_size).reshape(n, self.dim)
            return (obs, traj_action[c, :n], traj["logp"][c, :n], norm, returns[c, :n],
                    valid[c, :n])

        self.stats = train_cells(self.nets, self.opt_states, self.stats, range(C), rows,
                                 cfg)


def run_ppo_nam_cells(
    fitness_fn: Callable,
    fitness_params,
    start_tokens: torch.Tensor,
    cfg: AdaleadConfig,
    signal_strengths,
    generators: Sequence[torch.Generator],
    train_epochs: int = 10,
    learning_rate: float = 3e-4,
    gamma: float = 0.99,
    gae_lambda: float = 0.95,
    clip_eps: float = 0.2,
    value_coef: float = 0.5,
    entropy_coef: float = 0.01,
) -> RunResult:
    """Run C PPO experiments in lockstep.

    The arguments are `run_adalead_nam_cells`' plus the PPO
    hyperparameters (the JAX runner's defaults).  Returns a `RunResult`
    with a leading cell axis.
    """
    ppo_cfg = ppo.PPOConfig(train_epochs, learning_rate, gamma, gae_lambda, clip_eps,
                            value_coef, entropy_coef)
    return run_cells(_PPORun(fitness_fn, fitness_params, start_tokens, cfg, signal_strengths,
                             list(generators), ppo_cfg))


def run_ppo_nam(fitness_fn: Callable, fitness_params, start_tokens: torch.Tensor,
                cfg: AdaleadConfig, signal_strength: float, generator: torch.Generator,
                train_epochs: int = 10, learning_rate: float = 3e-4, gamma: float = 0.99,
                gae_lambda: float = 0.95, clip_eps: float = 0.2, value_coef: float = 0.5,
                entropy_coef: float = 0.01) -> RunResult:
    """One PPO experiment (`run_ppo_nam_cells` at C = 1).

    The hyperparameters follow the JAX function's order, positionally or by
    keyword.
    """
    return one_cell(
        run_ppo_nam_cells, fitness_fn, fitness_params, start_tokens, cfg, signal_strength,
        generator, train_epochs=train_epochs, learning_rate=learning_rate, gamma=gamma,
        gae_lambda=gae_lambda, clip_eps=clip_eps, value_coef=value_coef, entropy_coef=entropy_coef,
    )


class DevicePPONAM(DeviceRunner):
    """(df, metadata) wrapper over `run_ppo_nam`."""

    label = "device PPO"
    single_run = staticmethod(run_ppo_nam)

    def __init__(
        self,
        landscape,
        alphabet,
        rounds: int,
        sequences_batch_size: int,
        model_queries_per_batch: int,
        starting_sequence: str,
        train_epochs: int = 10,
        signal_strength: float = 0.9,
        model: str = "nam",
        surrogate_spec: Optional[surrogate_lib.SurrogateSpec] = None,
        seed: int = 0,
        log_file: Optional[str] = None,
        device=None,
    ):
        """The fused PPO runner for `landscape` on `device` (default "cuda").

        `model` is "nam", "perfect" or "surrogate" (`DeviceRunner`; the
        default surrogate, the paper's CNN, supplies the per-step rewards).
        """
        super().__init__(
            landscape, alphabet, rounds, sequences_batch_size, model_queries_per_batch,
            starting_sequence, signal_strength, seed, model, surrogate_spec, log_file, device,
        )
        self.run_kwargs = dict(train_epochs=train_epochs)
        self.name = "DevicePPO_Agent"
