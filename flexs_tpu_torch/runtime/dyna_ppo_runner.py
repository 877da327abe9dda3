"""Constructive DyNA-PPO + NoisyAbstractModel runs with every round's work on the device.

The port of the JAX package's `runtime/dyna_ppo_runner.py` (its lines
82-730), which fuses the host DynaPPO explorer (baselines/explorers/
dyna_ppo.py, cited against the reference there).  Constructive episodes
have a fixed length L and every phase spends its budget in whole batches,
so the control flow is static: no data-dependent loop, and no host sync
inside a round (nor at its end: the round's costs stay on the device).

Structure per round (reference dyna_ppo.py:250-307):
  * experiment phase: ceil(B / E) batches of E lockstep constructive
    episodes scored on the TRUE landscape; one PPO call on the phase's
    trajectory; its sequences are not recorded;
  * `num_model_rounds` model phases, each of ceil((budget /
    num_model_rounds) / E) batches scored through the model (E queries a
    batch); PPO trains after each; the sequences are recorded (an upsert:
    last fitness wins, `:257-280`);
  * an episode writes one residue a step from the actor's categorical
    over the alphabet; its observation is the one-hot of the residues
    written so far, the rest a mask column (L * (A + 1) inputs);
  * reward = fitness - 0.1 * density, density = the sum of fitness / d
    over every sequence seen before within distance 0 < d <= 2 (the
    env's density cache, environments/dyna_ppo.py:33-67); the batch's
    rows score once per distinct sequence (`:206-212`);
  * proposals: the top B recorded sequences by recorded fitness that are
    novel against the measured set; each proposal's cache row takes its
    measured truth.

Two documented deviations of the JAX runner (`:22-43`), kept here: (a)
`density_metric="hamming"` (the default) takes the density radius in
Hamming distance on the packed XOR + popcount path; for the equal-length
sequences FLEXS generates it differs from the reference's exact
Levenshtein only on block-shift-by-one pairs (one deletion and one
insertion), measured in the JAX package at 0 disagreements on protein
pools and L = 100 walks and at most 9e-4 per pair on L = 14 repetitive
batches; `density_metric="edit"` is the exact banded Levenshtein
(`ops.hamming.banded_edit_distance_matrix`, band 2) at a higher cost a
lookup; (b) densities are computed BEFORE the batch joins the cache, so
rows of one batch do not penalize each other.  Dead rows of the density
cache are masked explicitly: its trash row takes dropped values.

The surrogate is the fused family's NAM or perfect model, not the host
DynaPPO's 11-member ensemble (the JAX runner's deviation); a trained
surrogate (`model="surrogate"`) raises ValueError, as in the JAX package.
A batch's episodes draw their Gumbel noise at once from the cell's
generator; on the card each cell's L policy steps replay as one CUDA graph
(`cuda_graph`, the same kernels as the eager steps).
PPO is `rl.ppo`'s: GAE(0.99, 0.95) per episode lane with the reward on its
last step, advantages normalized over the phase, the statistics merged
then applied, 10 full-batch Adam(3e-4) epochs, the gradient summed over
row chunks.  C cells run in lockstep (`jit_runner.AsyncCellRun`); each has
its own `ActorCritic`, Adam state, statistics and density cache, its
forwards, densities and updates run cell by cell, so a cell's result
depends only on its own (params, start, signal strength, seed).
"""
from typing import Callable, Optional, Sequence

import torch

from flexs_tpu_torch.baselines.models.torch_model import adam_init, flatten_parameters, one_hot
from flexs_tpu_torch.ops import packed_hamming
from flexs_tpu_torch.ops.hamming import banded_edit_distance_matrix
from flexs_tpu_torch.rl import ppo
from flexs_tpu_torch.runtime.jit_runner import (
    AdaleadConfig,
    AsyncCellRun,
    DeviceRunner,
    Pool,
    RunResult,
    one_cell,
    run_cells,
)
from flexs_tpu_torch.runtime.ppo_runner import train_cells

LAM = 0.1  # density penalty (reference environments/dyna_ppo.py)
DENSITY_METRICS = ("hamming", "edit")
SURROGATE_ERROR = (
    "DynaPPO trains its own internal model ensemble (the r^2-gated member pool IS the trained "
    "surrogate, reference dyna_ppo.py:57-109); model='surrogate' does not apply. Use "
    "model='nam' or 'perfect'."
)


def _weighted_density(d, den_fit, n_den):
    """sum of fit / d over the live rows at 0 < d <= 2, of distances d [E, N]."""
    live = torch.arange(d.shape[1], device=d.device)[None, :] < n_den
    w = torch.where(live & (d > 0) & (d <= 2), 1.0 / torch.clamp(d, min=1), 0.0)
    return w @ torch.nan_to_num(den_fit)


def _edit_density(tokens, den_tokens, den_fit, n_den):
    """Density f32[E] over a density cache by exact banded Levenshtein (radius 2).

    The reference's semantics (environments/dyna_ppo.py:106-114): the sum of
    fitness / d over cached sequences with 0 < editdistance <= 2.  Rows at
    or past `n_den` are masked explicitly (the trash row holds dropped
    values, so distance alone cannot gate).  Shared with the mutative
    runner's density_metric="edit".
    """
    d = banded_edit_distance_matrix(tokens, den_tokens, band=2)
    return _weighted_density(d, den_fit, n_den)


def _hamming_density(packed, den_pk, den_fit, n_den, bits: int, per_word: int):
    """Density f32[E] of packed rows [E, K] over a density cache by Hamming distance (radius 2)."""
    d = packed_hamming.packed_hamming_matrix(packed, den_pk, bits, per_word)
    return _weighted_density(d, den_fit, n_den)


class DensityCache:
    """Each cell's sequences seen so far with their last fitness (`pool`, upserted by
    exact match whatever the metric), and the density over them."""

    def __init__(self, run: AsyncCellRun, cap: int, metric: str):
        if metric not in DENSITY_METRICS:
            raise ValueError("density_metric must be 'hamming' or 'edit'")
        self.run, self.metric = run, metric
        self.pool = Pool(run, cap, 0.0, tokens=metric == "edit")

    def density(self, tokens, packed, live):
        """f32[C, E]: each live cell's density of its rows, over its own filled rows."""
        run, pool = self.run, self.pool
        out = torch.zeros(packed.shape[:2], device=run.dev)
        for c, on in enumerate(live):
            if not on:
                continue
            n = max(1, pool.bounds[c])
            if self.metric == "edit":
                out[c] = _edit_density(tokens[c], pool.tokens[c, :n], pool.fit[c, :n], pool.n[c])
            else:
                out[c] = _hamming_density(packed[c], pool.pk[c, :n], pool.fit[c, :n], pool.n[c],
                                          run.bits, run.per_word)
        return out


class _DynaPPORun(AsyncCellRun):
    """Constructive DynaPPO's rounds of C cells in lockstep."""

    def __init__(self, fitness_fn, fitness_params, start_tokens, cfg, ss, gens,
                 env_batch_size: int, num_model_rounds: int, density_metric: str,
                 ppo_cfg: ppo.PPOConfig, cuda_graph: bool):
        if cfg.surrogate is not None:
            raise ValueError(SURROGATE_ERROR)
        B, budget, R = cfg.sequences_batch_size, cfg.model_queries_per_batch, cfg.rounds
        E = self.E = env_batch_size
        self.n_exp = -(-B // E)
        self.n_model = -(-(budget // num_model_rounds) // E)
        self.num_model_rounds = num_model_rounds
        model_rows = num_model_rounds * self.n_model * E
        super().__init__(fitness_fn, fitness_params, start_tokens, cfg, ss, gens,
                         cache_rows=R * (model_rows + B))
        A = cfg.alphabet_size
        self.obs_dim = self.L * (A + 1)
        self.ppo_cfg = ppo_cfg
        self.nets = [ppo.ActorCritic(self.obs_dim, A, (128,), g) for g in gens]
        self.opt_states = [adam_init(flatten_parameters(net)[None]) for net in self.nets]
        self.stats = ppo.init_obs_stats(self.C, self.obs_dim, self.dev)
        self.den = DensityCache(self, R * (self.n_exp + num_model_rounds * self.n_model) * E,
                                density_metric)
        self.gen_cap = max(model_rows, B)
        self.lanes = torch.ones((self.C, E), dtype=torch.bool, device=self.dev)
        self.cuda_graph = cuda_graph and self.dev.type == "cuda"
        self._graphs = {}

    def build_obs(self, tokens, t: int):
        """f32[..., L * (A + 1)]: residues before t one-hot, the rest the mask column A."""
        A = self.cfg.alphabet_size
        vis = torch.where(torch.arange(self.L, device=self.dev) < t, tokens, A)
        return one_hot(vis, A + 1).flatten(-2)

    def episode_buffers(self):
        """Zeroed (tokens, actions, log-probabilities, values), each [E, L], of one cell's batch."""
        E, L, dev = self.E, self.L, self.dev
        return (torch.zeros((E, L), dtype=torch.long, device=dev),
                torch.zeros((E, L), dtype=torch.long, device=dev),
                torch.zeros((E, L), device=dev), torch.zeros((E, L), device=dev))

    def episode(self, c: int, noise, stats: ppo.ObsStats, out) -> None:
        """Cell c's E constructive episodes, written into `out` (`episode_buffers`).

        Step t's action is the Gumbel-max argmax(logits - log(noise[:, t]))
        of the cell's actor on the normalized observation; `noise` holds
        the episodes' Exp(1) draws [E, L, A] and `stats` the cell's
        statistics as 1-cell tensors.  Eager, or captured as a CUDA graph.
        """
        tokens, actions, logps, values = out
        tokens.zero_()
        net = self.nets[c]
        for t in range(self.L):
            obs = ppo.normalize_obs(stats, self.build_obs(tokens, t)[None])[0]
            logits, value = net(obs)
            action = torch.argmax(logits - torch.log(noise[:, t]), dim=1)
            tokens[:, t] = action
            actions[:, t] = action
            logps[:, t] = torch.log_softmax(logits, dim=1).gather(1, action[:, None])[:, 0]
            values[:, t] = value

    def graphed_episode(self, c: int):
        """(CUDA graph of cell c's `episode`, its static noise, statistics and outputs).

        Captured at first use, after warm-up runs on a side stream.  The graph
        reads the actor's weights in place, so it follows every PPO update;
        its noise and statistics are copied in before each replay.  A failed
        capture raises.
        """
        if c not in self._graphs:
            E, L, A, D, dev = self.E, self.L, self.cfg.alphabet_size, self.obs_dim, self.dev
            noise = torch.ones((E, L, A), device=dev)
            stats = ppo.ObsStats(torch.ones(1, device=dev), torch.zeros((1, D), device=dev),
                                 torch.ones((1, D), device=dev))
            out = self.episode_buffers()
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for _ in range(3):
                    self.episode(c, noise, stats, out)
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self.episode(c, noise, stats, out)
            self._graphs[c] = (graph, noise, stats, out)
        return self._graphs[c]

    @torch.no_grad()
    def episode_batch(self, live):
        """E constructive episodes per cell: tokens [C, E, L]; actions, logp, values [C, E, L].

        Each cell draws its batch's Gumbel noise at once from its generator,
        then runs its episodes: a CUDA-graph replay on the card (`cuda_graph`),
        else eagerly; the two run the same kernels.
        """
        C, E, L, A = self.C, self.E, self.L, self.cfg.alphabet_size
        gens = self.live_gens(live, draws=1)
        (noise,) = self.draw_buffers(gens, (C, E, L, A), torch.float32)
        for c, g in gens:
            noise[c].exponential_(1.0, generator=g)
        outs = []
        for c in range(C):
            stats = ppo.ObsStats(*(x[c:c + 1] for x in self.stats))
            if self.cuda_graph:
                graph, static_noise, static_stats, out = self.graphed_episode(c)
                static_noise.copy_(noise[c])
                for dst, src in zip(static_stats, stats):
                    dst.copy_(src)
                graph.replay()
                outs.append([x.clone() for x in out])
            else:
                out = self.episode_buffers()
                self.episode(c, noise[c], stats, out)
                outs.append(out)
        return tuple(torch.stack(x) for x in zip(*outs))

    def run_phase(self, n_batches: int, true_landscape: bool, record: Optional[Pool]):
        """`n_batches` episode batches, then one PPO call per cell."""
        C = self.C
        live = [True] * C
        batches = []
        for _ in range(n_batches):
            tokens, actions, logps, values = self.episode_batch(live)
            pk = self.pack(tokens)
            if true_landscape:
                fitness = self.oracle(tokens, self.lanes)
            else:
                fitness, _ = self.query(tokens, self.lanes, live)
            density = self.den.density(tokens, pk, live)
            self.den.pool.upsert(self, pk, fitness, self.lanes, live, tokens=tokens)
            if record is not None:
                record.upsert(self, pk, fitness, self.lanes, live, tokens=tokens)
            batches.append((tokens, actions, logps, values, fitness - LAM * density))
        tokens, actions, logps, values, rewards = (torch.cat(x, dim=1) for x in zip(*batches))
        self.train(tokens, actions, logps, values, rewards)

    def train(self, tokens, actions, logps, values, rewards):
        """One PPO call of every cell on lanes tokens [C, N, L] (lane-major rows)."""
        N, L = tokens.shape[1:]
        cfg = self.ppo_cfg
        last = torch.arange(L, device=self.dev) == L - 1
        step_rewards = torch.where(last, rewards[..., None], 0.0)
        adv = ppo.gae(step_rewards, values, last.expand(values.shape), cfg.gamma, cfg.gae_lambda)
        returns = (adv + values).reshape(self.C, N * L)
        adv = adv.reshape(self.C, N * L)
        valid = torch.ones(N * L, dtype=torch.bool, device=self.dev)

        def rows(c):
            obs = torch.cat([self.build_obs(tokens[c], t)[:, None] for t in range(L)], dim=1)
            norm = ppo.normalize_advantages(adv[c:c + 1], valid[None])[0]
            return (obs.reshape(N * L, self.obs_dim), actions[c].reshape(-1),
                    logps[c].reshape(-1), norm, returns[c], valid)

        self.stats = train_cells(self.nets, self.opt_states, self.stats, range(self.C),
                                 rows, cfg)

    def round(self):
        gen = Pool(self, self.gen_cap, -torch.inf, tokens=True)
        self.run_phase(self.n_exp, True, None)
        for _ in range(self.num_model_rounds):
            self.run_phase(self.n_model, False, gen)

        bound = max(1, max(gen.bounds))
        novel = self.novel_to_measured(gen.pk[:, :bound], self.measured_pk()) & gen.live_rows()
        proposals, top_vals, _, valid = self.top_b(
            gen.tokens[:, :bound], torch.where(novel, gen.fit[:, :bound], -torch.inf), gen.n)
        return self.measure_queued(proposals, top_vals, valid, slots=self.cache_slots(proposals))


def run_dyna_ppo_nam_cells(
    fitness_fn: Callable,
    fitness_params,
    start_tokens: torch.Tensor,
    cfg: AdaleadConfig,
    signal_strengths,
    generators: Sequence[torch.Generator],
    env_batch_size: int = 16,
    num_model_rounds: int = 1,
    train_epochs: int = 10,
    learning_rate: float = 3e-4,
    gamma: float = 0.99,
    gae_lambda: float = 0.95,
    clip_eps: float = 0.2,
    value_coef: float = 0.5,
    entropy_coef: float = 0.01,
    density_metric: str = "hamming",
    cuda_graph: bool = True,
) -> RunResult:
    """Run C constructive DynaPPO experiments in lockstep.

    The arguments are `run_adalead_nam_cells`' plus the explorer's and
    PPO's hyperparameters (the JAX runner's defaults); `density_metric` is
    "hamming" or "edit" (see the module docstring); `cuda_graph` replays
    each cell's episodes as a CUDA graph on the card (False: eagerly, the
    same kernels).  A trained surrogate in `cfg` raises ValueError.
    Returns a `RunResult` with a leading cell axis.
    """
    ppo_cfg = ppo.PPOConfig(train_epochs, learning_rate, gamma, gae_lambda, clip_eps,
                            value_coef, entropy_coef)
    return run_cells(_DynaPPORun(fitness_fn, fitness_params, start_tokens, cfg, signal_strengths,
                                 list(generators), env_batch_size, num_model_rounds,
                                 density_metric, ppo_cfg, cuda_graph))


def run_dyna_ppo_nam(fitness_fn: Callable, fitness_params, start_tokens: torch.Tensor,
                     cfg: AdaleadConfig, signal_strength: float, generator: torch.Generator,
                     env_batch_size: int = 16, num_model_rounds: int = 1, train_epochs: int = 10,
                     learning_rate: float = 3e-4, gamma: float = 0.99, gae_lambda: float = 0.95,
                     clip_eps: float = 0.2, value_coef: float = 0.5, entropy_coef: float = 0.01,
                     density_metric: str = "hamming", *, cuda_graph: bool = True) -> RunResult:
    """One constructive DynaPPO experiment (`run_dyna_ppo_nam_cells` at C = 1).

    The hyperparameters follow the JAX function's order, positionally or by
    keyword.
    """
    return one_cell(
        run_dyna_ppo_nam_cells, fitness_fn, fitness_params, start_tokens, cfg, signal_strength,
        generator, env_batch_size=env_batch_size, num_model_rounds=num_model_rounds,
        train_epochs=train_epochs, learning_rate=learning_rate, gamma=gamma, gae_lambda=gae_lambda,
        clip_eps=clip_eps, value_coef=value_coef, entropy_coef=entropy_coef,
        density_metric=density_metric, cuda_graph=cuda_graph,
    )


class DeviceDynaPPONAM(DeviceRunner):
    """(df, metadata) wrapper over `run_dyna_ppo_nam`."""

    label = "device DynaPPO"
    single_run = staticmethod(run_dyna_ppo_nam)

    def __init__(
        self,
        landscape,
        alphabet,
        rounds: int,
        sequences_batch_size: int,
        model_queries_per_batch: int,
        starting_sequence: str,
        env_batch_size: int = 16,
        num_model_rounds: int = 1,
        train_epochs: int = 10,
        signal_strength: float = 0.9,
        model: str = "nam",
        seed: int = 0,
        density_metric: str = "hamming",
        log_file: Optional[str] = None,
        device=None,
    ):
        """The fused constructive DynaPPO runner for `landscape` on `device` (default "cuda").

        `model` is "nam" or "perfect"; `density_metric` "hamming" (the
        default fast radius) or "edit" (the reference's exact Levenshtein).
        On the card each cell's episodes replay as CUDA graphs.
        """
        if model not in ("nam", "perfect"):
            raise ValueError("model must be 'nam' or 'perfect'")
        super().__init__(
            landscape, alphabet, rounds, sequences_batch_size, model_queries_per_batch,
            starting_sequence, signal_strength, seed, model, None, log_file, device,
        )
        self.run_kwargs = dict(env_batch_size=env_batch_size, num_model_rounds=num_model_rounds,
                               train_epochs=train_epochs, density_metric=density_metric)
        self.name = f"DeviceDynaPPO_Agent_10_{num_model_rounds}"

