"""DQN + NoisyAbstractModel runs with every round's work on the device.

The port of the JAX package's `runtime/dqn_runner.py` (its lines 49-591),
which fuses the host DQN explorer (baselines/explorers/dqn.py, cited
against the reference there):

  * Q(s, a) of every one-hot action of the walked state (`:80-86`), here
    through `QNetwork.all_actions`, which multiplies the state half of the
    first layer once and adds each action's weight column: the same
    function as the repeat trick without its [L * A, 2 * L * A] product;
  * "stay in place" moves masked out; the move is uniform over the
    nonzero moves with probability epsilon = max(0.1, 0.5 - cost / (B *
    R)), else the greedy one; the gate is sum(moves) > 0 (`:295-299`),
    else a uniform move; the walk persists across rounds (`:263-265`);
  * each step scores the walked sequence through the model (1 query);
    the transition is stored at max priority in the replay ring only when
    the sequence is novel against the measured set and the round's walked
    pool (`:316-356`), and every walked sequence enters the proposal pool
    once (`:329-334`);
  * each time `model_cost` crosses a multiple of B with at least B stored
    transitions, a burst of `train_epochs` steps, each on B stratified
    prioritized samples, searchsorted(cumsum(prio), seg * (arange(B) +
    u), right) clipped (`:188-198`), with a FRESH L1-clip(1.0) + Adam(1e-3)
    (`:183-226`, `:367-381`); the clip and the gradient cover the
    BatchNorm statistics, which Adam trains as weights;
  * the round proposes the top B walked sequences by model score, and
    each one's cache row takes its measured truth.

The replay ring stores token rows and (flat action, action value) pairs;
one-hots are rebuilt at training time, as in the JAX runner.

C cells (each its own landscape params, start, signal strength and
generator) advance in lockstep on a leading cell axis (`jit_runner.
AsyncCellRun`).  Every step charges exactly one model query, so the step
loop runs exactly `model_queries_per_batch` steps a round in every cell and
needs no host sync at all: the bursts fire on the host's count, and a
cell's burst is kept only where its own ring holds B transitions (a
`torch.where` on the device).  Each cell has its own Q network, drawn from
its own generator; its forwards, bursts and Adam states run cell by cell,
so a cell's result depends only on its own (params, start, signal
strength, seed).  Runs are distributional matches of the JAX runner's.
"""
from typing import Callable, Optional, Sequence

import torch

from flexs_tpu_torch.baselines.explorers.dqn import QNetwork, train_step
from flexs_tpu_torch.baselines.models.torch_model import adam_init, flatten_parameters, one_hot
from flexs_tpu_torch.runtime import surrogate as surrogate_lib
from flexs_tpu_torch.runtime.jit_runner import (
    AdaleadConfig,
    AsyncCellRun,
    DeviceRunner,
    RunResult,
    _masked_append,
    one_cell,
    run_cells,
)

EPSILON_MIN = 0.1


def per_indices(prio: torch.Tensor, n: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Stratified prioritized samples int64[..., B] of a ring's priorities f32[..., M].

    Rows at or past the fill `n` weigh 0; sample b falls in stratum b of
    the priority mass at offset u[..., b] in [0, 1) (`dqn_runner.py:188-198`).
    """
    size, count = prio.shape[-1], u.shape[-1]
    p = torch.where(torch.arange(size, device=prio.device) < n[..., None], prio, 0.0)
    cum = torch.cumsum(p, dim=-1)
    seg = cum[..., -1:] / count
    bounds = seg * (torch.arange(count, device=prio.device) + u)
    return torch.searchsorted(cum, bounds, right=True).clamp(0, size - 1)


class _DQNRun(AsyncCellRun):
    """DQN's rounds of C cells in lockstep, one Q network and replay ring per cell."""

    def __init__(self, fitness_fn, fitness_params, start_tokens, cfg, ss, gens,
                 memory_size: int, train_epochs: int, gamma: float):
        budget, R = cfg.model_queries_per_batch, cfg.rounds
        super().__init__(fitness_fn, fitness_params, start_tokens, cfg, ss, gens,
                         cache_rows=R * (budget + 2))
        C, L, A, dev = self.C, self.L, cfg.alphabet_size, self.dev
        self.dim = L * A
        self.memory_size, self.train_epochs, self.gamma = memory_size, train_epochs, gamma
        self.nets = [QNetwork(L, A, g) for g in gens]
        self.flats = [flatten_parameters(net) for net in self.nets]
        # The replay ring; row `memory_size` is the trash row.
        rows = memory_size + 1
        self.mem_obs = torch.zeros((C, rows, L), dtype=torch.long, device=dev)
        self.mem_next = torch.zeros((C, rows, L), dtype=torch.long, device=dev)
        self.mem_act = torch.zeros((C, rows), dtype=torch.long, device=dev)
        self.mem_act_val = torch.zeros((C, rows), device=dev)
        self.mem_rew = torch.zeros((C, rows), device=dev)
        self.mem_prio = torch.zeros((C, rows), device=dev)
        self.mem_ptr = torch.zeros(C, dtype=torch.long, device=dev)
        self.mem_n = torch.zeros(C, dtype=torch.long, device=dev)
        self.walk = self.start.clone()
        self.steps = 0  # model queries so far, the same in every cell

    def all_action_q(self, states):
        """Q f32[C, dim] of every one-hot action of each cell's state f32[C, dim]."""
        with torch.no_grad():
            return torch.cat([net.all_actions(states[c:c + 1]) for c, net in enumerate(self.nets)])

    def choose(self, gens):
        """(flat action int64[C], action value f32[C]) of the epsilon-greedy masked walk."""
        cfg, C, dim = self.cfg, self.C, self.dim
        eps = max(EPSILON_MIN, 0.5 - self.steps / (cfg.sequences_batch_size * cfg.rounds))
        state = one_hot(self.walk, cfg.alphabet_size).reshape(C, dim)
        moves = self.all_action_q(state) * (1 - state)
        u, uni = self.draw_buffers(gens, (C,), torch.float32, torch.long)
        (expo,) = self.draw_buffers(gens, (C, dim), torch.float32)
        for c, g in gens:
            u[c:c + 1].uniform_(0, 1, generator=g)
            expo[c].exponential_(1.0, generator=g)
            uni[c:c + 1].random_(0, dim, generator=g)
        # A uniform draw over the nonzero moves (Gumbel-max), or the greedy one.
        rand = (torch.where(moves != 0, 0.0, -torch.inf) - torch.log(expo)).argmax(dim=1)
        flat = torch.where(u < eps, rand, moves.argmax(dim=1))
        any_move = moves.sum(dim=1) > 0
        flat = torch.where(any_move, flat, uni)
        value = torch.where(any_move, moves.gather(1, flat[:, None])[:, 0], 1.0)
        return flat, value

    def burst(self, gens):
        """A training burst in every cell, kept where the cell's ring holds B transitions."""
        B, A, dim, M = self.cfg.sequences_batch_size, self.cfg.alphabet_size, self.dim, \
            self.memory_size
        keep = self.mem_n >= B
        for c, g in gens:
            net, flat = self.nets[c], self.flats[c]
            before = flat.clone()
            opt_state = adam_init(flat[None])  # fresh each burst
            for _ in range(self.train_epochs):
                u = torch.empty(B, device=self.dev).uniform_(0, 1, generator=g)
                idx = per_indices(self.mem_prio[c, :M], self.mem_n[c], u)
                obs = one_hot(self.mem_obs[c, idx], A).reshape(B, dim)
                nxt = one_hot(self.mem_next[c, idx], A).reshape(B, dim)
                acts = one_hot(self.mem_act[c, idx], dim) * self.mem_act_val[c, idx][:, None]
                train_step(net, opt_state, obs, acts, self.mem_rew[c, idx], nxt, self.gamma)
            with torch.no_grad():
                flat.copy_(torch.where(keep[c], flat, before))

    def round(self):
        cfg, dev, cells = self.cfg, self.dev, self.cells
        C, L, B, M = self.C, self.L, cfg.sequences_batch_size, self.memory_size
        budget = cfg.model_queries_per_batch
        live = [True] * C
        self.train_surrogate()

        gen_cap = budget + 2
        gen_tokens = torch.zeros((C, gen_cap, L), dtype=torch.long, device=dev)
        gen_preds = torch.full((C, gen_cap), -torch.inf, device=dev)
        gen_pk = torch.zeros((C, gen_cap, self.words), dtype=torch.long, device=dev)
        gen_cache_pos = torch.zeros((C, gen_cap), dtype=torch.long, device=dev)
        n_gen = torch.zeros(C, dtype=torch.long, device=dev)
        measured_pk = self.measured_pk()

        for step in range(budget):
            gens = self.live_gens(live, draws=3)
            flat, act_val = self.choose(gens)
            pos, res = flat // cfg.alphabet_size, flat % cfg.alphabet_size
            new_walk = self.walk.scatter(1, pos[:, None], res[:, None])
            reward, cpos = self.query(new_walk[:, None], self.all_rows[:, :1], live)
            self.steps += 1

            new_pk = self.pack(new_walk)[:, None]
            fresh = self.masked_dists(new_pk, gen_pk, n_gen, step).amin(dim=2)[:, 0] > 0
            novel = fresh & self.novel_to_measured(new_pk, measured_pk)[:, 0]
            # Store the transition at max priority where novel (else the trash row).
            at = torch.where(novel, self.mem_ptr, M)[:, None]
            prio = self.mem_prio[:, :M].amax(dim=1).clamp(min=1.0)
            for buf, row in ((self.mem_obs, self.walk[:, None]), (self.mem_next, new_walk[:, None]),
                             (self.mem_act, flat[:, None]), (self.mem_act_val, act_val[:, None]),
                             (self.mem_rew, reward), (self.mem_prio, prio[:, None])):
                buf.scatter_(1, at.reshape(at.shape + (1,) * (buf.dim() - 2)).expand(row.shape),
                             row)
            self.mem_ptr = torch.where(novel, (self.mem_ptr + 1) % M, self.mem_ptr)
            self.mem_n = torch.where(novel, torch.clamp(self.mem_n + 1, max=M), self.mem_n)
            _masked_append(gen_tokens, new_walk[:, None], n_gen, fresh[:, None],
                           aux_bufs=(gen_preds, gen_pk, gen_cache_pos),
                           aux_rows=(reward, new_pk, cpos))
            n_gen = n_gen + fresh
            self.walk = new_walk
            if self.steps % B == 0:
                self.burst(self.live_gens(live, draws=self.train_epochs))

        proposals, top_vals, top_idx, valid = self.top_b(gen_tokens, gen_preds, n_gen)
        return self.measure_queued(proposals, top_vals, valid, slots=gen_cache_pos[cells, top_idx])


def run_dqn_nam_cells(
    fitness_fn: Callable,
    fitness_params,
    start_tokens: torch.Tensor,
    cfg: AdaleadConfig,
    signal_strengths,
    generators: Sequence[torch.Generator],
    memory_size: int = 4096,
    train_epochs: int = 20,
    gamma: float = 0.9,
) -> RunResult:
    """Run C DQN experiments in lockstep.

    The arguments are `run_adalead_nam_cells`' plus the explorer's
    hyperparameters (the JAX sweep's defaults).  Returns a `RunResult`
    with a leading cell axis.
    """
    return run_cells(_DQNRun(fitness_fn, fitness_params, start_tokens, cfg, signal_strengths,
                             list(generators), memory_size, train_epochs, gamma))


def run_dqn_nam(fitness_fn: Callable, fitness_params, start_tokens: torch.Tensor,
                cfg: AdaleadConfig, signal_strength: float, generator: torch.Generator,
                memory_size: int = 4096, train_epochs: int = 20, gamma: float = 0.9) -> RunResult:
    """One DQN experiment (`run_dqn_nam_cells` at C = 1).

    The hyperparameters follow the JAX function's order, positionally or by
    keyword.
    """
    return one_cell(
        run_dqn_nam_cells, fitness_fn, fitness_params, start_tokens, cfg, signal_strength,
        generator, memory_size=memory_size, train_epochs=train_epochs, gamma=gamma,
    )


class DeviceDQNNAM(DeviceRunner):
    """(df, metadata) wrapper over `run_dqn_nam`."""

    label = "device DQN"
    single_run = staticmethod(run_dqn_nam)

    def __init__(
        self,
        landscape,
        alphabet,
        rounds: int,
        sequences_batch_size: int,
        model_queries_per_batch: int,
        starting_sequence: str,
        memory_size: int = 4096,
        train_epochs: int = 20,
        gamma: float = 0.9,
        signal_strength: float = 0.9,
        model: str = "nam",
        surrogate_spec: Optional[surrogate_lib.SurrogateSpec] = None,
        seed: int = 0,
        log_file: Optional[str] = None,
        device=None,
    ):
        """The fused DQN runner for `landscape` on `device` (default "cuda").

        `model` is "nam", "perfect" or "surrogate" (`DeviceRunner`; the
        default surrogate, the paper's CNN, supplies the per-step rewards).
        """
        super().__init__(
            landscape, alphabet, rounds, sequences_batch_size, model_queries_per_batch,
            starting_sequence, signal_strength, seed, model, surrogate_spec, log_file, device,
        )
        self.run_kwargs = dict(memory_size=memory_size, train_epochs=train_epochs, gamma=gamma)
        self.name = "DeviceDQN_Explorer"
