"""Random explorer + NoisyAbstractModel runs with every round's work on the device.

The port of the JAX package's `runtime/random_runner.py`, which fuses the
host Random explorer (baselines/explorers/random.py, cited against the
reference there) with the fused model: each round mutates `batch`
uniformly chosen measured sequences at rate mu/L, keeps the children that
are novel (in no cache row, no earlier child of the batch), scores them,
and repeats while another batch fits in `model_queries_per_batch`; it then
proposes the top `sequences_batch_size` of the scored pool by model score
(`elitist=True`) or a uniform sample of it drawn with replacement
(`elitist=False`, the reference Random's default, random.py:83-88:
duplicates are possible and each is measured).

Cells, generators, the NAM cache, the model modes and the proposal step
are `jit_runner.CellRun`'s: C cells advance in lockstep, a cell draws only
while its batch loop runs, and a cell's result depends only on its own
(params, start, signal strength, seed).
"""
from typing import Callable, Optional, Sequence

import torch

from flexs_tpu_torch.runtime import surrogate as surrogate_lib
from flexs_tpu_torch.runtime.jit_runner import (
    AdaleadConfig,
    CellRun,
    DeviceRunner,
    RunResult,
    _masked_append,
    one_cell,
    run_cells,
)


class _RandomRun(CellRun):
    """The Random explorer's rounds of C cells in lockstep."""

    def __init__(self, fitness_fn, fitness_params, start_tokens, cfg, ss, gens, batch: int,
                 mu: float, elitist: bool):
        budget = cfg.model_queries_per_batch
        super().__init__(fitness_fn, fitness_params, start_tokens, cfg, ss, gens,
                         cache_rows=cfg.rounds * (budget + batch))
        self.gen_cap = budget + batch + 1
        self.batch, self.mu, self.elitist = batch, mu, elitist

    def round(self):
        cfg, dev, cells = self.cfg, self.dev, self.cells
        C, L, A = self.C, self.L, cfg.alphabet_size
        B, budget, batch = cfg.sequences_batch_size, cfg.model_queries_per_batch, self.batch
        round_start = list(self.model_cost)
        round_start_t = self.model_cost_t.clone()
        self.train_surrogate()

        gen_tokens = torch.zeros((C, self.gen_cap, L), dtype=torch.long, device=dev)
        gen_preds = torch.full((C, self.gen_cap), -torch.inf, device=dev)
        gen_cache_pos = torch.zeros((C, self.gen_cap), dtype=torch.long, device=dev)
        n_gen = torch.zeros(C, dtype=torch.long, device=dev)

        while True:
            live = [self.model_cost[c] - round_start[c] + batch <= budget for c in range(C)]
            if not any(live):
                break
            live_rows = (
                torch.ones((C, batch), dtype=torch.bool, device=dev) if all(live)
                else (self.model_cost_t - round_start_t + batch <= budget)[:, None].expand(C, batch)
            )
            # Parents: uniform random measured sequences (reference
            # random.py:63-78), mutated at rate mu / L.
            gens = self.live_gens(live, draws=3)
            (pick,) = self.draw_buffers(gens, (C, batch), torch.long)
            draw, rand = self.draw_buffers(gens, (C, batch, L), torch.float32, torch.long)
            for c, g in gens:
                pick[c].random_(0, self.n_measured_h[c], generator=g)
                draw[c].uniform_(0, 1, generator=g)
                rand[c].random_(0, A, generator=g)
            parents = self.measured_tokens[cells, pick]
            children = torch.where(draw < self.mu / L, rand, parents)

            keep = self.novel(self.pack(children), live_rows) & live_rows
            vals, pos = self.nam_query(children, keep, live)
            _masked_append(
                gen_tokens, children, n_gen, keep,
                aux_bufs=(gen_preds, gen_cache_pos), aux_rows=(vals, pos),
            )
            n_gen += keep.sum(dim=1)

        if self.elitist:
            proposals, top_vals, top_idx, valid = self.top_b(gen_tokens, gen_preds, n_gen)
        else:
            # Uniform over the pool's rows 0..n_gen-1 (contiguous by
            # construction), with replacement.
            top_idx = torch.empty((C, B), dtype=torch.long, device=dev)
            for c, g in self.live_gens([True] * C, draws=1):
                top_idx[c].random_(0, max(self.model_cost[c] - round_start[c], 1), generator=g)
            top_vals = torch.where(
                top_idx < n_gen[:, None], gen_preds.gather(1, top_idx), -torch.inf
            )
            valid = torch.isfinite(top_vals)
            proposals = gen_tokens[cells, top_idx]
        return self.measure(proposals, top_vals, valid, slots=gen_cache_pos[cells, top_idx])


def run_random_nam_cells(
    fitness_fn: Callable,
    fitness_params,
    start_tokens: torch.Tensor,
    cfg: AdaleadConfig,
    signal_strengths,
    generators: Sequence[torch.Generator],
    batch: int = 64,
    mu: float = 1.0,
    elitist: bool = True,
) -> RunResult:
    """Run C Random-explorer experiments in lockstep.

    The arguments are `run_adalead_nam_cells`' (`cfg` supplies the
    budgets and the model), plus the explorer's: `batch` children scored
    a step, mutation rate `mu` / L, and `elitist` (top-B by model score,
    else a uniform sample with replacement).  Returns a `RunResult` with a
    leading cell axis.
    """
    return run_cells(_RandomRun(fitness_fn, fitness_params, start_tokens, cfg,
                                signal_strengths, list(generators), batch, mu, elitist))


def run_random_nam(fitness_fn: Callable, fitness_params, start_tokens: torch.Tensor,
                   cfg: AdaleadConfig, signal_strength: float, generator: torch.Generator,
                   batch: int = 64, mu: float = 1.0, elitist: bool = True) -> RunResult:
    """One Random-explorer experiment (`run_random_nam_cells` at C = 1)."""
    return one_cell(run_random_nam_cells, fitness_fn, fitness_params, start_tokens, cfg,
                    signal_strength, generator, batch=batch, mu=mu, elitist=elitist)


class DeviceRandomNAM(DeviceRunner):
    """(df, metadata) wrapper over `run_random_nam`."""

    label = "device Random"
    single_run = staticmethod(run_random_nam)

    def __init__(
        self,
        landscape,
        alphabet,
        rounds: int,
        sequences_batch_size: int,
        model_queries_per_batch: int,
        starting_sequence: str,
        mu: float = 1.0,
        batch: int = 64,
        signal_strength: float = 0.9,
        model: str = "nam",
        surrogate_spec: Optional[surrogate_lib.SurrogateSpec] = None,
        elitist: bool = True,
        seed: int = 0,
        log_file: Optional[str] = None,
        device=None,
    ):
        """The fused Random runner for `landscape` on `device` (default "cuda").

        `model` is "nam", "perfect" or "surrogate" (`DeviceRunner`; the
        default surrogate is the paper's CNN).
        """
        super().__init__(
            landscape, alphabet, rounds, sequences_batch_size, model_queries_per_batch,
            starting_sequence, signal_strength, seed, model, surrogate_spec, log_file, device,
        )
        self.run_kwargs = dict(batch=batch, mu=mu, elitist=elitist)
        self.name = f"DeviceRandom_mu={mu}"
