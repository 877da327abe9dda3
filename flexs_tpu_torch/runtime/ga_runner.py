"""GeneticAlgorithm + NoisyAbstractModel runs with every round's work on the device.

The port of the JAX package's `runtime/ga_runner.py`, which fuses the host
GeneticAlgorithm explorer (baselines/explorers/genetic_algorithm.py, cited
against the reference there) with the fused model:

  * each round draws an initial population of `population_size` from the
    measured data, by "top-proportion" (uniform over the top K scorers)
    or "wright-fisher" (a softmax(score / beta) categorical) selection;
  * each generation draws `children_proportion` * P parents from the
    population by the same strategy, mutates them at rate 1/L, keeps the
    novel children (in no cache row, no earlier child of the batch),
    scores them and puts them in place of the worst population members;
  * generations run while model-cost delta + population_size < budget
    (reference genetic_algorithm.py:115-119);
  * the round proposes the top `sequences_batch_size` generated sequences.

Categorical draws are Gumbel-max draws, as `jax.random.categorical` makes
them.  Cells, generators, the NAM cache, the model modes and the proposal
step are `jit_runner.CellRun`'s: a cell draws only while its generation
loop runs, and its result depends only on its own (params, start, signal
strength, seed).
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
    _scatter_rows,
    one_cell,
    run_cells,
)

STRATEGIES = ("wright-fisher", "top-proportion")


def gumbel_argmax(logits: torch.Tensor, count: int, gens, dev) -> torch.Tensor:
    """int64[C, count]: `count` categorical draws per cell over `logits` f32[C, n].

    Gumbel-max: argmax(logits - log(E)), E ~ Exp(1), drawn by each cell's
    generator in `gens` ((cell, generator) pairs; other cells draw 0).
    """
    cells, n = logits.shape
    expo = torch.ones((cells, count, n), device=dev)
    for c, g in gens:
        expo[c].exponential_(1.0, generator=g)
    return (logits[:, None, :] - torch.log(expo)).argmax(dim=2)


class _GARun(CellRun):
    """The genetic algorithm's rounds of C cells in lockstep."""

    def __init__(self, fitness_fn, fitness_params, start_tokens, cfg, ss, gens,
                 population_size: int, parent_selection_strategy: str,
                 children_proportion: float, parent_selection_proportion: Optional[float],
                 beta: float):
        if parent_selection_strategy not in STRATEGIES:
            raise ValueError(f"parent_selection_strategy must be one of {STRATEGIES}")
        budget, P = cfg.model_queries_per_batch, population_size
        self.n_children = max(1, int(children_proportion * P))
        super().__init__(fitness_fn, fitness_params, start_tokens, cfg, ss, gens,
                         cache_rows=cfg.rounds * (budget + P + self.n_children))
        self.gen_cap = budget + P + self.n_children + 1
        self.P = P
        self.strategy = parent_selection_strategy
        self.top_k = max(1, int((parent_selection_proportion or 0) * P))
        self.beta = torch.tensor(beta, dtype=torch.float32, device=self.dev)

    def choose_parents(self, scores, valid, count: int, live):
        """int64[C, count] row indices of `scores` f32[C, n] by the selection strategy."""
        gens = self.live_gens(live, draws=1)
        if self.strategy == "top-proportion":
            # The top K rows (a reversed stable ascending sort, as
            # `jnp.argsort(...)[::-1]`), then uniform picks among them.
            masked = torch.where(valid, scores, -torch.inf)
            pool = torch.sort(masked, dim=1, stable=True).indices.flip(1)[:, : self.top_k]
            (picks,) = self.draw_buffers(gens, (self.C, count), torch.long)
            for c, g in gens:
                picks[c].random_(0, self.top_k, generator=g)
            return pool.gather(1, picks)
        logits = torch.where(valid, scores / self.beta, -torch.inf)
        return gumbel_argmax(logits, count, gens, self.dev)

    def round(self):
        cfg, dev, cells = self.cfg, self.dev, self.cells
        C, L, A, P, nc = self.C, self.L, cfg.alphabet_size, self.P, self.n_children
        budget = cfg.model_queries_per_batch
        round_start = list(self.model_cost)
        round_start_t = self.model_cost_t.clone()
        self.train_surrogate()

        # Initial population from the measured data; one trash row.
        cap = self.measured_truth.shape[1]
        init_idx = self.choose_parents(
            self.measured_truth, torch.arange(cap, device=dev) < self.n_measured[:, None], P,
            [True] * C,
        )
        pop_tokens = torch.zeros((C, P + 1, L), dtype=torch.long, device=dev)
        pop_scores = torch.zeros((C, P + 1), device=dev)
        pop_tokens[:, :P] = self.measured_tokens[cells, init_idx]
        pop_scores[:, :P] = self.measured_truth.gather(1, init_idx)
        pop_valid = torch.ones((C, P), dtype=torch.bool, device=dev)

        gen_tokens = torch.zeros((C, self.gen_cap, L), dtype=torch.long, device=dev)
        gen_preds = torch.full((C, self.gen_cap), -torch.inf, device=dev)
        gen_cache_pos = torch.zeros((C, self.gen_cap), dtype=torch.long, device=dev)
        n_gen = torch.zeros(C, dtype=torch.long, device=dev)

        while True:
            live = [self.model_cost[c] - round_start[c] + P < budget for c in range(C)]
            if not any(live):
                break
            live_rows = (
                torch.ones((C, nc), dtype=torch.bool, device=dev) if all(live)
                else (self.model_cost_t - round_start_t + P < budget)[:, None].expand(C, nc)
            )
            parent_idx = self.choose_parents(pop_scores[:, :P], pop_valid, nc, live)
            parents = pop_tokens[cells, parent_idx]
            gens = self.live_gens(live, draws=2)
            draw, rand = self.draw_buffers(gens, (C, nc, L), torch.float32, torch.long)
            for c, g in gens:
                draw[c].uniform_(0, 1, generator=g)
                rand[c].random_(0, A, generator=g)
            children = torch.where(draw < 1.0 / L, rand, parents)

            keep = self.novel(self.pack(children), live_rows) & live_rows
            vals, pos = self.nam_query(children, keep, live)
            _masked_append(
                gen_tokens, children, n_gen, keep,
                aux_bufs=(gen_preds, gen_cache_pos), aux_rows=(vals, pos),
            )
            n_gen += keep.sum(dim=1)

            # The kept children replace the worst population members, in
            # order; the rest go to the trash row P.
            worst = torch.sort(pop_scores[:, :P], dim=1, stable=True).indices
            slot = torch.cumsum(keep.long(), dim=1) - 1
            target = torch.where(keep & (slot < P), worst.gather(1, slot.clamp(0, P - 1)), P)
            _scatter_rows(pop_tokens, target, children)
            _scatter_rows(pop_scores, target, vals)

        proposals, top_vals, top_idx, valid = self.top_b(gen_tokens, gen_preds, n_gen)
        return self.measure(proposals, top_vals, valid, slots=gen_cache_pos[cells, top_idx])


def run_ga_nam_cells(
    fitness_fn: Callable,
    fitness_params,
    start_tokens: torch.Tensor,
    cfg: AdaleadConfig,
    signal_strengths,
    generators: Sequence[torch.Generator],
    population_size: int = 100,
    parent_selection_strategy: str = "wright-fisher",
    children_proportion: float = 0.2,
    parent_selection_proportion: Optional[float] = 0.3,
    beta: float = 0.05,
) -> RunResult:
    """Run C GeneticAlgorithm experiments in lockstep.

    The arguments are `run_adalead_nam_cells`' plus the explorer's
    hyperparameters (the JAX sweep's defaults).  Returns a `RunResult`
    with a leading cell axis.
    """
    return run_cells(_GARun(
        fitness_fn, fitness_params, start_tokens, cfg, signal_strengths, list(generators),
        population_size, parent_selection_strategy, children_proportion,
        parent_selection_proportion, beta,
    ))


def run_ga_nam(fitness_fn: Callable, fitness_params, start_tokens: torch.Tensor,
               cfg: AdaleadConfig, signal_strength: float, generator: torch.Generator,
               population_size: int = 100, parent_selection_strategy: str = "wright-fisher",
               children_proportion: float = 0.2,
               parent_selection_proportion: Optional[float] = 0.3,
               beta: float = 0.05) -> RunResult:
    """One GeneticAlgorithm experiment (`run_ga_nam_cells` at C = 1).

    The hyperparameters follow the JAX function's order, positionally or by
    keyword.
    """
    return one_cell(
        run_ga_nam_cells, fitness_fn, fitness_params, start_tokens, cfg, signal_strength,
        generator, population_size=population_size,
        parent_selection_strategy=parent_selection_strategy,
        children_proportion=children_proportion,
        parent_selection_proportion=parent_selection_proportion, beta=beta,
    )


class DeviceGeneticAlgorithmNAM(DeviceRunner):
    """(df, metadata) wrapper over `run_ga_nam`."""

    label = "device GA"
    single_run = staticmethod(run_ga_nam)

    def __init__(
        self,
        landscape,
        alphabet,
        rounds: int,
        sequences_batch_size: int,
        model_queries_per_batch: int,
        starting_sequence: str,
        population_size: int = 100,
        parent_selection_strategy: str = "wright-fisher",
        children_proportion: float = 0.2,
        parent_selection_proportion: Optional[float] = 0.3,
        beta: float = 0.05,
        signal_strength: float = 0.9,
        model: str = "nam",
        surrogate_spec: Optional[surrogate_lib.SurrogateSpec] = None,
        seed: int = 0,
        log_file: Optional[str] = None,
        device=None,
    ):
        """The fused GA runner for `landscape` on `device` (default "cuda").

        `model` is "nam", "perfect" or "surrogate" (`DeviceRunner`; the
        default surrogate is the paper's CNN).
        """
        if parent_selection_strategy not in STRATEGIES:
            raise ValueError(f"parent_selection_strategy must be one of {STRATEGIES}")
        super().__init__(
            landscape, alphabet, rounds, sequences_batch_size, model_queries_per_batch,
            starting_sequence, signal_strength, seed, model, surrogate_spec, log_file, device,
        )
        self.run_kwargs = dict(
            population_size=population_size,
            parent_selection_strategy=parent_selection_strategy,
            children_proportion=children_proportion,
            parent_selection_proportion=parent_selection_proportion,
            beta=beta,
        )
        self.name = (
            f"DeviceGeneticAlgorithm_pop_size={population_size}_"
            f"parents={parent_selection_strategy}"
        )
