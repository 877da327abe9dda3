"""CMA-ES + NoisyAbstractModel runs with every round's work on the device.

The port of the JAX package's `runtime/cmaes_runner.py`, which fuses the
host CMAES explorer (baselines/explorers/cmaes.py, cited against the
reference there) with the fused model.  Per round, for each cell:

  * x0 = one-hot of the best measured sequence, and a fresh CMA-ES state
    with step size sqrt(initial_variance) (`ops.cmaes`);
  * each generation asks `population_size` solutions, decodes them by
    argmax over the alphabet and scores them: repeats of this round's
    decodes or of measured sequences are free; the others pay one model
    query each (within-generation repeats each pay, as on the host);
  * `tell` minimizes (the reference quirk) or maximizes with
    `maximize=True`;
  * generations run while model-cost delta + population_size <= budget
    and fewer than `max_iter` have run;
  * the round proposes the top `sequences_batch_size` of everything
    generated, seeded with the best measured sequence.

Each cell has its own CMA-ES state, and `ask`/`tell` run cell by cell:
`torch.linalg.eigh` on one matrix at a time, as a single matrix and a
batch of them may take different library routines (a batched Jacobi path
for small ones on CUDA) and a cell would then stop equaling its standalone
run.  Deviation from the JAX runner: a cached query returns its existing
cache row, so a measured proposal's truth reaches the row that holds it,
and the seeded best row writes to the trash row.  Cells, generators and
the model modes are `jit_runner.CellRun`'s.
"""
from typing import Callable, Optional, Sequence

import torch

from flexs_tpu_torch.ops import cmaes as cma_ops
from flexs_tpu_torch.ops import packed_hamming
from flexs_tpu_torch.runtime import surrogate as surrogate_lib
from flexs_tpu_torch.runtime.jit_runner import (
    AdaleadConfig,
    CellRun,
    DeviceRunner,
    RunResult,
    _masked_append,
    first_occurrence,
    one_cell,
    run_cells,
)


class _CMAESRun(CellRun):
    """CMA-ES's rounds of C cells in lockstep, one CMA-ES state per cell."""

    def __init__(self, fitness_fn, fitness_params, start_tokens, cfg, ss, gens,
                 population_size: int, max_iter: int, initial_variance: float, maximize: bool):
        budget, P = cfg.model_queries_per_batch, population_size
        super().__init__(fitness_fn, fitness_params, start_tokens, cfg, ss, gens,
                         cache_rows=cfg.rounds * (budget + 2 * P))
        self.gen_cap = budget + 2 * P + 2
        self.P, self.max_iter, self.maximize = P, max_iter, maximize
        self.sigma0 = torch.sqrt(torch.tensor(initial_variance, dtype=torch.float32,
                                              device=self.dev))

    def first_match(self, packed, rows_pk, n_rows, values):
        """(in rows, value) per packed row: its first equal row among the first n_rows."""
        d = packed_hamming.masked_hamming_matrix(
            packed, rows_pk, n_rows, rows_pk.shape[1], self.bits, self.per_word, self.L + 1
        )
        return d.amin(dim=2) == 0, values.gather(1, d.argmin(dim=2))

    def round(self):
        cfg, dev, cells = self.cfg, self.dev, self.cells
        C, L, A, P = self.C, self.L, cfg.alphabet_size, self.P
        budget, dim = cfg.model_queries_per_batch, self.L * cfg.alphabet_size
        round_start = list(self.model_cost)
        round_start_t = self.model_cost_t.clone()
        self.train_surrogate()

        # x0 = one-hot of each cell's best measured sequence; the pool is
        # seeded with it (reference cmaes.py:80-92).
        best = self.measured_truth.argmax(dim=1)
        top_tokens = self.measured_tokens[cells[:, 0], best]
        x0 = torch.nn.functional.one_hot(top_tokens, A).float().reshape(C, dim)
        eye = torch.eye(dim, device=dev)
        zeros, ones = torch.zeros(dim, device=dev), torch.ones(dim, device=dev)
        states = [
            cma_ops.CMAState(x0[c], self.sigma0, eye, zeros, zeros, eye, ones, 0)
            for c in range(C)
        ]

        gen_tokens = torch.zeros((C, self.gen_cap, L), dtype=torch.long, device=dev)
        gen_preds = torch.full((C, self.gen_cap), -torch.inf, device=dev)
        gen_pk = torch.zeros((C, self.gen_cap, self.words), dtype=torch.long,
                             device=dev)
        gen_cache_pos = torch.full((C, self.gen_cap), self.cache_vals.shape[1] - 1,
                                   dtype=torch.long, device=dev)
        gen_tokens[:, 0] = top_tokens
        gen_preds[:, 0] = self.measured_truth.gather(1, best[:, None])[:, 0]
        gen_pk[:, 0] = self.pack(top_tokens)
        n_gen = torch.ones(C, dtype=torch.long, device=dev)
        meas_pk = self.pack(self.measured_tokens)

        it = 0
        while it < self.max_iter:
            live = [self.model_cost[c] - round_start[c] + P <= budget for c in range(C)]
            if not any(live):
                break
            it += 1
            live_t = (self.model_cost_t - round_start_t + P <= budget)[:, None]
            gens = self.live_gens(live, draws=1)
            solutions = torch.zeros((C, P, dim), device=dev)
            for c, g in gens:
                solutions[c] = cma_ops.ask(states[c], g, P)
            tokens = solutions.reshape(C, P, L, A).argmax(dim=3)
            pk = self.pack(tokens)

            # Free hits: this round's decodes, then measured truths.
            in_gen, gen_vals = self.first_match(pk, gen_pk, n_gen, gen_preds)
            in_meas, meas_vals = self.first_match(pk, meas_pk, self.n_measured,
                                                  self.measured_truth)
            pay = ~in_gen & ~in_meas & live_t
            nam_vals, pos = self.nam_query(tokens, pay, live)
            fitnesses = torch.where(in_gen, gen_vals, torch.where(in_meas, meas_vals, nam_vals))

            # Record novel decodes (first occurrences) in the pool.
            record = ~in_gen & first_occurrence(pk, torch.ones_like(in_gen)) & live_t
            _masked_append(
                gen_tokens, tokens, n_gen, record,
                aux_bufs=(gen_preds, gen_pk, gen_cache_pos), aux_rows=(fitnesses, pk, pos),
            )
            n_gen += record.sum(dim=1)

            tell_vals = -fitnesses if self.maximize else fitnesses
            for c, _ in gens:
                states[c] = cma_ops.tell(states[c], solutions[c], tell_vals[c])

        proposals, top_vals, top_idx, valid = self.top_b(gen_tokens, gen_preds, n_gen)
        return self.measure(proposals, top_vals, valid, slots=gen_cache_pos[cells, top_idx])


def run_cmaes_nam_cells(
    fitness_fn: Callable,
    fitness_params,
    start_tokens: torch.Tensor,
    cfg: AdaleadConfig,
    signal_strengths,
    generators: Sequence[torch.Generator],
    population_size: int = 15,
    max_iter: int = 400,
    initial_variance: float = 0.2,
    maximize: bool = False,
) -> RunResult:
    """Run C CMA-ES experiments in lockstep.

    The arguments are `run_adalead_nam_cells`' plus the explorer's
    hyperparameters (the JAX sweep's defaults).  Returns a `RunResult`
    with a leading cell axis.
    """
    return run_cells(_CMAESRun(
        fitness_fn, fitness_params, start_tokens, cfg, signal_strengths, list(generators),
        population_size, max_iter, initial_variance, maximize,
    ))


def run_cmaes_nam(fitness_fn: Callable, fitness_params, start_tokens: torch.Tensor,
                  cfg: AdaleadConfig, signal_strength: float, generator: torch.Generator,
                  population_size: int = 15, max_iter: int = 400, initial_variance: float = 0.2,
                  maximize: bool = False) -> RunResult:
    """One CMA-ES experiment (`run_cmaes_nam_cells` at C = 1).

    The hyperparameters follow the JAX function's order, positionally or by
    keyword.
    """
    return one_cell(
        run_cmaes_nam_cells, fitness_fn, fitness_params, start_tokens, cfg, signal_strength,
        generator, population_size=population_size, max_iter=max_iter,
        initial_variance=initial_variance, maximize=maximize,
    )


class DeviceCMAESNAM(DeviceRunner):
    """(df, metadata) wrapper over `run_cmaes_nam`."""

    label = "device CMAES"
    single_run = staticmethod(run_cmaes_nam)

    def __init__(
        self,
        landscape,
        alphabet,
        rounds: int,
        sequences_batch_size: int,
        model_queries_per_batch: int,
        starting_sequence: str,
        population_size: int = 15,
        max_iter: int = 400,
        initial_variance: float = 0.2,
        signal_strength: float = 0.9,
        maximize: bool = False,
        model: str = "nam",
        surrogate_spec: Optional[surrogate_lib.SurrogateSpec] = None,
        seed: int = 0,
        log_file: Optional[str] = None,
        device=None,
    ):
        """The fused CMA-ES runner for `landscape` on `device` (default "cuda").

        `model` is "nam", "perfect" or "surrogate" (`DeviceRunner`; the
        default surrogate is the paper's 3-CNN ensemble of its TF-Bind
        CMA-ES runs).
        """
        super().__init__(
            landscape, alphabet, rounds, sequences_batch_size, model_queries_per_batch,
            starting_sequence, signal_strength, seed, model, surrogate_spec, log_file, device,
            default_spec=surrogate_lib.SurrogateSpec(ensemble_size=3),
        )
        self.run_kwargs = dict(population_size=population_size, max_iter=max_iter,
                           initial_variance=initial_variance, maximize=maximize)
        self.name = f"DeviceCMAES_popsize{population_size}"
