"""Adalead + NoisyAbstractModel runs with every round's work on the device.

Every round's parent selection, rollouts, novelty rejection,
NoisyAbstractModel scoring, oracle measurement and cost accounting run as
tensor ops on the run's device; only loop control is on the host.
Semantics mirror the host classes they fuse (cited against the reference):
  * Adalead (reference adalead.py:96-175): sign-aware threshold parent
    selection with np.resize tiling; optional rho recombination passes;
    greedy rollouts where children surviving (fitness >= root) keep
    rolling; all under the model-query budget.
  * NoisyAbstractModel (reference noisy_abstract_model.py:62-99): cached
    queries return their cached value; uncached queries pay 2 landscape
    queries (signal + nearest neighbour), pred = a^d * f + (1 - a^d) * eps,
    eps ~ Exp(mean = neighbour's true fitness), and the prediction is
    cached.
  * Trained surrogate (`cfg.surrogate`, the JAX runner's surrogate mode;
    reference explorer.py:157-160 -> keras_model.py:49-79): a net (or
    ensemble, `runtime.surrogate`) retrained on the measured set at the
    start of every round; every model query is a fresh forward pass, never
    served from the cache (the net changes between rounds), and never
    charges the landscape.  The cache still drives novelty rejection and
    holds the prediction as its row's truth.
  * Runner contract (reference explorer.py:115-184): round 0 measures the
    start; each round proposes the top-B generated by model score,
    measures truth and appends to the measured set.

The runner advances C cells (each its own landscape params, start, signal
strength and generator) in lockstep on a leading cell axis, the schedule
the JAX package's sweep gets from `jax.vmap`: each of the three
data-dependent loops (mutant tries, rollouts, budget passes) runs while
any cell's condition holds, and a cell whose condition is false changes no
state and draws nothing.  A single run is the C = 1 case.  Loop control is
on the host: each step fetches the cells' counters (cache sizes, costs,
alive rows) with one device sync, and the device keeps its own copy of
every counter a mask reads, so no step copies a host value to the device.
Distances cover the cache rows up to the largest filled count, with each
cell's unfilled rows masked.  Buffers are updated in place.

Randomness is one `torch.Generator` per cell, on the run's device.  A cell
draws only while it is live, in the same shapes and order whatever C is,
and every per-element computation is the same for each cell, so a cell's
result depends only on its own (params, start, signal strength, seed):
not on its neighbours or on C.  Runs are distributional matches of the JAX
package's, not bitwise.  Documented micro-deviations from the host classes
(shared with the JAX runner): duplicate rows inside one query batch each
draw independent noise; within-batch novelty dedup resolves in one pass;
novelty rejection checks the cross-round NAM cache; and the runner
proposes exactly `sequences_batch_size` sequences (highest model score
first, lowest generation index first among equal scores, as `lax.top_k`
orders them), where the host explorers keep the reference's B-1
`argsort(preds)[:-B:-1]` idiom.

The state and steps every fused runner shares (the measured set, the NAM
cache and query, the counters and their syncs, the top-B proposal and its
measurement) are `CellRun`, which the Adalead rounds (`_Run`) and the
other runners of this package (`random_runner`, `ga_runner`,
`cmaes_runner`, `bo_runner`, `gpr_bo_runner`, `cbas_runner`) subclass;
the RL runners (`dqn_runner`, `ppo_runner`, `dyna_ppo_runner`,
`dyna_ppo_mutative_runner`), which query the model every step, subclass
`AsyncCellRun`, whose queries and measurements need no host sync, and
keep their recorded pools and density caches in `Pool`s.  `DeviceRunner`
is their shared (df, metadata) and run-log wrapper.

The shared steps carry the program's spans (`utils.profiling.span`, off
unless switched on): `flexs.round` (each round of `run_cells`),
`flexs.nam_query` (the scoring and cache insertion of a query),
`flexs.mutants` and `flexs.recombine` (Adalead's proposals), `flexs.draw`
(each per-cell generator loop with its buffers), `flexs.dist` (distances
to packed rows), `flexs.oracle` (each call of the landscape's fitness),
`flexs.top_b`, `flexs.measure`, and `flexs.fetch` (the host blocked in a
sync).
"""
import time
import warnings
from datetime import datetime
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import pandas as pd
import torch

from flexs_tpu_torch.alphabet import Alphabet, as_alphabet
from flexs_tpu_torch.device import resolve_device
from flexs_tpu_torch.explorer import write_run_log
from flexs_tpu_torch.ops import packed_hamming
from flexs_tpu_torch.runtime import surrogate as surrogate_lib
from flexs_tpu_torch.utils import profiling, sequence_utils
from flexs_tpu_torch.utils.profiling import span


class AdaleadConfig(NamedTuple):
    """Adalead hyperparameters of one run."""

    rounds: int
    sequences_batch_size: int
    model_queries_per_batch: int
    alphabet_size: int
    threshold: float = 0.05
    mu: int = 1
    recomb_rate: float = 0.0
    rho: int = 0
    mutant_tries: int = 8
    # True = the surrogate is a perfect LandscapeAsModel (reference
    # model.py:30-54): predictions equal truth and model queries do NOT
    # charge the landscape cost counter.  False = NoisyAbstractModel
    # semantics (2 landscape queries per new model query).
    perfect_model: bool = False
    # Non-None = carry this trained surrogate in the run: retrained on the
    # measured buffer every round, queried for every model score, the
    # landscape charged only at measurement.  Overrides perfect_model/NAM.
    surrogate: Optional[surrogate_lib.SurrogateSpec] = None


class RunResult(NamedTuple):
    """Stacked per-round outputs of a run (tensors on the run's device).

    `run_adalead_nam_cells` adds a leading cell axis to every field.
    """

    proposal_tokens: torch.Tensor  # int64[rounds, B, L]
    proposal_preds: torch.Tensor  # f32[rounds, B]
    proposal_truth: torch.Tensor  # f32[rounds, B]
    proposal_valid: torch.Tensor  # bool[rounds, B]
    model_cost: torch.Tensor  # int64[rounds]
    landscape_cost: torch.Tensor  # int64[rounds]
    start_truth: torch.Tensor  # f32[]


# Host syncs, per-cell random draw calls and runs of `run_cells` since the
# last `reset_run_counts()`; chip_smoke.py, profile_main_path and the
# benchmark read them.
run_counts = {"runs": 0, "syncs": 0, "draw_calls": 0}


def reset_run_counts() -> None:
    """Zero `run_counts` and empty the program's span table."""
    for key in run_counts:
        run_counts[key] = 0
    profiling.reset_spans()


def cell_axis_oracle(fitness_fn: Callable) -> Callable:
    """Lift a `(params, int64[B, L]) -> f32[B]` oracle onto the cell axis.

    The lifted oracle scores int64[C, B, L] as one batch of C * B rows
    against the same params and returns f32[C, B].
    """

    def cells(params, tokens):
        c, b, length = tokens.shape
        return fitness_fn(params, tokens.reshape(c * b, length)).reshape(c, b)

    return cells


def _scatter_rows(buf, pos, rows):
    """buf[c, pos[c, i]] = rows[c, i] for every cell c and row i, in place."""
    index = pos.reshape(pos.shape + (1,) * (rows.dim() - 2)).expand(rows.shape)
    buf.scatter_(1, index, rows)


def _masked_append(buf, rows, n, mask, aux_bufs=(), aux_rows=()):
    """Write each cell's `rows[c][mask[c]]` into `buf[c]` from row `n[c]` on, in place.

    buf: [C, cap, ...]; rows: [C, m, ...]; n: int64[C]; mask: bool[C, m].
    Rows with mask=False go to the cell's trash row (its last row, never
    read), since torch has no dropping scatter.  Returns the row positions
    written.
    """
    count = torch.cumsum(mask.long(), dim=1)
    pos = torch.where(mask, n[:, None] + count - 1, buf.shape[1] - 1)
    _scatter_rows(buf, pos, rows)
    for b, r in zip(aux_bufs, aux_rows):
        _scatter_rows(b, pos, r)
    return pos


class CellRun:
    """State and steps every fused runner shares, for C cells in lockstep.

    Each cell's measured set, NAM cache (when the runner keeps one), costs
    and trained surrogate, with the steps that read them: the NAM query,
    distances to the cache, the top-B proposal and its measurement.  Each
    runner subclasses it with its own `round`.

    Per-cell counters live twice: as host lists, which drive the loops and
    the draws, and as int64[C] device tensors, which the masks read.  Where
    every cell is live (always, at C = 1), the masks and zero-fills that
    only matter for a finished cell are skipped.
    """

    def __init__(self, fitness_fn, fitness_params, start_tokens, cfg, ss, gens,
                 cache_rows: Optional[int] = None):
        """The cells' state before round 1.

        `ss` holds the cells' signal strengths, `gens` their generators;
        `cache_rows` is the number of rows the NAM cache may take in the
        whole run (None: the runner keeps no cache).
        """
        self.fitness_fn = fitness_fn
        self.fitness_params = fitness_params
        self.cfg = cfg
        self.gens = gens
        dev = self.dev = start_tokens.device
        B, R = cfg.sequences_batch_size, cfg.rounds
        self.C, self.L = C, L = start_tokens.shape
        ss = torch.as_tensor(ss, dtype=torch.float32, device=dev)
        self.cells = torch.arange(C, device=dev)[:, None]
        self.all_rows = torch.ones((C, B), dtype=torch.bool, device=dev)
        self.bits, self.per_word, self.words = packed_hamming.packing_spec(
            L, cfg.alphabet_size
        )
        # NAM alpha = ss ** distance for distances 0..L, one pow per cell so
        # that no cell's table depends on where it sits among the others.
        dist = torch.arange(L + 1, dtype=torch.float32, device=dev)
        self.alpha = torch.stack([torch.pow(ss[c], dist) for c in range(C)])

        measured_cap = 1 + R * B + 1  # +1 trash row

        self.start = start = start_tokens.long()
        with span("flexs.oracle"):
            self.start_truth = fitness_fn(fitness_params, start[:, None])[:, 0]

        self.measured_tokens = torch.zeros((C, measured_cap, L), dtype=torch.long, device=dev)
        self.measured_truth = torch.full((C, measured_cap), -torch.inf, device=dev)
        self.measured_tokens[:, 0] = start
        self.measured_truth[:, 0] = self.start_truth
        self.n_measured = torch.ones(C, dtype=torch.long, device=dev)
        self.n_measured_h = [1] * C

        if cache_rows is not None:
            cache_cap = 1 + cache_rows + 1
            self.cache_pk = torch.zeros((C, cache_cap, self.words), dtype=torch.long, device=dev)
            self.cache_vals = torch.zeros((C, cache_cap), device=dev)
            # True fitness of every cache row, recorded at insertion so NAM
            # neighbour lookups never re-run the oracle.
            self.cache_truth = torch.zeros((C, cache_cap), device=dev)
            self.cache_pk[:, 0] = self.pack(start)
            self.cache_vals[:, 0] = self.start_truth
            self.cache_truth[:, 0] = self.start_truth
        self.n_cache = [1] * C
        self.model_cost = [0] * C
        self.landscape_cost = [1] * C  # the start's measurement
        # Device copies, one tensor so that a query updates both in one op.
        self.counts_t = torch.tensor([[0] * C, [1] * C], dtype=torch.long, device=dev)
        self.model_cost_t, self.n_cache_t = self.counts_t
        if cfg.surrogate is not None:
            self.surr = surrogate_lib.init_state(
                cfg.surrogate, cfg.alphabet_size, L, gens, capacity=measured_cap
            )

    def fetch(self, values):
        """The step's one device->host sync: `values` as nested lists."""
        run_counts["syncs"] += 1
        with span("flexs.fetch"):
            return values.tolist()

    def live_gens(self, live, draws: int):
        """(cell, generator) of each live cell, counting `draws` calls for each."""
        gens = [(c, g) for c, (g, on) in enumerate(zip(self.gens, live)) if on]
        run_counts["draw_calls"] += draws * len(gens)
        return gens

    def draw_buffers(self, gens, shape, *dtypes):
        """A buffer of each dtype for one draw per cell; rows of cells not drawing read 0."""
        fill = torch.empty if len(gens) == self.C else torch.zeros
        return [fill(shape, dtype=dtype, device=self.dev) for dtype in dtypes]

    def pack(self, tokens):
        return packed_hamming.pack_tokens(tokens, self.cfg.alphabet_size, length=self.L)

    def masked_dists(self, packed, rows_pk, n_rows, bound: int):
        """Hamming int32[C, m, b] of packed rows to the first b = `bound` rows of `rows_pk`.

        Rows at or past a cell's fill `n_rows` (int64[C]) read L + 1, above
        any distance, so min and first-index argmin see only filled rows.
        """
        bound = max(1, min(bound, rows_pk.shape[1]))
        with span("flexs.dist"):
            return packed_hamming.masked_hamming_matrix(
                packed, rows_pk, n_rows, bound, self.bits, self.per_word, self.L + 1
            )

    def cache_bound(self) -> int:
        """The host's bound of the cache fills: the largest fill."""
        return max(self.n_cache)

    def dists_to_cache(self, packed):
        """Hamming distances int32[C, m, N] to the cache rows, N = `cache_bound()`."""
        return self.masked_dists(packed, self.cache_pk, self.n_cache_t, self.cache_bound())

    def novel(self, packed, mask):
        """bool[C, m]: rows of `packed` in no cache row and equal to no earlier row of `mask`."""
        novel = self.dists_to_cache(packed).amin(dim=2) > 0
        return novel & first_occurrence(packed, novel & mask)

    def nam_query(self, tokens, mask, live, charge=None):
        """Score `tokens[mask]` through the model; returns (values, cache positions).

        tokens int64[C, m, L]; mask bool[C, m], False in every row of a cell
        that is not `live`.  Cached rows return their cached value (1 model
        cost); uncached rows run the NAM corruption (1 model + 2 landscape
        costs, or 1 model cost for a perfect model) and are inserted into
        the cache.  With a surrogate every row is a fresh prediction (1
        model cost), and uncached rows are inserted with it.  `charge`
        (default `mask`) marks the rows that cost a model query.
        """
        with span("flexs.nam_query"):
            values, pos, insert = self.score_into_cache(tokens, mask, live)
        charged = mask if charge is None else charge
        sums = torch.stack([charged.sum(dim=1), insert.sum(dim=1)])
        self.counts_t += sums
        n_charged, n_insert = self.fetch(sums)
        for c in range(self.C):
            self.model_cost[c] += n_charged[c]
            self.n_cache[c] += n_insert[c]
            if self.nam_corrupts:
                self.landscape_cost[c] += 2 * n_insert[c]
        return values, pos

    @property
    def nam_corrupts(self) -> bool:
        """Whether an uncached query runs the NAM corruption (2 landscape costs a row)."""
        return not self.cfg.perfect_model and self.cfg.surrogate is None

    def random_rows(self, gens, shape):
        """int64 `shape`: uniform cache rows below each drawing cell's fill, its NAM noise rows."""
        with span("flexs.draw"):
            (idx,) = self.draw_buffers(gens, shape, torch.long)
            for c, g in gens:
                idx[c].random_(0, self.n_cache[c], generator=g)
        return idx

    def score_into_cache(self, tokens, mask, live, dedup: bool = False):
        """The device half of a NAM query: (values, cache positions, inserted rows bool[C, m]).

        `nam_query`'s scoring and cache insertion, with no count updated.
        With `dedup`, a masked row equal to an earlier masked row of its
        cell shares that row's value and position and inserts nothing.
        """
        C, m = mask.shape
        spec = self.cfg.surrogate
        pk = self.pack(tokens)
        dists = self.dists_to_cache(pk)
        min_dist = dists.amin(dim=2)
        nearest = dists.argmin(dim=2)
        cached = min_dist == 0
        cached_vals = self.cache_vals.gather(1, nearest)

        if spec is not None:
            values = signal = surrogate_lib.predict(spec, self.cfg.alphabet_size, self.surr, tokens)
        elif self.cfg.perfect_model:
            with span("flexs.oracle"):
                signal = self.fitness_fn(self.fitness_params, tokens)
            values = torch.where(cached, cached_vals, signal)
        else:
            with span("flexs.oracle"):
                signal = self.fitness_fn(self.fitness_params, tokens)
            neighbor_truth = self.cache_truth.gather(1, nearest)
            gens = self.live_gens(live, draws=2)
            with span("flexs.draw"):
                (expo,) = self.draw_buffers(gens, (C, m), torch.float32)
                for c, g in gens:
                    expo[c].exponential_(1.0, generator=g)
            rand_idx = self.random_rows(gens, (C, m))
            noise = torch.where(
                neighbor_truth >= 0, expo * neighbor_truth, self.cache_vals.gather(1, rand_idx)
            )
            alpha = self.alpha.gather(1, min_dist.long())
            nam_vals = alpha * signal + (1 - alpha) * noise
            values = torch.where(cached, cached_vals, nam_vals)

        insert = mask & ~cached
        if dedup:
            # First masked row equal to each row (itself where none is earlier).
            eq = (pk.unsqueeze(2) == pk.unsqueeze(1)).all(dim=-1) & mask.unsqueeze(1)
            order = torch.arange(m, device=self.dev).expand(C, m)
            first = torch.where(eq.any(dim=2), eq.int().argmax(dim=2), order)
            dup = first < order
            values = torch.where(dup, values.gather(1, first), values)
            insert = insert & ~dup
        pos = _masked_append(
            self.cache_pk, pk, self.n_cache_t, insert,
            aux_bufs=(self.cache_vals, self.cache_truth), aux_rows=(values, signal),
        )
        # Cached rows' "position" is their existing cache slot.
        pos = torch.where(cached, nearest, pos)
        if dedup:
            pos = torch.where(dup, pos.gather(1, first), pos)
        return values, pos, insert

    def train_surrogate(self):
        """Retrain each cell's surrogate on its measured set (no-op without one)."""
        if self.cfg.surrogate is not None:
            self.surr = surrogate_lib.train(
                self.cfg.surrogate, self.cfg.alphabet_size, self.surr, self.measured_tokens,
                self.measured_truth, self.n_measured, self.gens,
            )

    def top_b(self, gen_tokens, gen_preds, n_gen):
        """(proposals, scores, pool rows, valid) of each cell's top-B generated by model score.

        A stable sort: equal scores keep generation order, as `lax.top_k`
        orders them.
        """
        B = self.cfg.sequences_batch_size
        with span("flexs.top_b"):
            masked_preds = torch.where(
                torch.arange(gen_preds.shape[1], device=self.dev) < n_gen[:, None], gen_preds,
                -torch.inf,
            )
            ranked, order = torch.sort(masked_preds, dim=1, descending=True, stable=True)
            top_vals, top_idx = ranked[:, :B], order[:, :B]
            return gen_tokens[self.cells, top_idx], top_vals, top_idx, torch.isfinite(top_vals)

    def measure(self, proposals, top_vals, valid, slots=None, truth_to_cache=False):
        """Measure the valid proposals, append them to the measured set; the round's outputs.

        `slots` (the proposals' cache rows) get the measured truth as their
        cached value (NAM training), and as their recorded truth too with
        `truth_to_cache`.  Invalid rows write to the trash row, so no slot
        is written twice.
        """
        with span("flexs.measure"):
            truth, n_valid = self.store_measurement(proposals, valid, slots, truth_to_cache)
            for c, n in enumerate(self.fetch(n_valid)):
                self.landscape_cost[c] += n
                self.n_measured_h[c] += n
        return proposals, top_vals, truth, valid, list(self.model_cost), list(self.landscape_cost)

    def store_measurement(self, proposals, valid, slots=None, truth_to_cache=False):
        """`measure`'s device work: (truth f32[C, B], valid count int64[C]), nothing fetched."""
        with span("flexs.oracle"):
            truth = self.fitness_fn(self.fitness_params, proposals)
        truth = torch.where(valid, truth, -torch.inf)
        n_valid = valid.sum(dim=1)

        _masked_append(
            self.measured_tokens, proposals, self.n_measured, valid,
            aux_bufs=(self.measured_truth,), aux_rows=(truth,),
        )
        self.n_measured += n_valid
        if slots is not None:
            slots = torch.where(valid, slots, self.cache_vals.shape[1] - 1)
            self.cache_vals[self.cells, slots] = truth
            if truth_to_cache:
                self.cache_truth[self.cells, slots] = truth
        return truth, n_valid


def first_occurrence(packed, mask):
    """bool[C, m]: True where a packed row equals no earlier row of `mask` in its cell."""
    m = packed.shape[1]
    earlier = torch.tril(torch.ones((m, m), dtype=torch.bool, device=packed.device), diagonal=-1)
    eq = (packed.unsqueeze(2) == packed.unsqueeze(1)).all(dim=-1)
    return ~(eq & earlier & mask.unsqueeze(1)).any(dim=2)


class AsyncCellRun(CellRun):
    """A `CellRun` whose NAM queries and measurements queue on the device without a host sync.

    The RL runners query the model once or twice a step, so their counters
    (model and landscape costs, the cache's fill, the measured set's fill)
    live on the device alone, and the host bounds each fill by what could
    have been added since it was last read: distances cover the rows up to
    the bound, each cell's unfilled rows masked.  A runner reads the
    counters (`read_counts`) only where its loop control needs them.  A
    query dedups its batch: a masked row equal to an earlier masked row of
    its cell shares that row's value and noise draw and inserts no cache
    row (the JAX DynaPPO runners' rule, `dyna_ppo_runner.py:206-212`).
    NAM noise picks its random cache row as floor(u * fill), u uniform,
    since the fill is not on the host.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.landscape_cost_t = torch.ones(self.C, dtype=torch.long, device=self.dev)
        self.cache_rows_bound = 1
        self.measured_bound = 1

    def cache_bound(self) -> int:
        """The host's bound of the cache fills: the last read fill plus every row queried since."""
        return self.cache_rows_bound

    def random_rows(self, gens, shape):
        """`CellRun.random_rows` with the fill on the device: floor(u * fill), u uniform."""
        with span("flexs.draw"):
            (u,) = self.draw_buffers(gens, shape, torch.float32)
            for c, g in gens:
                u[c].uniform_(0, 1, generator=g)
        fill = self.n_cache_t[:, None]
        return torch.minimum((u * fill).long(), fill - 1)

    def query(self, tokens, mask, live):
        """Score tokens int64[C, m, L] through the model where `mask`: (values, cache positions).

        `nam_query`'s semantics without its sync, and with the batch dedup
        above; `live` (host bools) marks the cells that draw.  A masked-out
        row costs nothing and inserts nothing.
        """
        with span("flexs.nam_query"):
            values, pos, insert = self.score_into_cache(tokens, mask, live, dedup=True)
        n_insert = insert.sum(dim=1)
        self.counts_t += torch.stack([mask.sum(dim=1), n_insert])
        if self.nam_corrupts:
            self.landscape_cost_t += 2 * n_insert
        self.cache_rows_bound += mask.shape[1]
        return values, pos

    def oracle(self, tokens, mask):
        """True fitness f32[C, m] of tokens, charging the masked rows to the landscape."""
        self.landscape_cost_t += mask.sum(dim=1)
        with span("flexs.oracle"):
            return self.fitness_fn(self.fitness_params, tokens)

    def read_counts(self, *extra):
        """One host sync: the costs and cache fills into the host lists, and `extra` int64[C] tensors."""
        rows = self.fetch(torch.stack(
            [self.model_cost_t, self.n_cache_t, self.landscape_cost_t, *extra]
        ))
        self.model_cost, self.n_cache, self.landscape_cost = rows[:3]
        self.cache_rows_bound = max(self.n_cache)
        return rows[3:]

    def measured_pk(self):
        """Packed measured rows int64[C, b, K], b the host bound of the fill."""
        return self.pack(self.measured_tokens[:, : self.measured_bound])

    def novel_to_measured(self, packed, measured_pk):
        """bool[C, m]: rows of `packed` in no measured row of their cell."""
        d = self.masked_dists(packed, measured_pk, self.n_measured, measured_pk.shape[1])
        return d.amin(dim=2) > 0

    def cache_slots(self, proposals):
        """int64[C, B]: the cache row of each proposal, or the trash row where it has none."""
        d = self.dists_to_cache(self.pack(proposals))
        return torch.where(d.amin(dim=2) == 0, d.argmin(dim=2), self.cache_vals.shape[1] - 1)

    def measure_queued(self, proposals, top_vals, valid, slots=None):
        """`measure` without the sync: the round's outputs with device costs."""
        with span("flexs.measure"):
            truth, n_valid = self.store_measurement(proposals, valid, slots)
            self.landscape_cost_t += n_valid
        self.measured_bound += proposals.shape[1]
        return (proposals, top_vals, truth, valid, self.model_cost_t.clone(),
                self.landscape_cost_t.clone())


class Pool:
    """A per-cell buffer of distinct packed rows, each with a value (and its tokens).

    The RL runners' recorded pools and density caches: `upsert` keeps the
    last value of a row already present (a dict's assignment) and appends
    the others once.  `n` (int64[C]) is on the device; `bounds` holds each
    cell's host upper bound of its fill.  Row `cap` is the trash row.
    """

    def __init__(self, run: "CellRun", cap: int, fill: float, tokens: bool):
        C, dev = run.C, run.dev
        self.pk = torch.zeros((C, cap + 1, run.words), dtype=torch.long, device=dev)
        self.fit = torch.full((C, cap + 1), fill, device=dev)
        self.tokens = (torch.zeros((C, cap + 1, run.L), dtype=torch.long, device=dev)
                       if tokens else None)
        self.n = torch.zeros(C, dtype=torch.long, device=dev)
        self.bounds = [0] * C

    def live_rows(self):
        """bool[C, bound]: each cell's filled rows up to the largest bound."""
        return torch.arange(max(1, max(self.bounds)), device=self.n.device) < self.n[:, None]

    def upsert(self, run: "AsyncCellRun", pk, fit, mask, live, tokens=None):
        """pool[row] = fit for the masked rows of pk int64[C, m, K], in order (last write wins).

        `live` (host bools) marks the cells whose `mask` may hold a True: their
        bounds grow by m.
        A row equal to a row already in the pool overwrites its value; the
        others are appended, one row for equal rows of the batch.  Equal rows
        carry equal values in the runners (the model's values are cached), so
        the order of overwrites does not matter.
        """
        m = pk.shape[1]
        d = run.masked_dists(pk, self.pk, self.n, max(self.bounds))
        exists = d.amin(dim=2) == 0
        upd = exists & mask
        _scatter_rows(self.fit, torch.where(upd, d.argmin(dim=2), self.pk.shape[1] - 1), fit)
        earlier = torch.tril(torch.ones((m, m), dtype=torch.bool, device=pk.device), diagonal=-1)
        eq = (pk.unsqueeze(2) == pk.unsqueeze(1)).all(dim=-1)
        dup = (eq & earlier & mask.unsqueeze(1)).any(dim=2)
        insert = mask & ~exists & ~dup
        aux_bufs, aux_rows = (self.fit,), (fit,)
        if self.tokens is not None:
            aux_bufs, aux_rows = (self.fit, self.tokens), (fit, tokens)
        _masked_append(self.pk, pk, self.n, insert, aux_bufs=aux_bufs, aux_rows=aux_rows)
        self.n += insert.sum(dim=1)
        for c, on in enumerate(live):
            if on:
                self.bounds[c] = min(self.bounds[c] + m, self.pk.shape[1] - 1)


def _stack_costs(per_round, dev) -> torch.Tensor:
    """int64[C, rounds] of per-round costs, each a host list or a device tensor of C counts."""
    return torch.stack([torch.as_tensor(c, device=dev) for c in per_round], dim=1)


def run_cells(run: CellRun) -> RunResult:
    """Drive `run` through its rounds: the stacked `RunResult` with a leading cell axis."""
    run_counts["runs"] += 1
    outs = []
    for _ in range(run.cfg.rounds):
        with span("flexs.round"):
            outs.append(run.round())
    tokens, preds, truth, valid, model_cost, landscape_cost = zip(*outs)
    dev = run.dev
    return RunResult(
        proposal_tokens=torch.stack(tokens, dim=1),
        proposal_preds=torch.stack(preds, dim=1),
        proposal_truth=torch.stack(truth, dim=1),
        proposal_valid=torch.stack(valid, dim=1),
        model_cost=_stack_costs(model_cost, dev),
        landscape_cost=_stack_costs(landscape_cost, dev),
        start_truth=run.start_truth,
    )


def one_cell(run_cells_fn: Callable, fitness_fn: Callable, fitness_params, start_tokens,
             cfg, signal_strength: float, generator: torch.Generator, **kwargs) -> RunResult:
    """A single run through a cell-axis entry point: the C = 1 case, its cell axis dropped."""
    result = run_cells_fn(
        cell_axis_oracle(fitness_fn), fitness_params, start_tokens[None], cfg,
        [signal_strength], [generator], **kwargs,
    )
    return RunResult(*(x[0] for x in result))


class _Run(CellRun):
    """Adalead's rounds of C cells in lockstep; `run_adalead_nam_cells` drives it."""

    def __init__(self, fitness_fn, fitness_params, start_tokens, cfg, ss, gens):
        B, budget = cfg.sequences_batch_size, cfg.model_queries_per_batch
        super().__init__(fitness_fn, fitness_params, start_tokens, cfg, ss, gens,
                         cache_rows=cfg.rounds * (budget + 2 * B))
        self.gen_cap = budget + 2 * B + 1

    def novel_mutants(self, tokens, alive):
        """One novel mutant per alive row, bounded vectorized rejection.

        A cell draws in a try only while it has alive rows without a mutant.
        """
        cfg = self.cfg
        mu_per_res = cfg.mu / self.L
        result = tokens
        found = torch.zeros(alive.shape, dtype=torch.bool, device=self.dev)
        for _ in range(cfg.mutant_tries):
            todo = alive & ~found
            live = self.fetch(todo.any(dim=1))
            if not any(live):
                break
            gens = self.live_gens(live, draws=2)
            with span("flexs.draw"):
                draw, rand = self.draw_buffers(gens, tokens.shape, torch.float32, tokens.dtype)
                for c, g in gens:
                    draw[c].uniform_(0, 1, generator=g)
                    rand[c].random_(0, cfg.alphabet_size, generator=g)
            cand = torch.where(draw < mu_per_res, rand, tokens)

            cand_pk = self.pack(cand)
            # Within-batch dedup: reject a row equal to an earlier accepted
            # candidate or to any already-found result.
            novel = self.dists_to_cache(cand_pk).amin(dim=2) > 0
            rows_pk = cand_pk.unsqueeze(2)
            res_pk = self.pack(result)
            eq_res = (rows_pk == res_pk.unsqueeze(1)).all(dim=-1)
            dup_found = (eq_res & found.unsqueeze(1)).any(dim=2)

            accept = todo & novel & first_occurrence(cand_pk, todo & novel) & ~dup_found
            result = torch.where(accept.unsqueeze(2), cand, result)
            found = found | accept
        return result, found

    def recombine(self, tokens, live):
        """One recombination pass over each live cell's rows (reference adalead.py:79-92)."""
        out = tokens.clone()
        pairs = tokens.shape[1] // 2
        gens = self.live_gens(live, draws=2)
        with span("flexs.draw"):
            for c, g in gens:
                perm = torch.randperm(tokens.shape[1], generator=g, device=self.dev)
                shuffled = tokens[c][perm]
                out[c] = shuffled
                out[c, 0 : 2 * pairs : 2], out[c, 1 : 2 * pairs : 2] = sequence_utils.recombine(
                    g, shuffled[0 : 2 * pairs : 2], shuffled[1 : 2 * pairs : 2],
                    self.cfg.recomb_rate,
                )
        return out

    def round(self):
        """One propose/measure round of every cell; returns its per-round outputs."""
        cfg, dev, cells = self.cfg, self.dev, self.cells
        C, B, budget = self.C, cfg.sequences_batch_size, cfg.model_queries_per_batch
        round_start = list(self.model_cost)
        round_start_t = self.model_cost_t.clone()
        self.train_surrogate()

        # Parent selection (sign-aware threshold + np.resize tiling): row
        # b of a cell's parents is its (b mod n_selected)-th selected row.
        cap = self.measured_truth.shape[1]
        filled = torch.arange(cap, device=dev) < self.n_measured[:, None]
        truth = torch.where(filled, self.measured_truth, -torch.inf)
        top = truth.amax(dim=1)
        thr = top * (1 - torch.sign(top) * cfg.threshold)
        selected = torch.cumsum((filled & (truth >= thr[:, None])).long(), dim=1)
        rank = torch.arange(B, device=dev) % selected[:, -1:] + 1
        parents = self.measured_tokens[cells, torch.searchsorted(selected, rank)]

        # Per-round generated pool.
        gen_tokens = torch.zeros((C, self.gen_cap, self.L), dtype=torch.long, device=dev)
        gen_preds = torch.full((C, self.gen_cap), -torch.inf, device=dev)
        gen_cache_pos = torch.zeros((C, self.gen_cap), dtype=torch.long, device=dev)
        n_gen = torch.zeros(C, dtype=torch.long, device=dev)

        while True:
            in_pass = [self.model_cost[c] - round_start[c] < budget for c in range(C)]
            if not any(in_pass):
                break
            if all(in_pass):
                pass_rows = self.all_rows
            else:
                pass_rows = (self.model_cost_t - round_start_t < budget)[:, None].expand(C, B)
            # Recombination compounds across budget passes (reference
            # adalead.py:117-118 reassigns parents before each pass).
            for _ in range(cfg.rho):
                with span("flexs.recombine"):
                    parents = self.recombine(parents, in_pass)
            root_vals, _ = self.nam_query(parents, pass_rows, in_pass)

            alive, tokens = pass_rows, parents
            n_alive = [B if on else 0 for on in in_pass]
            while True:
                roll = [
                    n_alive[c] > 0 and self.model_cost[c] - round_start[c] + n_alive[c] < budget
                    for c in range(C)
                ]
                if not any(roll):
                    break
                if not all(roll):
                    n_alive_t = alive.sum(dim=1)
                    roll_t = (n_alive_t > 0) & (
                        self.model_cost_t - round_start_t + n_alive_t < budget
                    )
                    alive = alive & roll_t[:, None]
                with span("flexs.mutants"):
                    children, found = self.novel_mutants(tokens, alive)
                vals, pos = self.nam_query(children, found, roll)
                _masked_append(
                    gen_tokens, children, n_gen, found,
                    aux_bufs=(gen_preds, gen_cache_pos), aux_rows=(vals, pos),
                )
                n_gen += found.sum(dim=1)
                survive = found & (vals >= root_vals)
                n_alive = self.fetch(survive.sum(dim=1))
                alive, tokens = survive, children

        # Propose each cell's top-B generated by model score, measure truth
        # and refresh their cache values (the next round's NAM must return
        # truth for measured sequences).
        proposals, top_vals, top_idx, valid = self.top_b(gen_tokens, gen_preds, n_gen)
        return self.measure(proposals, top_vals, valid, slots=gen_cache_pos[cells, top_idx])


def run_adalead_nam_cells(
    fitness_fn: Callable,
    fitness_params,
    start_tokens: torch.Tensor,
    cfg: AdaleadConfig,
    signal_strengths,
    generators: Sequence[torch.Generator],
) -> RunResult:
    """Run C Adalead + NoisyAbstractModel experiments in lockstep.

    Args:
        fitness_fn: Pure `(fitness_params, int64[C, B, L]) -> f32[C, B]`
            oracle on the cell axis (`cell_axis_oracle` lifts a one-batch
            oracle; the sweep indexes stacked tables).
        fitness_params: Tensors the oracle reads, on the run's device.
        start_tokens: int[C, L] starting sequences on the run's device.
        cfg: Adalead configuration, shared by every cell.
        signal_strengths: NAM alpha in [0, 1] per cell (C floats).
        generators: One `torch.Generator` per cell, on the run's device:
            each cell's only source of randomness (the surrogate's too).

    Returns:
        A `RunResult` with a leading cell axis on every field.
    """
    return run_cells(
        _Run(fitness_fn, fitness_params, start_tokens, cfg, signal_strengths, list(generators))
    )


def run_adalead_nam(
    fitness_fn: Callable,
    fitness_params,
    start_tokens: torch.Tensor,
    cfg: AdaleadConfig,
    signal_strength: float,
    generator: torch.Generator,
) -> RunResult:
    """Run a full Adalead + NoisyAbstractModel experiment: the one-cell case.

    Args:
        fitness_fn: Pure `(fitness_params, int64[B, L]) -> f32[B]` oracle.
        fitness_params: Tensors the oracle reads, on the run's device.
        start_tokens: int[L] starting sequence on the run's device.
        cfg: Adalead configuration.
        signal_strength: NAM alpha in [0, 1].
        generator: The run's only source of randomness, on its device.

    Returns:
        A `RunResult` of stacked per-round tensors.
    """
    return one_cell(run_adalead_nam_cells, fitness_fn, fitness_params, start_tokens, cfg,
                    signal_strength, generator)


class DeviceRunner:
    """(df, metadata) wrapper the fused runners share.

    Produces the same measured-data schema and log format as
    `Explorer.run` (reference explorer.py:115-184).  A subclass sets
    `single_run` (its one-cell entry point), `label`, and in its
    constructor `name` and the entry point's keywords `run_kwargs`.
    """

    label = "device"
    run_kwargs: dict = {}

    def __init__(
        self,
        landscape,
        alphabet,
        rounds: int,
        sequences_batch_size: int,
        model_queries_per_batch: int,
        starting_sequence: str,
        signal_strength: float,
        seed: int,
        model: str,
        surrogate_spec: Optional[surrogate_lib.SurrogateSpec],
        log_file: Optional[str],
        device,
        default_spec: surrogate_lib.SurrogateSpec = surrogate_lib.SurrogateSpec(),
        **cfg_fields,
    ):
        """Check the options and build the run's configuration on `device` (default "cuda").

        `landscape` must expose `device_fitness()` and live on the same
        device.  `model` selects the fused model: "nam" (NoisyAbstractModel
        at `signal_strength`), "perfect" (LandscapeAsModel semantics:
        predictions equal truth, model queries don't charge the landscape)
        or "surrogate" (a net retrained on the measured set every round,
        configured by `surrogate_spec`, default `default_spec`).
        `cfg_fields` are further `AdaleadConfig` fields.
        """
        if model not in ("nam", "perfect", "surrogate"):
            raise ValueError("model must be 'nam', 'perfect' or 'surrogate'")
        if model == "surrogate":
            surrogate_spec = surrogate_spec or default_spec
            surrogate_lib.check_spec(surrogate_spec)
        if rounds < 1:
            raise ValueError("rounds must be >= 1 for the fused runner")
        self.device = resolve_device(device)
        landscape_device = getattr(landscape, "device", self.device)
        if landscape_device != self.device:
            raise ValueError(
                f"landscape lives on {landscape_device}, runner on {self.device}"
            )
        self.landscape = landscape
        self.alphabet: Alphabet = as_alphabet(alphabet)
        self.starting_sequence = starting_sequence
        self.signal_strength = 1.0 if model != "nam" else signal_strength
        self.seed = seed
        self.log_file = log_file
        if model == "perfect":
            self.model_name = f"LandscapeAsModel={landscape.name}"
        elif model == "surrogate":
            self.model_name = surrogate_spec.model_name
        else:
            self.model_name = f"NAMb_ss{signal_strength}"

        self.cfg = AdaleadConfig(
            rounds=rounds,
            sequences_batch_size=sequences_batch_size,
            model_queries_per_batch=model_queries_per_batch,
            alphabet_size=len(self.alphabet),
            perfect_model=(model == "perfect"),
            surrogate=surrogate_spec if model == "surrogate" else None,
            **cfg_fields,
        )
        self._fitness_fn, self._fitness_params = landscape.device_fitness()

    def _run_one(self, start_tokens: torch.Tensor, generator: torch.Generator) -> RunResult:
        return self.single_run(
            self._fitness_fn, self._fitness_params, start_tokens, self.cfg,
            float(self.signal_strength), generator, **self.run_kwargs,
        )

    def _check_result(self, result: RunResult) -> None:
        """Raise for a degenerate run (the base accepts any)."""

    def run(self, verbose: bool = True) -> Tuple[pd.DataFrame, dict]:
        """Execute the run and return (sequences_data, metadata)."""
        start_time = time.time()
        start_tokens = torch.as_tensor(
            self.alphabet.encode_one(self.starting_sequence), device=self.device
        )
        generator = torch.Generator(device=self.device)
        generator.manual_seed(self.seed)

        result = self._run_one(start_tokens, generator)
        result = RunResult(*(x.cpu().numpy() for x in result))
        self._check_result(result)

        # Sync cost accounting into the landscape object.
        self.landscape.add_cost(int(result.landscape_cost[-1]))

        metadata = {
            "run_id": datetime.now().strftime("%H:%M:%S-%m/%d/%Y"),
            "exp_name": self.name,
            "model_name": self.model_name,
            "landscape_name": self.landscape.name,
            "rounds": self.cfg.rounds,
            "sequences_batch_size": self.cfg.sequences_batch_size,
            "model_queries_per_batch": self.cfg.model_queries_per_batch,
        }

        rows = {
            "sequence": [self.starting_sequence],
            "model_score": [np.nan],
            "true_score": [float(result.start_truth)],
            "round": [0],
            "model_cost": [0],
            "measurement_cost": [1],
        }
        measured = 1
        for r in range(self.cfg.rounds):
            valid = result.proposal_valid[r]
            seqs = self.alphabet.decode(result.proposal_tokens[r][valid])
            measured += len(seqs)
            rows["sequence"].extend(seqs)
            rows["model_score"].extend(result.proposal_preds[r][valid].tolist())
            rows["true_score"].extend(result.proposal_truth[r][valid].tolist())
            rows["round"].extend([r + 1] * len(seqs))
            rows["model_cost"].extend([int(result.model_cost[r])] * len(seqs))
            rows["measurement_cost"].extend([measured] * len(seqs))

        df = pd.DataFrame(rows)

        if self.log_file is not None:
            write_run_log(self.log_file, metadata, df)
        if verbose:
            print(
                f"{self.label} run: top {df['true_score'].max():.4f}, "
                f"time {time.time() - start_time:.3f}s"
            )
        return df, metadata


class DeviceAdaleadNAM(DeviceRunner):
    """(df, metadata) wrapper over `run_adalead_nam`."""

    single_run = staticmethod(run_adalead_nam)

    def __init__(
        self,
        landscape,
        alphabet,
        rounds: int,
        sequences_batch_size: int,
        model_queries_per_batch: int,
        starting_sequence: str,
        signal_strength: float = 0.9,
        threshold: float = 0.05,
        mu: int = 1,
        recomb_rate: float = 0.0,
        rho: int = 0,
        seed: int = 0,
        model: str = "nam",
        surrogate_spec: Optional[surrogate_lib.SurrogateSpec] = None,
        log_file: Optional[str] = None,
        device=None,
    ):
        """Create a fused runner for `landscape` on `device` (default "cuda").

        `model` is "nam", "perfect" or "surrogate" (`DeviceRunner`; the
        default surrogate is the paper's CNN_hidden_size_100_num_filters_32).
        """
        super().__init__(
            landscape, alphabet, rounds, sequences_batch_size, model_queries_per_batch,
            starting_sequence, signal_strength, seed, model, surrogate_spec, log_file, device,
            threshold=threshold, mu=mu, recomb_rate=recomb_rate, rho=rho,
        )
        if model_queries_per_batch < sequences_batch_size:
            warnings.warn(
                "`model_queries_per_batch` should be >= `sequences_batch_size`"
            )
        self.name = f"DeviceAdalead_mu={mu}_threshold={threshold}"

    def _check_result(self, result):
        if not result.proposal_valid.any():
            # Every round proposed nothing: the reference raises ValueError
            # mid-run in this degenerate-budget case (adalead.py:165-170).
            raise ValueError(
                "No sequences generated in any round. If `model_queries_"
                "per_batch` is very small, increase it."
            )
