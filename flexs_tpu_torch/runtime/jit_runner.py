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
  * Runner contract (reference explorer.py:115-184): round 0 measures the
    start; each round proposes the top-B generated by model score,
    measures truth and appends to the measured set.

The three data-dependent loops (mutant tries, rollouts, budget passes) are
Python loops.  Their conditions read host counters (cache size, costs,
alive rows) that each step fetches with one device sync, and the cache
distance matrices cover only the filled rows.  Buffers are updated in
place.  Randomness is one `torch.Generator` on the run's device, so runs
are distributional matches of the JAX package's, not bitwise.  Documented
micro-deviations from the host classes (shared with the JAX runner):
duplicate rows inside one query batch each draw independent noise;
within-batch novelty dedup resolves in one pass; novelty rejection checks
the cross-round NAM cache; and the runner proposes exactly
`sequences_batch_size` sequences via top-k, where the host explorers keep
the reference's B-1 `argsort(preds)[:-B:-1]` idiom.
"""
import time
import warnings
from datetime import datetime
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import pandas as pd
import torch

from flexs_tpu_torch.alphabet import Alphabet, as_alphabet
from flexs_tpu_torch.device import resolve_device
from flexs_tpu_torch.explorer import write_run_log
from flexs_tpu_torch.ops import packed_hamming


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


class RunResult(NamedTuple):
    """Stacked per-round outputs of a run (tensors on the run's device)."""

    proposal_tokens: torch.Tensor  # int64[rounds, B, L]
    proposal_preds: torch.Tensor  # f32[rounds, B]
    proposal_truth: torch.Tensor  # f32[rounds, B]
    proposal_valid: torch.Tensor  # bool[rounds, B]
    model_cost: torch.Tensor  # int64[rounds]
    landscape_cost: torch.Tensor  # int64[rounds]
    start_truth: torch.Tensor  # f32[]


def _masked_append(buf, rows, n: int, mask, aux_bufs=(), aux_rows=()):
    """Write `rows[mask]` into `buf` from row `n` on, in order, in place.

    Rows with mask=False go to the trash row (the buffers' last row), since
    torch has no dropping scatter.  Returns the row positions written.
    """
    count = torch.cumsum(mask.long(), dim=0)
    pos = torch.where(mask, n + count - 1, buf.shape[0] - 1)
    buf[pos] = rows
    for b, r in zip(aux_bufs, aux_rows):
        b[pos] = r
    return pos


class _Run:
    """State and steps of one run; `run_adalead_nam` drives it."""

    def __init__(self, fitness_fn, fitness_params, start_tokens, cfg, ss, gen):
        self.fitness_fn = fitness_fn
        self.fitness_params = fitness_params
        self.cfg = cfg
        self.gen = gen
        dev = self.dev = start_tokens.device
        B, R = cfg.sequences_batch_size, cfg.rounds
        budget = cfg.model_queries_per_batch
        self.L = L = start_tokens.shape[0]
        self.ss = torch.tensor(ss, dtype=torch.float32, device=dev)
        self.bits, self.per_word, words = packed_hamming.packing_spec(
            L, cfg.alphabet_size
        )

        measured_cap = 1 + R * B + 1  # +1 trash row
        cache_cap = 1 + R * (budget + 2 * B) + 1
        self.gen_cap = budget + 2 * B + 1

        start = start_tokens.long()
        self.start_truth = fitness_fn(fitness_params, start[None])[0]

        self.measured_tokens = torch.zeros((measured_cap, L), dtype=torch.long, device=dev)
        self.measured_truth = torch.full((measured_cap,), -torch.inf, device=dev)
        self.measured_tokens[0] = start
        self.measured_truth[0] = self.start_truth
        self.n_measured = 1

        self.cache_pk = torch.zeros((cache_cap, words), dtype=torch.long, device=dev)
        self.cache_vals = torch.zeros((cache_cap,), device=dev)
        # True fitness of every cache row, recorded at insertion so NAM
        # neighbour lookups never re-run the oracle.
        self.cache_truth = torch.zeros((cache_cap,), device=dev)
        self.cache_pk[0] = self.pack(start[None])[0]
        self.cache_vals[0] = self.start_truth
        self.cache_truth[0] = self.start_truth
        self.n_cache = 1

        self.model_cost = 0
        self.landscape_cost = 1  # the start's measurement

    def pack(self, tokens):
        return packed_hamming.pack_tokens(tokens, self.cfg.alphabet_size, length=self.L)

    def dists_to_cache(self, packed):
        """Hamming distances int32[B, n_cache] to the filled cache rows."""
        return packed_hamming.packed_hamming_matrix(
            packed, self.cache_pk[: self.n_cache], self.bits, self.per_word
        )

    def nam_query(self, tokens, mask):
        """Score `tokens[mask]` through the model; returns (values, cache positions).

        Cached rows return their cached value (1 model cost); uncached rows
        run the NAM corruption (1 model + 2 landscape costs, or 1 model cost
        for a perfect model) and are inserted into the cache.
        """
        n = tokens.shape[0]
        pk = self.pack(tokens)
        dists = self.dists_to_cache(pk)
        min_dist = dists.amin(dim=1)
        nearest = dists.argmin(dim=1)
        cached = min_dist == 0
        cached_vals = self.cache_vals[nearest]
        signal = self.fitness_fn(self.fitness_params, tokens)

        if self.cfg.perfect_model:
            values = torch.where(cached, cached_vals, signal)
        else:
            neighbor_truth = self.cache_truth[nearest]
            expo = torch.empty(n, device=self.dev).exponential_(1.0, generator=self.gen)
            rand_idx = torch.randint(
                0, self.n_cache, (n,), generator=self.gen, device=self.dev
            )
            noise = torch.where(
                neighbor_truth >= 0, expo * neighbor_truth, self.cache_vals[rand_idx]
            )
            alpha = torch.pow(self.ss, min_dist.float())
            nam_vals = alpha * signal + (1 - alpha) * noise
            values = torch.where(cached, cached_vals, nam_vals)

        insert = mask & ~cached
        pos = _masked_append(
            self.cache_pk, pk, self.n_cache, insert,
            aux_bufs=(self.cache_vals, self.cache_truth), aux_rows=(values, signal),
        )
        # Cached rows' "position" is their existing cache slot.
        pos = torch.where(cached, nearest, pos)

        n_mask, n_insert = torch.stack([mask.sum(), insert.sum()]).tolist()
        self.n_cache += n_insert
        self.model_cost += n_mask
        if not self.cfg.perfect_model:
            self.landscape_cost += 2 * n_insert
        return values, pos

    def novel_mutants(self, tokens, alive):
        """One novel mutant per alive row, bounded vectorized rejection."""
        cfg = self.cfg
        mu_per_res = cfg.mu / self.L
        result = tokens
        found = torch.zeros(tokens.shape[0], dtype=torch.bool, device=self.dev)
        for _ in range(cfg.mutant_tries):
            todo = alive & ~found
            if not bool(todo.any()):
                break
            mut_mask = torch.rand(tokens.shape, generator=self.gen, device=self.dev) < mu_per_res
            rand = torch.randint(
                0, cfg.alphabet_size, tokens.shape, generator=self.gen, device=self.dev
            )
            cand = torch.where(mut_mask, rand, tokens)

            cand_pk = self.pack(cand)
            novel = self.dists_to_cache(cand_pk).amin(dim=1) > 0
            # Within-batch dedup: reject a row equal to an earlier accepted
            # candidate or to any already-found result.
            eq_self = (cand_pk[:, None, :] == cand_pk[None, :, :]).all(dim=-1)
            earlier = (
                torch.tril(torch.ones_like(eq_self), diagonal=-1)
                & eq_self
                & (todo & novel)[None, :]
            )
            res_pk = self.pack(result)
            eq_res = (cand_pk[:, None, :] == res_pk[None, :, :]).all(dim=-1)
            dup_found = (eq_res & found[None, :]).any(dim=1)

            accept = todo & novel & ~earlier.any(dim=1) & ~dup_found
            result = torch.where(accept[:, None], cand, result)
            found = found | accept
        return result, found

    def recombine(self, tokens):
        perm = torch.randperm(tokens.shape[0], generator=self.gen, device=self.dev)
        shuffled = tokens[perm]
        pairs = tokens.shape[0] // 2
        a = shuffled[0 : 2 * pairs : 2]
        b = shuffled[1 : 2 * pairs : 2]
        crossover = (
            torch.rand(a.shape, generator=self.gen, device=self.dev) < self.cfg.recomb_rate
        )
        switch = torch.cumsum(crossover.long(), dim=1) % 2 == 1
        out = shuffled.clone()
        out[0 : 2 * pairs : 2] = torch.where(switch, a, b)
        out[1 : 2 * pairs : 2] = torch.where(switch, b, a)
        return out

    def round(self):
        """One propose/measure round; returns its per-round outputs."""
        cfg, dev = self.cfg, self.dev
        B, budget = cfg.sequences_batch_size, cfg.model_queries_per_batch
        round_start_cost = self.model_cost

        # Parent selection (sign-aware threshold + np.resize tiling).
        truth = self.measured_truth[: self.n_measured]
        top = truth.max()
        thr = top * (1 - torch.sign(top) * cfg.threshold)
        sel = torch.nonzero(truth >= thr)[:, 0]
        parents = self.measured_tokens[sel[torch.arange(B, device=dev) % len(sel)]]

        # Per-round generated pool.
        gen_tokens = torch.zeros((self.gen_cap, self.L), dtype=torch.long, device=dev)
        gen_preds = torch.full((self.gen_cap,), -torch.inf, device=dev)
        gen_cache_pos = torch.zeros((self.gen_cap,), dtype=torch.long, device=dev)
        n_gen = 0

        all_rows = torch.ones(B, dtype=torch.bool, device=dev)
        while self.model_cost - round_start_cost < budget:
            # Recombination compounds across budget passes (reference
            # adalead.py:117-118 reassigns parents before each pass).
            for _ in range(cfg.rho):
                parents = self.recombine(parents)
            root_vals, _ = self.nam_query(parents, all_rows)

            alive, tokens, n_alive = all_rows, parents, B
            while n_alive > 0 and self.model_cost - round_start_cost + n_alive < budget:
                children, found = self.novel_mutants(tokens, alive)
                vals, pos = self.nam_query(children, found)
                _masked_append(
                    gen_tokens, children, n_gen, found,
                    aux_bufs=(gen_preds, gen_cache_pos), aux_rows=(vals, pos),
                )
                survive = found & (vals >= root_vals)
                n_found, n_alive = torch.stack([found.sum(), survive.sum()]).tolist()
                n_gen += n_found
                alive, tokens = survive, children

        # Propose top-B generated by model score, measure truth, append.
        masked_preds = torch.where(
            torch.arange(self.gen_cap, device=dev) < n_gen, gen_preds, -torch.inf
        )
        top_vals, top_idx = torch.topk(masked_preds, B)
        valid = torch.isfinite(top_vals)
        proposals = gen_tokens[top_idx]
        truth = self.fitness_fn(self.fitness_params, proposals)
        truth = torch.where(valid, truth, -torch.inf)
        n_valid = int(valid.sum())
        self.landscape_cost += n_valid

        _masked_append(
            self.measured_tokens, proposals, self.n_measured, valid,
            aux_bufs=(self.measured_truth,), aux_rows=(truth,),
        )
        self.n_measured += n_valid
        # Refresh cache values of measured proposals with the truth (the
        # next round's NAM must return truth for measured sequences).
        # Invalid rows write to the trash row, so no slot is written twice.
        slots = torch.where(valid, gen_cache_pos[top_idx], self.cache_vals.shape[0] - 1)
        self.cache_vals[slots] = truth
        return proposals, top_vals, truth, valid, self.model_cost, self.landscape_cost


def run_adalead_nam(
    fitness_fn: Callable,
    fitness_params,
    start_tokens: torch.Tensor,
    cfg: AdaleadConfig,
    signal_strength: float,
    generator: torch.Generator,
) -> RunResult:
    """Run a full Adalead + NoisyAbstractModel experiment.

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
    run = _Run(fitness_fn, fitness_params, start_tokens, cfg, signal_strength, generator)
    outs = [run.round() for _ in range(cfg.rounds)]
    tokens, preds, truth, valid, model_cost, landscape_cost = zip(*outs)
    dev = run.dev
    return RunResult(
        proposal_tokens=torch.stack(tokens),
        proposal_preds=torch.stack(preds),
        proposal_truth=torch.stack(truth),
        proposal_valid=torch.stack(valid),
        model_cost=torch.tensor(model_cost, device=dev),
        landscape_cost=torch.tensor(landscape_cost, device=dev),
        start_truth=run.start_truth,
    )


class DeviceAdaleadNAM:
    """(df, metadata) wrapper over `run_adalead_nam`.

    Produces the same measured-data schema and log format as
    `Explorer.run` (reference explorer.py:115-184).
    """

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
        log_file: Optional[str] = None,
        device=None,
    ):
        """Create a fused runner for `landscape` on `device` (default "cuda").

        `landscape` must expose `device_fitness()` and live on the same
        device.  `model` selects the fused surrogate: "nam"
        (NoisyAbstractModel at `signal_strength`) or "perfect"
        (LandscapeAsModel semantics: predictions equal truth, model queries
        don't charge the landscape).
        """
        if model not in ("nam", "perfect", "surrogate"):
            raise ValueError("model must be 'nam', 'perfect' or 'surrogate'")
        if model == "surrogate":
            raise NotImplementedError(
                "model='surrogate' is not ported yet (ROADMAP.md, item 15)"
            )
        if rounds < 1:
            raise ValueError("rounds must be >= 1 for the fused runner")
        if model_queries_per_batch < sequences_batch_size:
            warnings.warn(
                "`model_queries_per_batch` should be >= `sequences_batch_size`"
            )
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
        self.name = f"DeviceAdalead_mu={mu}_threshold={threshold}"
        if model == "perfect":
            self.model_name = f"LandscapeAsModel={landscape.name}"
        else:
            self.model_name = f"NAMb_ss{signal_strength}"

        self.cfg = AdaleadConfig(
            rounds=rounds,
            sequences_batch_size=sequences_batch_size,
            model_queries_per_batch=model_queries_per_batch,
            alphabet_size=len(self.alphabet),
            threshold=threshold,
            mu=mu,
            recomb_rate=recomb_rate,
            rho=rho,
            perfect_model=(model == "perfect"),
        )
        self._fitness_fn, self._fitness_params = landscape.device_fitness()

    def run(self, verbose: bool = True) -> Tuple[pd.DataFrame, dict]:
        """Execute the run and return (sequences_data, metadata)."""
        start_time = time.time()
        start_tokens = torch.as_tensor(
            self.alphabet.encode_one(self.starting_sequence), device=self.device
        )
        generator = torch.Generator(device=self.device)
        generator.manual_seed(self.seed)

        result = run_adalead_nam(
            self._fitness_fn,
            self._fitness_params,
            start_tokens,
            self.cfg,
            float(self.signal_strength),
            generator,
        )
        result = RunResult(*(x.cpu().numpy() for x in result))
        if not result.proposal_valid.any():
            # Every round proposed nothing: the reference raises ValueError
            # mid-run in this degenerate-budget case (adalead.py:165-170).
            raise ValueError(
                "No sequences generated in any round. If `model_queries_"
                "per_batch` is very small, increase it."
            )

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
                f"device run: top {df['true_score'].max():.4f}, "
                f"time {time.time() - start_time:.3f}s"
            )
        return df, metadata
