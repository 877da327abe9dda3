"""GPR_BO runs over the fully enumerated sequence space, on the device.

The port of the JAX package's `runtime/gpr_bo_runner.py`, which fuses the
posterior-enumeration explorer (baselines/explorers/bo.py `GPR_BO`, a
redesign of reference baselines/explorers/bo.py:260-410) with the model.
Every round the whole A^L space is scored in chunks of `eval_chunk`
(indexed by big-endian mixed radix, as the host explorer's
`_space_tokens`), ranked by the acquisition (Thompson, Greedy or UCB,
reference bo.py:383-431), and the top `sequences_batch_size` unmeasured
points become the proposals (reference bo.py:433-461).  GPR_BO is
unbudgeted by design (reference bo.py:264-266): `model_queries_per_batch`
is ignored and the model is charged the space's size each round, as the
host explorer's `add_cost(n)`.

Model modes, as in the JAX runner:
  * nam: round 1 queries the whole space against a cache holding only the
    start, so every point's alpha is ss^(Hamming to start), and the
    predictions cache themselves (reference noisy_abstract_model.py:95-99):
    from round 2 on every query is a cache hit and the ranking is frozen,
    apart from measured points, whose truth overwrites their prediction
    (reference :62-67).  Fresh NAM draws happen only in round 1, against
    the measured set ({start}); later rounds read the table and draw only
    the Thompson noise.
  * perfect: mu is the landscape, sigma 0.
  * surrogate: a trained ensemble's unweighted member mean and population
    std (reference bo.py:318-319; one member gives sigma 0, so Thompson
    and UCB rank by mu), or the exact GP's posterior (arch "gp").

The host explorer reports the acquisition score as `model_score`, and so
does this runner (under Thompson it holds the posterior-sample noise).
Proposals are the top-B of the masked scores by a stable sort, so that
equal scores resolve by space index, as `lax.top_k` resolves them (a
perfect model on a TF-Bind table has ties).  Cells, generators, the
measured set and costs are `jit_runner.CellRun`'s.
"""
from typing import Callable, Optional, Sequence

import torch

from flexs_tpu_torch.ops import packed_hamming
from flexs_tpu_torch.runtime import surrogate as surrogate_lib
from flexs_tpu_torch.runtime.bo_runner import member_stats
from flexs_tpu_torch.runtime.jit_runner import (
    AdaleadConfig,
    CellRun,
    DeviceRunner,
    RunResult,
    _masked_append,
    one_cell,
    run_cells,
)

# The host explorer refuses spaces over 20M (bo.py:331-336); the fused
# runner keeps full-space f32 tables per cell, so the cap is tighter.
MAX_SPACE = 1 << 20
METHODS = ("Thompson", "Greedy", "UCB")


def check_space(alphabet_size: int, length: int) -> int:
    """The space's size A^L; raises ValueError above MAX_SPACE."""
    space = alphabet_size ** length
    if space > MAX_SPACE:
        raise ValueError(
            f"GPR_BO enumerates the whole space; {alphabet_size}^{length} = {space} exceeds "
            f"the fused runner's {MAX_SPACE} cap (the host explorer handles up to 20M)"
        )
    return space


class _GPRBORun(CellRun):
    """GPR_BO's rounds of C cells in lockstep."""

    def __init__(self, fitness_fn, fitness_params, start_tokens, cfg, ss, gens, method: str,
                 eval_chunk: int):
        if method not in METHODS:
            raise ValueError(f"unknown seq_proposal_method {method!r}")
        self.S = S = check_space(cfg.alphabet_size, start_tokens.shape[1])
        super().__init__(fitness_fn, fitness_params, start_tokens, cfg, ss, gens)
        self.method = method
        C, L, A, dev = self.C, self.L, cfg.alphabet_size, self.dev
        self.chunk = min(eval_chunk, S)
        self.n_chunks = -(-S // self.chunk)
        s_pad = self.n_chunks * self.chunk
        self.radix = torch.tensor([A ** (L - 1 - j) for j in range(L)], device=dev)
        start_idx = (self.start * self.radix).sum(dim=1, keepdim=True)
        rows = self.cells
        self.measured_mask = torch.zeros((C, s_pad), dtype=torch.bool, device=dev)
        self.measured_mask[rows, start_idx] = True
        self.nam = cfg.surrogate is None and not cfg.perfect_model
        if self.nam:
            # The NAM prediction cache as full-space tables.
            self.pred_table = torch.zeros((C, s_pad), device=dev)
            self.pred_table[rows, start_idx] = self.start_truth[:, None]
            self.pred_mask = self.measured_mask.clone()
            self.pred_full = False
            self.m_pk = torch.zeros((C, self.measured_tokens.shape[1], self.words),
                                    dtype=torch.long, device=dev)
            self.m_pk[:, 0] = self.pack(self.start)

    def idx_to_tokens(self, idx):
        return (idx[..., None] // self.radix) % self.cfg.alphabet_size

    def fresh_nam(self, tokens, live_gens):
        """Round 1's NAM predictions f32[C, chunk] of tokens against the measured set."""
        C, n = tokens.shape[:2]
        signal = self.fitness_fn(self.fitness_params, tokens)
        n_max = max(self.n_measured_h)
        d = packed_hamming.masked_hamming_matrix(
            self.pack(tokens), self.m_pk, self.n_measured, n_max, self.bits, self.per_word,
            self.L + 1,
        )
        min_dist, nearest = d.amin(dim=2), d.argmin(dim=2)
        expo, rand_idx = self.draw_buffers(live_gens, (C, n), torch.float32, torch.long)
        for c, g in live_gens:
            expo[c].exponential_(1.0, generator=g)
            rand_idx[c].random_(0, self.n_measured_h[c], generator=g)
        neighbor_truth = self.measured_truth.gather(1, nearest)
        noise = torch.where(neighbor_truth >= 0, expo * neighbor_truth,
                            self.measured_truth.gather(1, rand_idx))
        alpha = self.alpha.gather(1, min_dist.long())
        return alpha * signal + (1 - alpha) * noise

    def round(self):
        cfg, dev, cells = self.cfg, self.dev, self.cells
        C, A, S, chunk = self.C, cfg.alphabet_size, self.S, self.chunk
        spec = cfg.surrogate
        self.train_surrogate()

        s_pad = self.n_chunks * chunk
        scores = torch.empty((C, s_pad), device=dev)
        mus = torch.empty((C, s_pad), device=dev)
        n_fresh = torch.zeros(C, dtype=torch.long, device=dev)
        every = [True] * C
        for ci in range(self.n_chunks):
            idx = ci * chunk + torch.arange(chunk, device=dev)
            in_space = idx < S
            tokens = self.idx_to_tokens(idx.clamp(max=S - 1)).expand(C, chunk, self.L)
            sigma = None
            if spec is not None and spec.arch == "gp":
                mu, sigma = surrogate_lib.posterior(spec, A, self.surr, tokens)
            elif spec is not None:
                mu, sigma = member_stats(surrogate_lib.predict_members(spec, A, self.surr, tokens))
            elif cfg.perfect_model:
                mu = self.fitness_fn(self.fitness_params, tokens)
            elif self.pred_full:
                mu = self.pred_table[:, idx]
            else:
                cached = self.pred_mask[:, idx]
                fresh = self.fresh_nam(tokens, self.live_gens(every, draws=2))
                mu = torch.where(cached, self.pred_table[:, idx], fresh)
                n_fresh += (~cached & in_space).sum(dim=1)

            if self.method == "Thompson":
                normal = torch.empty((C, chunk), device=dev)
                for c, g in self.live_gens(every, draws=1):
                    normal[c].normal_(generator=g)
                spread = 1e-12 if sigma is None else sigma.clamp(min=1e-12)
                score = mu + spread * normal
            elif self.method == "UCB" and sigma is not None:
                score = mu + 0.01 * sigma
            else:  # Greedy, or UCB with sigma 0
                score = mu
            sl = slice(ci * chunk, (ci + 1) * chunk)
            scores[:, sl] = torch.where(in_space & ~self.measured_mask[:, idx], score, -torch.inf)
            mus[:, sl] = mu

        for c in range(C):
            self.model_cost[c] += S
        self.model_cost_t += S
        if self.nam and not self.pred_full:
            # Two landscape queries per fresh prediction (reference
            # noisy_abstract_model.py:87-88), and the predictions cache
            # themselves (:95-99).
            for c, n in enumerate(self.fetch(n_fresh)):
                self.landscape_cost[c] += 2 * n
            self.pred_table = torch.where(self.pred_mask, self.pred_table, mus)
            self.pred_full = True

        ranked, order = torch.sort(scores, dim=1, descending=True, stable=True)
        B = cfg.sequences_batch_size
        top_vals, top_idx = ranked[:, :B], order[:, :B]
        valid = torch.isfinite(top_vals)
        proposals = self.idx_to_tokens(top_idx.clamp(max=S - 1))
        if self.nam:
            _masked_append(self.m_pk, self.pack(proposals), self.n_measured.clone(), valid)
        out = self.measure(proposals, top_vals, valid)
        truth = out[2]
        self.measured_mask[cells, top_idx] |= valid
        if self.nam:
            # NAM training: the measured truth overwrites the prediction.
            self.pred_table[cells, top_idx] = torch.where(
                valid, truth, self.pred_table[cells, top_idx]
            )
        return out


def run_gpr_bo_nam_cells(
    fitness_fn: Callable,
    fitness_params,
    start_tokens: torch.Tensor,
    cfg: AdaleadConfig,
    signal_strengths,
    generators: Sequence[torch.Generator],
    method: str = "Thompson",
    eval_chunk: int = 4096,
) -> RunResult:
    """Run C GPR_BO experiments in lockstep.

    The arguments are `run_adalead_nam_cells`' plus the acquisition
    ("Thompson", "Greedy" or "UCB") and the scoring chunk.  Returns a
    `RunResult` with a leading cell axis.
    """
    return run_cells(_GPRBORun(fitness_fn, fitness_params, start_tokens, cfg, signal_strengths,
                               list(generators), method, eval_chunk))


def run_gpr_bo_nam(fitness_fn: Callable, fitness_params, start_tokens: torch.Tensor,
                   cfg: AdaleadConfig, signal_strength: float, generator: torch.Generator,
                   method: str = "Thompson", eval_chunk: int = 4096) -> RunResult:
    """One GPR_BO experiment (`run_gpr_bo_nam_cells` at C = 1)."""
    return one_cell(run_gpr_bo_nam_cells, fitness_fn, fitness_params, start_tokens, cfg,
                    signal_strength, generator, method=method, eval_chunk=eval_chunk)


class DeviceGPRBONAM(DeviceRunner):
    """(df, metadata) wrapper over `run_gpr_bo_nam`."""

    label = "device GPR_BO"
    single_run = staticmethod(run_gpr_bo_nam)

    def __init__(
        self,
        landscape,
        alphabet,
        rounds: int,
        sequences_batch_size: int,
        model_queries_per_batch: int,
        starting_sequence: str,
        method: str = "Thompson",
        eval_chunk: int = 4096,
        signal_strength: float = 0.9,
        model: str = "nam",
        surrogate_spec: Optional[surrogate_lib.SurrogateSpec] = None,
        seed: int = 0,
        log_file: Optional[str] = None,
        device=None,
    ):
        """The fused GPR_BO runner for `landscape` on `device` (default "cuda").

        `model_queries_per_batch` is kept for the interface and ignored
        (module docstring).  `model` is "nam", "perfect" or "surrogate"
        (`DeviceRunner`; the default surrogate is a 3-CNN ensemble, so
        that Thompson and UCB see a member spread).
        """
        if method not in METHODS:
            raise ValueError(f"unknown seq_proposal_method {method!r}")
        super().__init__(
            landscape, alphabet, rounds, sequences_batch_size, model_queries_per_batch,
            starting_sequence, signal_strength, seed, model, surrogate_spec, log_file, device,
            default_spec=surrogate_lib.SurrogateSpec(ensemble_size=3),
        )
        check_space(len(self.alphabet), len(starting_sequence))
        self.run_kwargs = dict(method=method, eval_chunk=eval_chunk)
        self.name = f"DeviceGPR_BO_method={method}"
