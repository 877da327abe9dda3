"""Evo-BO + NoisyAbstractModel runs with every round's work on the device.

The port of the JAX package's `runtime/bo_runner.py`, which fuses the
batched-lockstep BO explorer (baselines/explorers/bo.py, a redesign of
reference baselines/explorers/bo.py:18-257) with the fused model.  Every
round Thompson-seeds `num_chains` mutation chains from the previous
measured batch (exp(10 * fitness) weights, reference bo.py:190-197), then
walks them in lockstep for T = ceil(sequences_batch_size / num_chains)
steps.  Each step screens M = budget // (chains * T) sparse multi-site
mutants per chain (each position flips with probability 1/L to another
letter, at least one flip; reference bo.py:135-155, :171-181) in one batch
and moves each chain to its acquisition argmax.  The visited states form
the round's pool, deduplicated within the round (the reference's
`samples` dict), and the round proposes its top `sequences_batch_size`
by model score.

Model modes (as in the JAX runner):
  * NAM and perfect: one member, so EI (reference bo.py:125-127) and UCB
    (:129-133) both rank by the prediction.  Every screened candidate
    costs one model query; a candidate repeated within a screen resolves
    to its first occurrence (one draw, one cache row).  The measured
    truth goes into the cache (NAM training) at the proposal's row.
  * A trained ensemble: EI = mean over members of max(v_k - best, 0), UCB
    = mean - 0.01 * std (the reference's minus sign), `best` the running
    maximum of the chosen mean predictions (bo.py:182-185); the exact GP
    (arch "gp") uses the Gaussian closed forms of the same two.

Chains, steps and candidates are fixed by the configuration, so every
cell runs the same T steps a round: no cell is ever idle.  Cells,
generators, the NAM cache and the proposal step are `jit_runner.CellRun`'s.
"""
import math
from typing import Callable, Optional, Sequence

import torch

from flexs_tpu_torch.ops import packed_hamming
from flexs_tpu_torch.runtime import surrogate as surrogate_lib
from flexs_tpu_torch.runtime.ga_runner import gumbel_argmax
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

METHODS = ("EI", "UCB")


def member_stats(members: torch.Tensor):
    """(mean, population std) over the member axis of f32[C, M, n], member by member.

    Elementwise sums in member order, so that a cell's numbers do not
    depend on how many cells share the tensor.
    """
    m = members.shape[1]
    mean = sum(members[:, k] for k in range(m)) / m
    var = sum(torch.square(members[:, k] - mean) for k in range(m)) / m
    return mean, torch.sqrt(var)


def gaussian_ei(mu, sigma, best):
    """E[max(f - best, 0)] under N(mu, sigma^2); max(mu - best, 0) where sigma is 0."""
    safe = sigma.clamp(min=1e-12)
    z = (mu - best) / safe
    pdf = torch.exp(-0.5 * z * z) / math.sqrt(2 * math.pi)
    ei = safe * (pdf + z * torch.special.ndtr(z))
    return torch.where(sigma > 1e-12, ei, (mu - best).clamp(min=0.0))


class _BORun(CellRun):
    """Evo-BO's rounds of C cells in lockstep."""

    def __init__(self, fitness_fn, fitness_params, start_tokens, cfg, ss, gens,
                 num_chains: int, method: str):
        if method not in METHODS:
            raise ValueError(f"method must be 'EI' or 'UCB', got {method!r}")
        B = cfg.sequences_batch_size
        self.K = K = min(num_chains, B)
        self.T = T = max(1, -(-B // K))  # ceil(B / K) lockstep steps a round
        self.M = M = max(1, cfg.model_queries_per_batch // (K * T))  # candidates a chain
        super().__init__(fitness_fn, fitness_params, start_tokens, cfg, ss, gens,
                         cache_rows=cfg.rounds * K * T * M)
        self.method = method
        self.gen_cap = K * T + 1
        C, L, dev = self.C, self.L, self.dev
        # Round 1 seeds its chains from the start alone.
        self.prev_tokens = torch.zeros((C, B, L), dtype=torch.long, device=dev)
        self.prev_tokens[:, 0] = self.start
        self.prev_truth = torch.full((C, B), -torch.inf, device=dev)
        self.prev_truth[:, 0] = self.start_truth
        self.prev_valid = torch.zeros((C, B), dtype=torch.bool, device=dev)
        self.prev_valid[:, 0] = True
        self.best_fit = torch.zeros(C, device=dev)  # reference initialize_data_structures

    def screen(self, flat):
        """(acquisition, mean prediction, cache row) f32/int64[C, K * M] of the candidates."""
        spec, A = self.cfg.surrogate, self.cfg.alphabet_size
        C, n = flat.shape[:2]
        if spec is None:
            # First occurrence of each distinct candidate in the screen.
            pk = self.pack(flat)
            eq = (pk.unsqueeze(2) == pk.unsqueeze(1)).all(dim=-1)
            idx = torch.arange(n, device=self.dev)
            first_idx = torch.where(eq, idx, n).amin(dim=2)
            values, pos = self.nam_query(flat, first_idx == idx, [True] * C,
                                         charge=torch.ones_like(eq[:, 0]))
            vals = values.gather(1, first_idx)
            # One member: EI and UCB both rank by the prediction.
            return vals, vals, pos.gather(1, first_idx)
        best = self.best_fit[:, None]
        if spec.arch == "gp":
            vals, sig = surrogate_lib.posterior(spec, A, self.surr, flat)
            acq = vals - 0.01 * sig if self.method == "UCB" else gaussian_ei(vals, sig, best)
        else:
            members = surrogate_lib.predict_members(spec, A, self.surr, flat)
            vals, std = member_stats(members)
            if self.method == "UCB":
                acq = vals - 0.01 * std
            else:
                acq = member_stats((members - best[:, None]).clamp(min=0.0))[0]
        # A surrogate has no cache: the model is charged the screen, and
        # positions park at the trash row.
        for c in range(C):
            self.model_cost[c] += n
        self.model_cost_t += n
        trash = torch.full((C, n), self.cache_vals.shape[1] - 1, dtype=torch.long,
                           device=self.dev)
        return acq, vals, trash

    def round(self):
        cfg, dev, cells = self.cfg, self.dev, self.cells
        C, L, A, K, M = self.C, self.L, cfg.alphabet_size, self.K, self.M
        every = [True] * C
        self.train_surrogate()

        # Thompson-sample the chain seeds from the previous measured batch.
        logits = torch.where(self.prev_valid, 10.0 * self.prev_truth, -torch.inf)
        seed_idx = gumbel_argmax(logits, K, self.live_gens(every, draws=1), dev)
        states = self.prev_tokens[cells, seed_idx]  # [C, K, L]

        gen_tokens = torch.zeros((C, self.gen_cap, L), dtype=torch.long, device=dev)
        gen_pk = torch.zeros((C, self.gen_cap, self.words), dtype=torch.long,
                             device=dev)
        gen_preds = torch.full((C, self.gen_cap), -torch.inf, device=dev)
        gen_cache_pos = torch.full((C, self.gen_cap), self.cache_vals.shape[1] - 1,
                                   dtype=torch.long, device=dev)
        n_gen = torch.zeros(C, dtype=torch.long, device=dev)
        slots = torch.arange(self.gen_cap, device=dev)
        chain_base = torch.arange(K, device=dev) * M

        for _ in range(self.T):
            gens = self.live_gens(every, draws=3)
            flip_u, offsets = self.draw_buffers(gens, (C, K, M, L), torch.float32, torch.long)
            (forced_pos,) = self.draw_buffers(gens, (C, K, M), torch.long)
            for c, g in gens:
                flip_u[c].uniform_(0, 1, generator=g)
                forced_pos[c].random_(0, L, generator=g)
                offsets[c].random_(1, A, generator=g)
            # Sparse multi-site mutants: each position flips w.p. 1/L to a
            # different letter; an empty action gets one forced flip.
            flip = flip_u < 1.0 / L
            forced = torch.nn.functional.one_hot(forced_pos, L).bool()
            flip = torch.where(flip.any(dim=-1, keepdim=True), flip, forced)
            cur = states[:, :, None, :].expand(C, K, M, L)
            flat = torch.where(flip, (cur + offsets) % A, cur).reshape(C, K * M, L)

            acq, vals, pos = self.screen(flat)
            take = chain_base + acq.reshape(C, K, M).argmax(dim=2)  # [C, K]
            chosen = flat[cells, take]
            chosen_vals, chosen_pos = vals.gather(1, take), pos.gather(1, take)
            self.best_fit = torch.maximum(self.best_fit, chosen_vals.amax(dim=1))

            # Visited states join the pool, deduplicated within the round.
            chosen_pk = self.pack(chosen)
            vs_gen = packed_hamming.packed_hamming_matrix(
                chosen_pk, gen_pk, self.bits, self.per_word
            )
            in_gen = ((vs_gen == 0) & (slots < n_gen[:, None])[:, None, :]).any(dim=2)
            keep = ~in_gen & first_occurrence(chosen_pk, torch.ones_like(in_gen))
            _masked_append(
                gen_tokens, chosen, n_gen, keep,
                aux_bufs=(gen_pk, gen_preds, gen_cache_pos),
                aux_rows=(chosen_pk, chosen_vals, chosen_pos),
            )
            n_gen += keep.sum(dim=1)
            states = chosen

        proposals, top_vals, top_idx, valid = self.top_b(gen_tokens, gen_preds, n_gen)
        out = self.measure(proposals, top_vals, valid, slots=gen_cache_pos[cells, top_idx],
                           truth_to_cache=True)
        self.prev_tokens, self.prev_truth, self.prev_valid = proposals, out[2], valid
        return out


def run_bo_nam_cells(
    fitness_fn: Callable,
    fitness_params,
    start_tokens: torch.Tensor,
    cfg: AdaleadConfig,
    signal_strengths,
    generators: Sequence[torch.Generator],
    num_chains: int = 10,
    method: str = "EI",
) -> RunResult:
    """Run C Evo-BO experiments in lockstep.

    The arguments are `run_adalead_nam_cells`' plus the explorer's chain
    count and acquisition ("EI" or "UCB").  Returns a `RunResult` with a
    leading cell axis.
    """
    return run_cells(_BORun(fitness_fn, fitness_params, start_tokens, cfg, signal_strengths,
                            list(generators), num_chains, method))


def run_bo_nam(fitness_fn: Callable, fitness_params, start_tokens: torch.Tensor,
               cfg: AdaleadConfig, signal_strength: float, generator: torch.Generator,
               num_chains: int = 10, method: str = "EI") -> RunResult:
    """One Evo-BO experiment (`run_bo_nam_cells` at C = 1)."""
    return one_cell(run_bo_nam_cells, fitness_fn, fitness_params, start_tokens, cfg,
                    signal_strength, generator, num_chains=num_chains, method=method)


class DeviceBONAM(DeviceRunner):
    """(df, metadata) wrapper over `run_bo_nam`."""

    label = "device BO"
    single_run = staticmethod(run_bo_nam)

    def __init__(
        self,
        landscape,
        alphabet,
        rounds: int,
        sequences_batch_size: int,
        model_queries_per_batch: int,
        starting_sequence: str,
        num_chains: int = 10,
        method: str = "EI",
        signal_strength: float = 0.9,
        model: str = "nam",
        surrogate_spec: Optional[surrogate_lib.SurrogateSpec] = None,
        seed: int = 0,
        log_file: Optional[str] = None,
        device=None,
    ):
        """The fused Evo-BO runner for `landscape` on `device` (default "cuda").

        `model` is "nam", "perfect" or "surrogate" (`DeviceRunner`; the
        default surrogate is a 3-CNN ensemble, so that EI and UCB see a
        member spread).
        """
        if method not in METHODS:
            # Evo-BO has the reference's two acquisitions (bo.py:125-133);
            # Thompson and Greedy belong to GPR_BO.
            raise ValueError(f"method must be 'EI' or 'UCB', got {method!r}")
        super().__init__(
            landscape, alphabet, rounds, sequences_batch_size, model_queries_per_batch,
            starting_sequence, signal_strength, seed, model, surrogate_spec, log_file, device,
            default_spec=surrogate_lib.SurrogateSpec(ensemble_size=3),
        )
        self.run_kwargs = dict(num_chains=num_chains, method=method)
        self.name = f"DeviceBO_method={method}"
