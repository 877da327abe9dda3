"""CbAS/DbAS + NoisyAbstractModel runs with every round's work on the device.

The port of the JAX package's `runtime/cbas_runner.py`, which fuses the
host explorer (baselines/explorers/cbas_dbas.py, cited against the
reference there): elite selection, pool extension, every weighted-MLE VAE
training burst with keras-style early stopping, Boltzmann PWM sampling at
escalating temperature, model scoring and the CbAS importance reweighting.

Semantics per round (reference cbas_dbas.py:85-192):
  * round 1: `sequences_batch_size` novel rate-2/L mutants of the start;
  * later rounds: elite = last round's proposals >= the Q-quantile of
    their true scores, padded to >= 100 with novel rate-`mutation_rate`
    mutants of random pool rows; then `cycles + 1` iterations, cycles =
    ceil(budget / cycle_batch_size): iteration i trains the VAE on the
    pool (iteration 0's fit is snapshotted as vae_0), then, for i <
    cycles, decodes one latent draw into a PWM, samples
    `cycle_batch_size` novel sequences from it (novel against the pool
    and the cycle's earlier samples, at most 200 tries, the temperature
    0.001 * 1.3^rejections), scores them, ratchets gamma to max(the
    Q-percentile of the scores, gamma), weights them by
    exp(logp_vae0 - logp_vae) (CbAS) or 1 (DbAS), zeroes weights below
    gamma and appends them to the pool; the last iteration only trains;
  * the round proposes the top `sequences_batch_size` generated sequences
    by model score.

VAE training (the JAX runner's, reference VAE_utils.py:132-151): the
trailing `validation_split` of the pool is held out; each epoch orders the
positive-weight rows first (random among themselves) and steps over only
the ceil(n_pos / batch_size) minibatches that hold them; early stopping
on the epoch's mean loss with patience 3; `clip(0.5)` then Adam(1e-4)
(`utils.vae.VAETrainer`, one per cell).  The log probability decodes the
deterministic z_mean (`utils.vae`).  Documented deviations of the JAX
runner kept here: the temperature's rejection count updates once per
sampled batch, and the round proposes exactly `sequences_batch_size`.

Each cell has its own VAE and Adam state, drawn from and trained by its
own generator (initialization, epoch orders, dropout, latent noise, the
z draw and the Gumbel-max categorical draws).  Training runs cell by
cell, each for its own epochs and live minibatches, so a cell that has
stopped (or has nothing to train) leaves its weights, BatchNorm
statistics and Adam state, its step count included, as they are.  On the
card each training step replays one CUDA graph (`cuda_graph=False` runs
the same step eagerly).  Sampling, scoring and the pool updates run on the
cell axis; cells, generators, the NAM cache and the proposal step are
`jit_runner.CellRun`'s.
"""
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

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
    run_counts,
)
from flexs_tpu_torch.utils.profiling import span
from flexs_tpu_torch.utils.vae import DROPOUT_KEEP, VAETrainer

MAX_SAMPLE_TRIES = 200  # PWM batches a cycle (reference VAE_utils.py:170)
MAX_MUTANT_TRIES = 64


class VAEConfig(NamedTuple):
    """VAE hyperparameters of a run."""

    latent_dim: int = 2
    intermediate_dim: int = 250
    batch_size: int = 10
    epochs: int = 10
    beta: float = 1.0
    validation_split: float = 0.2


def _masked_percentile(vals, mask, q: float):
    """`np.percentile(vals[mask], 100 * q)` (linear interpolation) along the last axis."""
    v = torch.sort(torch.where(mask, vals, 1e30), dim=-1).values
    n = mask.sum(dim=-1)
    pos = q * (n - 1).clamp(min=0).float()
    lo, hi = torch.floor(pos).long(), torch.ceil(pos).long()
    frac = pos - lo.float()
    low = v.gather(-1, lo[..., None])[..., 0]
    high = v.gather(-1, hi[..., None])[..., 0]
    return low * (1 - frac) + high * frac


@torch.no_grad()
def log_probability(trainer: VAETrainer, x, length: int, alphabet_size: int, weights=None):
    """Reconstruction log probability f32[n] of one-hot rows x f32[n, L * A].

    Under `weights` (a `get_weights` snapshot, the CbAS vae_0) or the
    trainer's current weights; reference VAE_utils.py:189-217 on the
    deterministic z_mean.
    """
    module = trainer.module
    decoded = module(x) if weights is None else torch.func.functional_call(module, weights, (x,))
    decoded = decoded.reshape(-1, length, alphabet_size)
    one_hot = x.reshape(-1, length, alphabet_size)
    per_res = (decoded * one_hot).sum(dim=2) / decoded.sum(dim=2)
    return torch.nan_to_num(torch.log(1e-9 + per_res).sum(dim=1))


class _CbASRun(CellRun):
    """CbAS/DbAS rounds of C cells in lockstep, one VAE per cell."""

    def __init__(self, fitness_fn, fitness_params, start_tokens, cfg, ss, gens,
                 vae_cfg: VAEConfig, algo: str, Q: float, cycle_batch_size: int,
                 mutation_rate: float, cuda_graph: bool):
        if algo not in ("cbas", "dbas"):
            raise ValueError("`algo` must be one of 'cbas' or 'dbas'")
        B, budget = cfg.sequences_batch_size, cfg.model_queries_per_batch
        self.cycles = cycles = -(-budget // cycle_batch_size)
        super().__init__(fitness_fn, fitness_params, start_tokens, cfg, ss, gens,
                         cache_rows=cfg.rounds * (cycles * cycle_batch_size + B) + B)
        bs = vae_cfg.batch_size
        pool_cap = max(100, B) + cycles * cycle_batch_size
        self.pool_cap = -(-pool_cap // bs) * bs  # whole VAE minibatches
        self.gen_cap = cycles * cycle_batch_size + 1
        self.vae_cfg, self.algo, self.Q = vae_cfg, algo, Q
        self.cbs, self.mutation_rate = cycle_batch_size, mutation_rate
        self.dim = self.L * cfg.alphabet_size
        self.trainers = []
        for g in self.gens:
            trainer = VAETrainer(self.dim, vae_cfg.intermediate_dim, vae_cfg.latent_dim, bs,
                                 vae_cfg.beta, g)
            trainer.cuda_graph = trainer.cuda_graph and cuda_graph
            self.trainers.append(trainer)
        self.rounds_done = 0
        self.prev = None

    def one_hot(self, tokens):
        return torch.nn.functional.one_hot(tokens, self.cfg.alphabet_size).float().reshape(
            *tokens.shape[:-1], self.dim
        )

    def novel_to(self, packed, rows_pk, n_rows_t, n_max: int):
        """bool[C, m]: packed rows equal to none of each cell's first n_rows rows."""
        if n_max == 0:
            return torch.ones(packed.shape[:2], dtype=torch.bool, device=self.dev)
        d = packed_hamming.packed_hamming_matrix(
            packed, rows_pk[:, :n_max], self.bits, self.per_word
        )
        filled = torch.arange(n_max, device=self.dev) < n_rows_t[:, None]
        return ~((d == 0) & filled[:, None, :]).any(dim=2)

    def sample_novel(self, buf, buf_pk, n_buf, n_buf_h, need: int, draw: Callable,
                     draws: int, max_tries: int, against=None):
        """Append novel rows of `draw(gens, rejections)` to each cell's `buf` until it holds `need`.

        A candidate equal to a buffer row, to an earlier candidate of the
        batch or (with `against` = (rows_pk, n_rows_t, n_rows_h)) to one of
        those rows is rejected; appends stop at exactly `need` rows (the
        reference breaks its fill loops at the target count).  A cell draws
        (`draws` calls a try) only while it is short.  `n_buf` (device) and
        `n_buf_h` (host) are updated in place; returns each cell's
        rejections int64[C].
        """
        rejections = torch.zeros(self.C, dtype=torch.long, device=self.dev)
        for t in range(max_tries):
            live = [n < need for n in n_buf_h]
            if not any(live):
                break
            short = (n_buf < need)[:, None]
            cand = draw(self.live_gens(live, draws=draws), rejections)
            cand_pk = self.pack(cand)
            novel = self.novel_to(cand_pk, buf_pk, n_buf, max(n_buf_h))
            if against is not None:
                novel = novel & self.novel_to(cand_pk, against[0], against[1], max(against[2]))
            novel = novel & first_occurrence(cand_pk, novel) & short
            accept = novel & (torch.cumsum(novel.long(), dim=1) <= need - n_buf[:, None])
            _masked_append(buf, cand, n_buf, accept, aux_bufs=(buf_pk,), aux_rows=(cand_pk,))
            counts = torch.stack([accept.sum(dim=1), (~novel & short).sum(dim=1)])
            n_buf += counts[0]
            # Each non-novel draw is one rejection (reference
            # VAE_utils.py:182-185); novel draws over the quota are not.
            rejections += counts[1]
            for c, n in enumerate(self.fetch(counts[0])):
                n_buf_h[c] += n
        return rejections

    def mutant_draw(self, buf, n_buf_h, source, rate: float, count: int):
        """A `sample_novel` draw: rate-`rate` mutants of `count` rows.

        `source` None mutates random rows of the growing buffer itself
        (host parity: the reference mutates random pool members as it
        grows, reference :80-102); else the rows of `source` int64[C, L].
        """
        C, L, A = self.C, self.L, self.cfg.alphabet_size

        def draw(gens, _rejections):
            with span("flexs.draw"):
                (pick,) = self.draw_buffers(gens, (C, count), torch.long)
                u, rand = self.draw_buffers(gens, (C, count, L), torch.float32, torch.long)
                for c, g in gens:
                    if source is None:
                        pick[c].random_(0, max(n_buf_h[c], 1), generator=g)
                    u[c].uniform_(0, 1, generator=g)
                    rand[c].random_(0, A, generator=g)
            toks = (buf[self.cells, pick] if source is None
                    else source[:, None, :].expand(C, count, L))
            return torch.where(u < rate, rand, toks)

        return draw

    def train_vaes(self, pool_tokens, pool_w, n_pool_h):
        """Each cell's VAE fitted on its pool with early stopping (patience 3)."""
        vc, cap, dev = self.vae_cfg, self.pool_cap, self.dev
        bs, inter = vc.batch_size, vc.intermediate_dim
        rows = torch.arange(cap, device=dev)
        n_train = [max(bs, int(np.float32(n) * np.float32(1 - vc.validation_split)))
                   for n in n_pool_h]
        w = pool_w[:, :cap] * (rows < torch.tensor(n_train, device=dev)[:, None])
        n_pos = self.fetch((w > 0).sum(dim=1))
        x = self.one_hot(pool_tokens[:, :cap])
        for c, (trainer, g) in enumerate(zip(self.trainers, self.gens)):
            n_live = max(-(-n_pos[c] // bs), 1)
            best, patience = np.inf, 0
            for _ in range(vc.epochs):
                rand = torch.rand(cap, generator=g, device=dev)
                order = torch.sort(torch.where(w[c] > 0, rand, 2.0), stable=True).indices
                batches = order[: n_live * bs].view(n_live, bs)
                enc_keep = torch.rand((n_live, bs, inter), generator=g, device=dev) < DROPOUT_KEEP
                dec_keep = torch.rand((n_live, bs, inter), generator=g, device=dev) < DROPOUT_KEEP
                eps = torch.randn((n_live, bs, vc.latent_dim), generator=g, device=dev)
                run_counts["draw_calls"] += 4
                loss = self.fetch(
                    trainer.steps(x[c], w[c], batches, enc_keep, dec_keep, eps) / n_live
                )
                if loss < best - 1e-12:
                    best, patience = loss, 0
                else:
                    patience += 1
                    if patience >= 3:
                        break

    def round_zero(self):
        """B novel rate-2/L mutants of the start (reference :91-104), scored."""
        C, L, B = self.C, self.L, self.cfg.sequences_batch_size
        buf = torch.zeros((C, B + 1, L), dtype=torch.long, device=self.dev)
        buf_pk = torch.zeros((C, B + 1, self.words), dtype=torch.long, device=self.dev)
        n_buf = torch.zeros(C, dtype=torch.long, device=self.dev)
        n_buf_h = [0] * C
        draw = self.mutant_draw(buf, n_buf_h, self.start, 2.0 / L, B)
        self.sample_novel(buf, buf_pk, n_buf, n_buf_h, B, draw, 2, MAX_MUTANT_TRIES)
        proposals = buf[:, :B]
        valid = torch.arange(B, device=self.dev) < n_buf[:, None]
        preds, _ = self.nam_query(proposals, valid, [n > 0 for n in n_buf_h])
        return proposals, preds, valid

    def round_cbas(self):
        """Elite pool -> VAE -> generate/score/reweight cycles (reference :106-192)."""
        cfg, dev, cells = self.cfg, self.dev, self.cells
        C, L, A, cbs, cap = self.C, self.L, cfg.alphabet_size, self.cbs, self.pool_cap
        prev_tokens, prev_truth, prev_valid = self.prev

        gamma = _masked_percentile(prev_truth, prev_valid, self.Q)
        elite = prev_valid & (prev_truth >= gamma[:, None])
        pool_tokens = torch.zeros((C, cap + 1, L), dtype=torch.long, device=dev)
        pool_pk = torch.zeros((C, cap + 1, self.words), dtype=torch.long, device=dev)
        pool_w = torch.zeros((C, cap + 1), device=dev)
        n_pool = torch.zeros(C, dtype=torch.long, device=dev)
        _masked_append(
            pool_tokens, prev_tokens, n_pool, elite,
            aux_bufs=(pool_pk, pool_w),
            aux_rows=(self.pack(prev_tokens), torch.ones(elite.shape, device=dev)),
        )
        n_pool += elite.sum(dim=1)
        n_pool_h = self.fetch(n_pool)

        # Pad the pool to >= 100 with novel mutants of random pool rows, at weight 1.
        n_elite = n_pool.clone()
        draw = self.mutant_draw(pool_tokens, n_pool_h, None, self.mutation_rate, 100)
        self.sample_novel(pool_tokens, pool_pk, n_pool, n_pool_h, 100, draw, 3,
                          MAX_MUTANT_TRIES)
        rows = torch.arange(cap + 1, device=dev)
        pool_w = torch.where((rows >= n_elite[:, None]) & (rows < n_pool[:, None]), 1.0, pool_w)

        gen_tokens = torch.zeros((C, self.gen_cap, L), dtype=torch.long, device=dev)
        gen_preds = torch.full((C, self.gen_cap), -torch.inf, device=dev)
        n_gen = torch.zeros(C, dtype=torch.long, device=dev)
        every = [True] * C

        for i in range(self.cycles + 1):
            self.train_vaes(pool_tokens, pool_w, n_pool_h)
            if i == 0 and self.algo == "cbas":
                vae_0 = [t.get_weights() for t in self.trainers]  # reference :125-144
            if i == self.cycles:
                break  # the final refit on the full pool

            # Decode one latent draw per cell into a PWM; Boltzmann-sample
            # novel sequences at escalating temperature (reference
            # :153-187 via utils/vae.py), by Gumbel-max.
            pwm = torch.empty((C, L, A), device=dev)
            with torch.no_grad():
                gens = self.live_gens(every, draws=1)
                with span("flexs.draw"):
                    zs = [(c, torch.randn((1, self.vae_cfg.latent_dim), generator=g, device=dev))
                          for c, g in gens]
                for c, z in zs:
                    pwm[c] = self.trainers[c].module.decode(z)[0].reshape(L, A)

            def draw(gens, rejections):
                temp = 0.001 * torch.pow(1.3, rejections.float())
                logits = pwm / temp.clamp(min=1e-8)[:, None, None]
                with span("flexs.draw"):
                    expo = torch.ones((C, cbs, L, A), device=dev)
                    for c, g in gens:
                        expo[c].exponential_(1.0, generator=g)
                return (logits[:, None] - torch.log(expo)).argmax(dim=3)

            prop = torch.zeros((C, cbs + 1, L), dtype=torch.long, device=dev)
            prop_pk = torch.zeros((C, cbs + 1, self.words), dtype=torch.long, device=dev)
            n_prop = torch.zeros(C, dtype=torch.long, device=dev)
            n_prop_h = [0] * C
            # Novel against the pool (host `existing`) and the cycle's
            # earlier samples (host `seen`).
            self.sample_novel(prop, prop_pk, n_prop, n_prop_h, cbs, draw, 1, MAX_SAMPLE_TRIES,
                              against=(pool_pk, n_pool, n_pool_h))
            proposals = prop[:, :cbs]
            valid = torch.arange(cbs, device=dev) < n_prop[:, None]
            scores, _ = self.nam_query(proposals, valid, [n > 0 for n in n_prop_h])
            gamma = torch.where(
                valid.any(dim=1),
                torch.maximum(_masked_percentile(scores, valid, self.Q), gamma), gamma,
            )

            if self.algo == "cbas":
                x = self.one_hot(proposals)
                logp = torch.stack([
                    log_probability(t, x[c], L, A, vae_0[c]) - log_probability(t, x[c], L, A)
                    for c, t in enumerate(self.trainers)
                ])
                weights = torch.nan_to_num(torch.exp(logp))
            else:
                weights = torch.ones((C, cbs), device=dev)
            weights = torch.where((scores >= gamma[:, None]) & valid, weights, 0.0)

            _masked_append(pool_tokens, proposals, n_pool, valid, aux_bufs=(pool_pk, pool_w),
                           aux_rows=(prop_pk[:, :cbs], weights))
            _masked_append(gen_tokens, proposals, n_gen, valid, aux_bufs=(gen_preds,),
                           aux_rows=(scores,))
            n_pool += n_prop
            n_gen += n_prop
            n_pool_h = [a + b for a, b in zip(n_pool_h, n_prop_h)]

        proposals, top_vals, _, valid = self.top_b(gen_tokens, gen_preds, n_gen)
        return proposals, top_vals, valid

    def round(self):
        self.train_surrogate()
        if self.rounds_done == 0:
            proposals, preds, valid = self.round_zero()
        else:
            proposals, preds, valid = self.round_cbas()
        self.rounds_done += 1
        out = self.measure(proposals, preds, valid)
        self.prev = (proposals, out[2], valid)
        return out


def run_cbas_nam_cells(
    fitness_fn: Callable,
    fitness_params,
    start_tokens: torch.Tensor,
    cfg: AdaleadConfig,
    signal_strengths,
    generators: Sequence[torch.Generator],
    vae_cfg: VAEConfig = VAEConfig(),
    algo: str = "cbas",
    Q: float = 0.7,
    cycle_batch_size: int = 100,
    mutation_rate: float = 0.2,
    cuda_graph: bool = True,
) -> RunResult:
    """Run C CbAS (or DbAS, `algo="dbas"`) experiments in lockstep.

    The arguments are `run_adalead_nam_cells`' plus the explorer's
    hyperparameters (the JAX sweep's defaults); `cuda_graph=False` runs
    the VAE steps eagerly on the card.  Returns a `RunResult` with a
    leading cell axis.
    """
    return run_cells(_CbASRun(
        fitness_fn, fitness_params, start_tokens, cfg, signal_strengths, list(generators),
        vae_cfg, algo, Q, cycle_batch_size, mutation_rate, cuda_graph,
    ))


def run_cbas_nam(fitness_fn: Callable, fitness_params, start_tokens: torch.Tensor,
                 cfg: AdaleadConfig, signal_strength: float, generator: torch.Generator,
                 vae_cfg: VAEConfig = VAEConfig(), algo: str = "cbas", Q: float = 0.7,
                 cycle_batch_size: int = 100, mutation_rate: float = 0.2, *,
                 cuda_graph: bool = True) -> RunResult:
    """One CbAS/DbAS experiment (`run_cbas_nam_cells` at C = 1).

    The hyperparameters follow the JAX function's order, positionally or by
    keyword.
    """
    return one_cell(
        run_cbas_nam_cells, fitness_fn, fitness_params, start_tokens, cfg, signal_strength,
        generator, vae_cfg=vae_cfg, algo=algo, Q=Q, cycle_batch_size=cycle_batch_size,
        mutation_rate=mutation_rate, cuda_graph=cuda_graph,
    )


class DeviceCbASNAM(DeviceRunner):
    """(df, metadata) wrapper over `run_cbas_nam`."""

    label = "device CbAS"
    single_run = staticmethod(run_cbas_nam)

    def __init__(
        self,
        landscape,
        alphabet,
        rounds: int,
        sequences_batch_size: int,
        model_queries_per_batch: int,
        starting_sequence: str,
        algo: str = "cbas",
        Q: float = 0.7,
        cycle_batch_size: int = 100,
        mutation_rate: float = 0.2,
        vae_cfg: Optional[VAEConfig] = None,
        signal_strength: float = 0.9,
        model: str = "nam",
        surrogate_spec: Optional[surrogate_lib.SurrogateSpec] = None,
        seed: int = 0,
        log_file: Optional[str] = None,
        device=None,
    ):
        """The fused CbAS/DbAS runner for `landscape` on `device` (default "cuda").

        `model` is "nam", "perfect" or "surrogate" (`DeviceRunner`; the
        default surrogate is the paper's CNN).
        """
        if algo not in ("cbas", "dbas"):
            raise ValueError("`algo` must be one of 'cbas' or 'dbas'")
        super().__init__(
            landscape, alphabet, rounds, sequences_batch_size, model_queries_per_batch,
            starting_sequence, signal_strength, seed, model, surrogate_spec, log_file, device,
        )
        self.run_kwargs = dict(vae_cfg=vae_cfg or VAEConfig(), algo=algo, Q=Q,
                           cycle_batch_size=cycle_batch_size, mutation_rate=mutation_rate)
        self.name = f"Device{algo}_Q={Q}"
