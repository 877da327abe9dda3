"""Trained surrogates carried inside the fused runner: retrained every round.

The reference's headline empirical experiments train a Keras CNN (or an
ensemble of them) on all measured data every round and let the explorer
query it (reference baselines/models/cnn.py:23-67, keras_model.py:49-79;
experiments at paper_code/cloud/runs/rosetta_cnn/).  This is the port of
the JAX package's `runtime/surrogate.py`: the nets' weights and Adam state
stay on the run's device between rounds, each round's fit is a loop over
shuffled fixed-shape minibatches of the measured buffer, and scoring a
batch of candidates is one forward pass.

Semantics kept from the JAX package (and, through it, the Keras fit):
  * the nets of `baselines.models` (CNN, MLP, global epistasis) or a
    one-hot linear model, Adam(1e-3), MSE, 20 epochs at batch 256, warm
    started every round, dropout on in training;
  * the measured set is a fixed-capacity buffer, so every epoch is a
    fixed grid of ceil(capacity / batch) minibatches over the buffer
    padded with zero-weight rows (all-zero one-hot rows); a minibatch
    whose rows are all padding is a true no-op (weights, Adam moments and
    step count are kept);
  * ensembles combine members by weight (uniform: the plain Ensemble mean;
    `adaptive`: holdout r^2 weights, reference adaptive_ensemble.py);
  * arch "linear" is fitted in closed form (weighted minimum-norm OLS);
  * arch "gp" is the exact GP posterior (`baselines/models/torch_gp.py`),
    refitted every round on the buffer's live rows, each sequence's first
    occurrence only (a duplicate row makes the kernel matrix exactly
    singular); one member, no Adam state.

State layout: every net (a cell's ensemble member) is one row of a flat
weight tensor, and a state may hold the nets of C cells at once (net
n = cell n // M, member n % M), so the members of an ensemble, and the
cells of a lockstep sweep chunk, train and predict as one batch, where the
JAX package uses `vmap`.  Randomness comes from one `torch.Generator` per
cell, drawn in a fixed order: init; then each `train` call's holdout split
(adaptive only), per epoch a permutation per member, per minibatch the
dropout masks.  A cell draws the same whatever the number of cells.  The
GP draws nothing, and fits and predicts cell by cell with the
single-matrix factorization and solves, so that a cell's numbers do not
depend on which batched routine a library picks for C matrices.
"""
import functools
from typing import NamedTuple, Sequence, Union

import torch
from torch import nn

from flexs_tpu_torch.baselines.models.cnn import CNNModule
from flexs_tpu_torch.baselines.models.global_epistasis_model import GlobalEpistasisModule
from flexs_tpu_torch.baselines.models.mlp import MLPModule
from flexs_tpu_torch.baselines.models.torch_gp import GPFit, GPState, gp_fit, gp_posterior, hamming
from flexs_tpu_torch.baselines.models.torch_linear import ridge_coef
from flexs_tpu_torch.baselines.models.torch_model import (
    AdamState,
    Dense,
    adam_init,
    fit,
    forward_flat,
    init_flat,
    one_hot,
)

ARCHS = ("cnn", "mlp", "gem", "linear", "gp")


class LinearModule(nn.Module):
    """Flattened one-hot -> Dense(1): the sklearn LinearRegression shape.

    Only its predict path is a net; `train` fits it in closed form.
    """

    def __init__(self, seq_len: int, alphabet_size: int, device=None):
        super().__init__()
        self.Dense_0 = Dense(seq_len * alphabet_size, 1, device=device)

    def forward(self, x: torch.Tensor, dropout_mask=None):
        return self.Dense_0(x.reshape(x.shape[0], x.shape[1], -1))[..., 0]


class SurrogateSpec(NamedTuple):
    """Surrogate configuration (the JAX package's fields and defaults).

    Defaults mirror the reference paper runs: CNN with 32 filters and hidden
    size 100 (metadata `CNN_hidden_size_100_num_filters_32`), Keras fit
    defaults of 20 epochs at batch 256 with Adam(1e-3).
    """

    arch: str = "cnn"  # "cnn" | "mlp" | "gem" | "linear" | "gp"
    ensemble_size: int = 1
    num_filters: int = 32
    hidden_size: int = 100
    kernel_size: int = 5
    epochs: int = 20
    batch_size: int = 256
    learning_rate: float = 1e-3
    # arch="gp" only: LML Adam steps per round.
    gp_opt_steps: int = 150
    # Adaptive r^2 reweighting (reference adaptive_ensemble.py:71-96): with
    # >= 10 live rows, members train on a random (1 - val) split and the
    # combine weights become normalized holdout Pearson r^2; with fewer
    # rows, members train on everything and the weights are kept.
    adaptive: bool = False
    adaptive_val_size: float = 0.2

    @property
    def model_name(self) -> str:
        """Reference-format model metadata name (cnn.py:67, ensemble.py:36,
        adaptive_ensemble.py:55)."""
        if self.arch == "cnn":
            base = f"CNN_hidden_size_{self.hidden_size}_num_filters_{self.num_filters}"
        elif self.arch == "linear":
            base = "linear_regression"  # sklearn_models.py:67-74
        elif self.arch == "gp":
            base = "gaussian_process"
        else:
            # MLP and GlobalEpistasis both default to this string in the
            # reference (mlp.py:43, global_epistasis_model.py:41).
            base = f"MLP_hidden_size_{self.hidden_size}"
        if self.ensemble_size == 1 and not self.adaptive:
            return base
        members = "|".join([base] * self.ensemble_size)
        if self.adaptive:
            return f"AdaptiveEns({members})"
        return f"Ens({members})"


class SurrogateState(NamedTuple):
    """Surrogate state of C cells of M members each, on the run's device."""

    # Weights and Adam state, C * M rows (net n = cell n // M); for arch
    # "gp", the cells' exact posteriors (a leading cell axis on every field).
    nets: Union[AdamState, GPState]
    weight: torch.Tensor  # f32[C, M]: combine weight per member (sums to 1)


def check_spec(spec: SurrogateSpec) -> None:
    """Raise for an arch the port does not have."""
    if spec.arch not in ARCHS:
        raise ValueError(f"unknown surrogate arch {spec.arch!r}")


@functools.lru_cache(maxsize=64)
def module(spec: SurrogateSpec, alphabet_size: int, length: int) -> nn.Module:
    """The arch's layer definition (on the meta device; weights live in the state)."""
    check_spec(spec)
    if spec.arch == "cnn":
        return CNNModule(spec.num_filters, spec.hidden_size, alphabet_size, spec.kernel_size,
                         device="meta")
    if spec.arch == "mlp":
        return MLPModule(spec.hidden_size, length, alphabet_size, device="meta")
    if spec.arch == "gem":
        return GlobalEpistasisModule(spec.hidden_size, length, alphabet_size, device="meta")
    return LinearModule(length, alphabet_size, device="meta")


Generators = Union[torch.Generator, Sequence[torch.Generator]]


def _gens(generators: Generators):
    return [generators] if isinstance(generators, torch.Generator) else list(generators)


def init_state(spec: SurrogateSpec, alphabet_size: int, length: int, generators: Generators,
               capacity: int = 0) -> SurrogateState:
    """Fresh state of `spec.ensemble_size` members per generator (one per cell).

    Each cell's members are drawn from its generator, on its device.
    `capacity` (the measured buffer's rows) is required for arch "gp",
    whose state (training rows, dual coefficients, Cholesky factor) is
    shaped by it; other archs ignore it.
    """
    check_spec(spec)
    gens = _gens(generators)
    if spec.arch == "gp":
        if capacity < 1:
            raise ValueError('arch="gp" needs init_state(..., capacity=<measured-buffer '
                             "capacity>): its posterior state is shaped by it")
        if spec.ensemble_size != 1 or spec.adaptive:
            raise ValueError('arch="gp" is an exact posterior: ensemble_size must be 1 and '
                             "adaptive False (ensembling a deterministic GP is a no-op)")
        dev, cells = gens[0].device, len(gens)
        return SurrogateState(
            GPState(
                torch.zeros((cells, capacity, length), dtype=torch.long, device=dev),
                torch.zeros((cells, capacity), dtype=torch.bool, device=dev),
                GPFit(torch.zeros((cells, 2), device=dev), torch.zeros((cells, capacity), device=dev),
                      torch.eye(capacity, device=dev).repeat(cells, 1, 1)),
            ),
            torch.ones((cells, 1), device=dev),
        )
    net = module(spec, alphabet_size, length)
    members = spec.ensemble_size
    params = torch.cat([init_flat(net, members, g) for g in gens])
    weight = torch.full((len(gens), members), 1.0 / members, device=params.device)
    return SurrogateState(adam_init(params), weight)


def _cell_axis(tokens: torch.Tensor, *rest):
    """(True, tensors) given a cell axis, else (False, tensors with one added)."""
    if tokens.dim() == 3:
        return True, (tokens,) + rest
    return False, (tokens[None],) + tuple(torch.as_tensor(r)[None] for r in rest)


def train(spec: SurrogateSpec, alphabet_size: int, state: SurrogateState, tokens, truth,
          n_rows, generators: Generators) -> SurrogateState:
    """One full warm-started fit on the live rows of each cell's measured buffer.

    Args:
        tokens: int[C, cap, L] measured-sequence buffers of fixed capacity
            ([cap, L] for one cell).
        truth: f32[C, cap] true scores, -inf on unfilled rows.
        n_rows: int[C] live row counts (a device tensor needs no sync).
        generators: One generator per cell.
    """
    check_spec(spec)
    _, (tokens, truth, n_rows) = _cell_axis(torch.as_tensor(tokens), truth, n_rows)
    gens = _gens(generators)
    dev = truth.device
    cells, cap = truth.shape
    n_rows = torch.as_tensor(n_rows, device=dev)
    if spec.arch == "gp":
        return state._replace(nets=_gp_train(spec, alphabet_size, tokens, truth, n_rows))
    bs = min(spec.batch_size, cap)
    padded = -(-cap // bs) * bs

    live = (torch.arange(cap, device=dev) < n_rows[:, None]) & torch.isfinite(truth)
    w_all = live.float()
    y = torch.where(torch.isfinite(truth), truth, 0.0)
    if spec.adaptive:
        # Random holdout split (reference adaptive_ensemble.py:86-95; a
        # Bernoulli(val_size) per live row).  With < 10 live rows members
        # train on everything and the weights are kept (:82-85).
        u = torch.stack([torch.empty(cap, device=dev).uniform_(generator=g) for g in gens])
        val_mask = w_all * (u < spec.adaptive_val_size).float()
        use_split = w_all.sum(dim=1) >= 10
        w = torch.where(use_split[:, None], w_all - val_mask, w_all)
    else:
        w = w_all

    def pad(a):
        return nn.functional.pad(a, (0, 0) * (a.dim() - 2) + (0, padded - cap))

    x, y, w = pad(one_hot(tokens, alphabet_size)), pad(y), pad(w)
    net = module(spec, alphabet_size, tokens.shape[2])
    if spec.arch == "linear":
        nets = state.nets._replace(params=_closed_form_ols(x, y, w, spec.ensemble_size))
    else:
        nets, _ = fit(net, state.nets, x, y, w, gens, spec.epochs, bs, spec.learning_rate,
                      skip_empty=True)
    weight = state.weight
    if spec.adaptive:
        weight = _r2_weights(net, nets.params, x, y, pad(val_mask), use_split, weight)
    return SurrogateState(nets, weight)


def _closed_form_ols(x, y, w, members: int) -> torch.Tensor:
    """Weighted minimum-norm OLS weights f32[C * members, L * A + 1], per cell.

    `torch_linear.ridge_coef` at lambda 0: sklearn LinearRegression's
    fitted values.  Members are deterministic and identical.  Cells are
    solved one by one, so that a cell's fit is the same whatever the
    number of cells.
    """
    coefs = [ridge_coef(xc.reshape(len(wc), -1), yc, wc) for xc, yc, wc in zip(x, y, w)]
    return torch.stack(coefs).repeat_interleave(members, dim=0)


def _gp_train(spec, alphabet_size, tokens, truth, n_rows) -> GPState:
    """Each cell's exact GP refitted on its live rows, first occurrences only."""
    cap = truth.shape[1]
    rows = torch.arange(cap, device=truth.device)
    earlier = rows[None, :] < rows[:, None]
    fits, valids = [], []
    for c in range(len(truth)):
        valid = (rows < n_rows[c]) & torch.isfinite(truth[c])
        # A duplicate row makes the kernel matrix exactly singular (the f32
        # factorization fails and every later round is NaN): keep only each
        # sequence's first live occurrence.
        same = hamming(tokens[c], tokens[c], alphabet_size) == 0
        valid = valid & ~(same & earlier & valid[None, :]).any(dim=1)
        fits.append(gp_fit(tokens[c], truth[c], valid, alphabet_size, spec.gp_opt_steps))
        valids.append(valid)
    return GPState(tokens, torch.stack(valids), GPFit(*map(torch.stack, zip(*fits))))


def _gp_posterior(state: SurrogateState, tokens, alphabet_size: int, with_std: bool):
    """Per-cell exact posterior (mean, std or None) f32[C, B] of tokens int[C, B, L]."""
    gp = state.nets
    out = []
    for c in range(len(tokens)):
        fit = GPFit(*(t[c] for t in gp.fit))
        out.append(gp_posterior(tokens[c], gp.train_tokens[c], fit, gp.valid[c],
                                alphabet_size, with_std))
    mu = torch.stack([m for m, _ in out])
    return mu, torch.stack([s for _, s in out]) if with_std else None


def _r2_weights(net, params, x, y, vm, use_split, weight):
    """Holdout Pearson r^2 per member, normalized to combine weights f32[C, M].

    Reference adaptive_ensemble.py:12-26,96.  Where the split was not used,
    or every member's r^2 is 0 (a constant holdout), the previous weights
    stay: all-zero weights would zero the combined prediction.
    """
    cells, members = weight.shape
    with torch.no_grad():
        p = forward_flat(net, params, x.repeat_interleave(members, dim=0))
    p = p.view(cells, members, -1)
    nv = vm.sum(dim=1).clamp(min=1.0)
    ym = (y * vm).sum(dim=1) / nv
    pm = (p * vm[:, None]).sum(dim=2) / nv[:, None]
    dp, dy = p - pm[..., None], (y - ym[:, None])[:, None]
    cov = (dp * dy * vm[:, None]).sum(dim=2)
    var = (torch.square(dp) * vm[:, None]).sum(dim=2) * (torch.square(dy) * vm[:, None]).sum(dim=2)
    r = cov / torch.sqrt(var + 1e-12)
    r2 = torch.nan_to_num(r * r)
    total = r2.sum(dim=1, keepdim=True)
    wts = r2 / total.clamp(min=1e-9)
    return torch.where(use_split[:, None] & (total > 0), wts, weight)


@torch.no_grad()
def predict_members(spec: SurrogateSpec, alphabet_size: int, state: SurrogateState,
                    tokens) -> torch.Tensor:
    """Per-member predictions f32[C, M, B] of int[C, B, L] tokens ([M, B] for [B, L]).

    Mirrors `KerasModel._fitness_function` (predict + nan_to_num,
    keras_model.py:69-79) for each member; for arch "gp", the posterior
    mean, NaN where the fit's factorization failed (as in the JAX package).
    """
    cell_axis, (tokens,) = _cell_axis(torch.as_tensor(tokens))
    cells, members = state.weight.shape
    if spec.arch == "gp":
        out = _gp_posterior(state, tokens, alphabet_size, with_std=False)[0][:, None]
        return out if cell_axis else out[0]
    x = one_hot(tokens, alphabet_size)
    if members > 1:
        x = x.repeat_interleave(members, dim=0)
    out = forward_flat(module(spec, alphabet_size, tokens.shape[2]), state.nets.params, x)
    out = torch.nan_to_num(out).view(cells, members, -1)
    return out if cell_axis else out[0]


def _combine(members: torch.Tensor, state: SurrogateState) -> torch.Tensor:
    """Members [C, M, B] (or [M, B]) summed with the state's combine weights."""
    weight = state.weight if members.dim() == 3 else state.weight[0]
    return (members * weight[..., None]).sum(dim=-2)


def predict(spec: SurrogateSpec, alphabet_size: int, state: SurrogateState,
            tokens) -> torch.Tensor:
    """Weight-combined prediction f32[C, B] of int[C, B, L] tokens ([B] for [B, L]).

    Uniform weights give the plain Ensemble mean (reference
    ensemble.py:24,54-59); adaptive specs use the holdout-r^2 weights
    (adaptive_ensemble.py:97-102).
    """
    return _combine(predict_members(spec, alphabet_size, state, tokens), state)


def posterior(spec: SurrogateSpec, alphabet_size: int, state: SurrogateState, tokens):
    """(mean, std) over members, each f32[C, B] ([B] for [B, L] tokens).

    The exact posterior for arch "gp"; otherwise the combined mean and the
    members' population std (the reference's sigma proxy, bo.py:318-319;
    0 for one member).
    """
    if spec.arch == "gp":
        cell_axis, (tokens,) = _cell_axis(torch.as_tensor(tokens))
        mu, std = _gp_posterior(state, tokens, alphabet_size, with_std=True)
        return (mu, std) if cell_axis else (mu[0], std[0])
    members = predict_members(spec, alphabet_size, state, tokens)
    return _combine(members, state), members.std(dim=-2, unbiased=False)
