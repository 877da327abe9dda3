"""TorchModel: the port's counterpart of the JAX package's FlaxModel.

Contract (reference baselines/models/keras_model.py, through the JAX
package's `flax_model.py`):
  * Wraps a net mapping one-hot [batch, L, A] to one score per row; `train`
    one-hot encodes the sequences and fits for `epochs` epochs at
    `batch_size` (keras_model.py:49-67; defaults 256 / 20) with Adam(1e-3)
    on a per-sample loss (MSE by default); `_fitness_function` predicts and
    `nan_to_num`s the output (keras_model.py:69-79).
  * Warm start: each `train` continues from the previous parameters and
    optimizer state (Keras `fit` semantics).
  * The data is padded to `next_bucket(n, minimum=batch_size)` rows,
    rounded up to a multiple of the batch, with zero-weight padding rows;
    each epoch is a fresh permutation of those rows in full minibatches,
    and every minibatch updates the parameters (a minibatch of padding
    rows only has zero gradients, but Adam's momentum still moves them).

The nets (`CNNModule`, `MLPModule`, `GlobalEpistasisModule`) are
`nn.Module`s built from `Dense` and `Conv`, the layers of Flax's
`nn.Dense` / `nn.Conv` with a leading net axis.  A module defines the
layers only: its weights live in one flat f32[nets, P] tensor (the
parameters of every layer in the module's order, each in Flax's layout,
kernel then bias), and `forward_flat` runs the module on views of it with
`torch.func.functional_call`.  So several independent nets (an ensemble,
or the cells of a sweep) run and train as one batch of matrix products,
as the JAX package's `vmap` does, and Adam is a few elementwise ops on
three flat tensors.  The runtime surrogate (`runtime/surrogate.py`) shares
`init_flat`, `forward_flat`, `adam_step` and `fit` with this class.

Numerics: convolutions are matrix products over `Tensor.unfold` windows,
never cuDNN, whose f32 convolutions run in TF32 on Hopper by default; on a
card the products run in full f32 as long as PyTorch's default matmul
precision ("highest") is kept.  Every op used forward and backward is
deterministic on the card, so a seeded run repeats exactly.
"""
import functools
import math
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch import nn

from flexs_tpu_torch.alphabet import as_alphabet
from flexs_tpu_torch.device import resolve_device
from flexs_tpu_torch.model import Model
from flexs_tpu_torch.ops.padding import next_bucket
from flexs_tpu_torch.types import SEQUENCES_TYPE

# Adam as optax.adam(lr) computes it: b1, b2, eps, and eps_root = 0.
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
# decay ** count is read from a table, so that no net's bias correction
# depends on where it sits in a batch of nets; past the table's end both
# powers are 0 in f32.
_POWER_TABLE = 1 << 17
# Flax's truncated normal is cut at +-2 std; this rescales it to unit variance.
_TRUNC_STD = 0.87962566103423978


def mse_loss(preds: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-sample squared error."""
    return torch.square(preds - labels)


def lecun_normal_(tensor: torch.Tensor, fan_in: int, generator=None) -> torch.Tensor:
    """Flax's default kernel init in place: truncated normal, variance 1 / fan_in."""
    std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
    return nn.init.trunc_normal_(tensor, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class Dense(nn.Module):
    """Flax `nn.Dense` with a leading net axis: kernel [nets, in, out], bias [nets, out].

    Its own weights (one net, Flax's init) serve a direct call; built on
    the "meta" device, the module is a layer definition only, for
    `forward_flat`.
    """

    def __init__(self, in_features: int, out_features: int, device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty((1, in_features, out_features), device=device))
        self.bias = nn.Parameter(torch.zeros((1, out_features), device=device))
        lecun_normal_(self.kernel.data, in_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[nets, B, in] -> [nets, B, out].

        A layer with one input or one output is a product or a row sum:
        a matrix product would take another code path for one net than
        for several (a matrix-vector product), and a net's result must not
        depend on how many nets run beside it.
        """
        if self.kernel.shape[1] == 1:
            out = x * self.kernel
        elif self.kernel.shape[2] == 1:
            out = (x * self.kernel[:, :, 0].unsqueeze(1)).sum(dim=-1, keepdim=True)
        else:
            out = torch.matmul(x, self.kernel)
        return out + self.bias.unsqueeze(1)


class Conv(nn.Module):
    """Flax `nn.Conv` over [nets, B, L, in] inputs: kernel [nets, k, in, out].

    A cross-correlation, as Flax's.  "SAME" pads (k - 1) // 2 rows on the
    left and the rest on the right, as XLA does (one more on the right
    for an even k); "VALID" pads nothing.  It runs as one matrix product
    of the [k * in] windows with the kernel.
    """

    def __init__(self, in_features: int, out_features: int, kernel_size: int, padding: str,
                 device=None):
        super().__init__()
        if padding not in ("SAME", "VALID"):
            raise ValueError("padding must be 'SAME' or 'VALID'")
        self.padding = padding
        self.kernel = nn.Parameter(
            torch.empty((1, kernel_size, in_features, out_features), device=device)
        )
        self.bias = nn.Parameter(torch.zeros((1, out_features), device=device))
        lecun_normal_(self.kernel.data, kernel_size * in_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[nets, B, L, in] -> [nets, B, L', out]."""
        nets, k, c_in, c_out = self.kernel.shape
        if self.padding == "SAME":
            low = (k - 1) // 2
            x = nn.functional.pad(x, (0, 0, low, k - 1 - low))
        b, length = x.shape[1], x.shape[2] - k + 1
        windows = x.unfold(2, k, 1).transpose(-1, -2).reshape(nets, b * length, k * c_in)
        out = torch.matmul(windows, self.kernel.reshape(nets, k * c_in, c_out))
        return (out + self.bias.unsqueeze(1)).reshape(nets, b, length, c_out)


@functools.lru_cache(maxsize=64)
def param_layout(module: nn.Module):
    """(names, per-net shapes, per-net sizes) of the module's parameters, in order.

    Cached per module: a training step reads it twice, and walking the
    module's parameters costs more host time than the step's small ops.
    """
    named = list(module.named_parameters())
    return (
        tuple(name for name, _ in named),
        tuple(tuple(p.shape[1:]) for _, p in named),
        tuple(math.prod(p.shape[1:]) for _, p in named),
    )


def one_hot(tokens: torch.Tensor, alphabet_size: int) -> torch.Tensor:
    """f32[..., A] one-hot of int tokens, built without a host sync.

    (`nn.functional.one_hot` checks the tokens' range on the host, which
    waits for the device on every call.)
    """
    classes = torch.arange(alphabet_size, device=tokens.device)
    return (tokens.unsqueeze(-1) == classes).float()


def init_flat(module: nn.Module, nets: int, generator: torch.Generator) -> torch.Tensor:
    """Fresh weights f32[nets, P] on the generator's device, drawn from it.

    Kernels are Flax's default (`lecun_normal`), drawn layer by layer for
    all `nets` at once; biases are zero.
    """
    dev = generator.device
    parts = []
    for name, shape in zip(*param_layout(module)[:2]):
        t = torch.zeros((nets,) + shape, device=dev)
        if name.endswith("kernel"):
            lecun_normal_(t, math.prod(shape[:-1]), generator)
        parts.append(t.reshape(nets, -1))
    return torch.cat(parts, dim=1)


def forward_flat(module: nn.Module, flat: torch.Tensor, x: torch.Tensor,
                 dropout_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scores f32[nets, B] of one-hot x f32[nets, B, L, A] under flat weights [nets, P].

    `dropout_mask` (bool[nets, B, features], True = keep) turns on the
    module's training-time dropout; None is inference.
    """
    names, shapes, sizes = param_layout(module)
    nets = flat.shape[0]
    views = {
        name: part.view((nets,) + shape)
        for name, shape, part in zip(names, shapes, flat.split(sizes, dim=1))
    }
    return torch.func.functional_call(module, views, (x,), {"dropout_mask": dropout_mask})


class AdamState(NamedTuple):
    """Weights and Adam state of a batch of nets (leading net axis on every field)."""

    params: torch.Tensor  # f32[nets, P]
    mu: torch.Tensor  # f32[nets, P]: first moment
    nu: torch.Tensor  # f32[nets, P]: second moment
    count: torch.Tensor  # int64[nets]: steps applied


def adam_init(params: torch.Tensor) -> AdamState:
    return AdamState(
        params, torch.zeros_like(params), torch.zeros_like(params),
        torch.zeros(params.shape[0], dtype=torch.long, device=params.device),
    )


@functools.lru_cache(maxsize=None)
def _decay_powers(decay: float, device: torch.device) -> torch.Tensor:
    """f32 decay ** k for k < _POWER_TABLE, the f32 decay raised in f64 and rounded."""
    base = float(np.float32(decay))
    return torch.as_tensor(
        (base ** np.arange(_POWER_TABLE, dtype=np.float64)).astype(np.float32), device=device
    )


@torch.no_grad()
def adam_step(state: AdamState, grads: torch.Tensor, lr: float,
              keep: Optional[torch.Tensor] = None) -> AdamState:
    """One `optax.adam(lr)` update of every net.

    `keep` (bool[nets]) makes the step a no-op for the nets where it is
    False: their weights, moments and count stay as they were.  The choice
    is a `torch.where` on the device, so it needs no host sync.
    """
    count = state.count + 1
    mu = (1 - ADAM_B1) * grads + ADAM_B1 * state.mu
    nu = (1 - ADAM_B2) * (grads * grads) + ADAM_B2 * state.nu
    t = count.clamp(max=_POWER_TABLE - 1)
    bc1 = (1 - _decay_powers(ADAM_B1, grads.device)[t]).unsqueeze(1)
    bc2 = (1 - _decay_powers(ADAM_B2, grads.device)[t]).unsqueeze(1)
    update = (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS) * -lr
    new = AdamState(state.params + update, mu, nu, count)
    if keep is None:
        return new
    return AdamState(*(
        torch.where(keep.view((-1,) + (1,) * (a.dim() - 1)), a, b) for a, b in zip(new, state)
    ))


@torch.no_grad()
def adam_step_(state: AdamState, grads: torch.Tensor, lr: float) -> None:
    """`adam_step` written into `state`'s own tensors.

    The weights may be the [1, P] view of a module's flat parameters
    (`flatten_parameters`), so the module sees the step at once; every
    tensor keeps its storage, as a CUDA graph replaying the step needs.
    """
    for old, new in zip(state, adam_step(state, grads, lr)):
        old.copy_(new)


# -- Single nets in torch's layout (the explorers' VAE, Q network, actor-critic).


def linear(in_features: int, out_features: int, generator: torch.Generator) -> nn.Linear:
    """An `nn.Linear` (weight [out, in]) with Flax `nn.Dense`'s init, drawn from `generator`.

    The weight is lecun-normal with fan-in `in_features`, the bias zero; the
    layer lives on the generator's device, and the global RNG is not drawn.
    """
    layer = nn.utils.skip_init(nn.Linear, in_features, out_features, device=generator.device)
    with torch.no_grad():
        lecun_normal_(layer.weight, in_features, generator)
        layer.bias.zero_()
    return layer


class BatchNorm(nn.Module):
    """Flax `nn.BatchNorm` over [..., features]: scale, bias and the statistics mean, var.

    Normalizes as Flax does, (x - mean) * (rsqrt(var + eps) * scale) + bias.
    In training mode it uses the batch's mean and biased variance
    (E[x^2] - E[x]^2, floored at 0) and moves the statistics to
    momentum * stat + (1 - momentum) * batch stat (Flax's momentum 0.99 is
    torch's 0.01; torch would use the unbiased variance).  With
    `trainable_stats` the statistics are parameters, not buffers.
    """

    def __init__(self, features: int, device=None, momentum: float = 0.99, eps: float = 1e-5,
                 trainable_stats: bool = False):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        stats = {"mean": torch.zeros(features, device=device),
                 "var": torch.ones(features, device=device)}
        for name, value in stats.items():
            if trainable_stats:
                setattr(self, name, nn.Parameter(value))
            else:
                self.register_buffer(name, value)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            axes = tuple(range(x.dim() - 1))
            mean = x.mean(dim=axes)
            var = torch.clamp(torch.square(x).mean(dim=axes) - torch.square(mean), min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias


def flatten_parameters(module: nn.Module) -> torch.Tensor:
    """Make every parameter of `module` a view of one flat f32[P] tensor, and return it.

    The optimizers then update the whole net with a few elementwise ops on
    the flat tensor (`adam_step` on its [1, P] view), and the module sees
    the new weights at once; `load_state_dict` writes through the views.
    """
    params = list(module.parameters())
    flat = torch.cat([p.detach().reshape(-1) for p in params])
    offset = 0
    for p in params:
        p.data = flat[offset:offset + p.numel()].view_as(p)
        offset += p.numel()
    return flat


def flat_grad(loss: torch.Tensor, module: nn.Module) -> torch.Tensor:
    """d loss / d parameters of `module`, flattened in `flatten_parameters`' order."""
    grads = torch.autograd.grad(loss, list(module.parameters()))
    return torch.cat([g.reshape(-1) for g in grads])


def minibatch_step(module: nn.Module, state: AdamState, xb, yb, wb, lr: float,
                   loss: Callable = mse_loss, skip_empty: bool = False,
                   dropout_mask: Optional[torch.Tensor] = None, data_parallel: bool = False):
    """(new state, per-net loss f32[nets]) of one weighted minibatch per net.

    xb f32[nets, bs, L, A], yb and wb f32[nets, bs].  Each net's loss is
    sum(loss * w) / (sum(w) + 1e-9).  With `skip_empty`, a net whose
    minibatch has no weight keeps its state (a true no-op).

    With `data_parallel`, the rows are this rank's share of the minibatch:
    the weight sum is all-reduced first, so each rank's loss is its rows'
    share of the global loss, and the ranks all-reduce (sum) the gradients
    and the losses.  Unequal shares still give the global mean; with one
    rank every value is the unsharded one, bit for bit.
    """
    if data_parallel:
        from flexs_tpu_torch.parallel.multihost import all_reduce_sum  # imports this package

    params = state.params.detach().requires_grad_()
    preds = forward_flat(module, params, xb, dropout_mask)
    wsum = wb.sum(dim=1)
    if data_parallel:
        wsum = all_reduce_sum(wsum)
    per_net = (loss(preds, yb) * wb).sum(dim=1) / (wsum + 1e-9)
    (grads,) = torch.autograd.grad(per_net.sum(), params)
    if data_parallel:
        grads, per_net = all_reduce_sum(grads), all_reduce_sum(per_net)
    keep = wsum > 0 if skip_empty else None
    return adam_step(state, grads, lr, keep), per_net.detach()


def fit(module: nn.Module, state: AdamState, x, y, w, generators: Sequence[torch.Generator],
        epochs: int, batch_size: int, lr: float, loss: Callable = mse_loss,
        skip_empty: bool = False, mesh=None):
    """Warm-started multi-epoch fit of C x M nets; returns (state, losses f32[epochs, nets]).

    x f32[C, R, L, A], y and w f32[C, R], R a multiple of `batch_size`.
    Net n trains on cell n // M's data and draws from `generators[n // M]`:
    per epoch a permutation of the R rows for each of the cell's M nets,
    then per minibatch, if the module has dropout, the cell's masks
    [M, batch_size, features].  A cell's draws are the same whatever C is.

    With a `mesh` (a `DeviceMesh` over every rank, each holding the same
    data and generators), each rank takes its contiguous share of each
    minibatch's rows and the ranks all-reduce the gradients
    (`minibatch_step(data_parallel=True)`): the counterpart of the JAX
    package's data-parallel fit.
    """
    lo, hi = 0, batch_size
    if mesh is not None:
        from flexs_tpu_torch.parallel.multihost import mesh_share  # imports this package

        position, size = mesh_share(mesh)
        lo, hi = position * batch_size // size, (position + 1) * batch_size // size
    dev = x.device
    cells, rows = w.shape
    nets = state.params.shape[0]
    members = nets // cells
    num_batches = rows // batch_size
    cell_of_net = torch.arange(cells, device=dev).repeat_interleave(members)[:, None]
    features = getattr(module, "dropout_features", None)
    losses = []
    for _ in range(epochs):
        perms = [
            torch.randperm(rows, generator=g, device=dev) for g in generators for _ in range(members)
        ]
        batches = torch.stack(perms).view(nets, num_batches, batch_size)
        epoch_losses = []
        for s in range(num_batches):
            idx = batches[:, s, lo:hi]
            mask = None
            if features is not None:
                draws = [
                    torch.empty((members, batch_size, features), device=dev).uniform_(generator=g)
                    for g in generators
                ]
                mask = torch.cat(draws)[:, lo:hi] < module.keep_prob
            state, batch_loss = minibatch_step(
                module, state, x[cell_of_net, idx], y[cell_of_net, idx], w[cell_of_net, idx],
                lr, loss, skip_empty, mask, data_parallel=mesh is not None,
            )
            epoch_losses.append(batch_loss)
        losses.append(torch.stack(epoch_losses).mean(dim=0))
    return state, torch.stack(losses)


class TorchModel(Model):
    """A model around an `nn.Module` net: one-hot [B, L, A] in, one score per row out."""

    def __init__(
        self,
        module: nn.Module,
        alphabet: str,
        name: str,
        batch_size: int = 256,
        epochs: int = 20,
        learning_rate: float = 1e-3,
        loss: Callable = mse_loss,
        seed: int = 0,
        mesh=None,
        custom_train_function: Optional[Callable] = None,
        custom_predict_function: Optional[Callable] = None,
        device=None,
    ):
        """Wrap a net.

        Args:
            module: An `nn.Module` taking one-hot f32[nets, B, L, A] and an
                optional `dropout_mask`, returning f32[nets, B] (the layers
                of `Dense` / `Conv`).  It defines the layers only; the
                model draws its own weights from `seed`.
            alphabet: Alphabet string or `Alphabet`.
            name: Human-readable model description (used for logging).
            batch_size: Minibatch size of the fit (reference default 256).
            epochs: Epochs per `train` call (reference default 20).
            learning_rate: Adam learning rate (Keras default 1e-3).
            loss: Per-sample loss `(preds, labels) -> losses`.
            seed: Seed of the model's generator (init, shuffles, dropout).
            mesh: Optional `DeviceMesh` over every rank
                (`parallel.multihost.multihost_sweep_mesh`) for a
                data-parallel fit: every rank trains on the same data from
                the same seed, takes its share of each minibatch, and the
                ranks all-reduce the gradients (`fit`), so every rank holds
                the same weights.  With one rank the fit is the unsharded
                one, bit for bit.
            custom_train_function: Optional override called as
                `(one_hots, labels)` instead of the built-in fit (reference
                keras_model.py:33-36).
            custom_predict_function: Optional override called as
                `(one_hots) -> predictions` (reference keras_model.py:37-38).
            device: Where the weights live and the fit runs (default
                "cuda"; pass "cpu" to run on the CPU).
        """
        super().__init__(name)
        if mesh is not None:
            from flexs_tpu_torch.parallel.multihost import mesh_share  # imports this package

            mesh_share(mesh)  # a mesh that is not a DeviceMesh over every rank raises
        self.mesh = mesh
        self.module = module
        self.alphabet = as_alphabet(alphabet)
        self.batch_size = batch_size
        self.epochs = epochs
        self.learning_rate = learning_rate
        self.loss = loss
        self.custom_train_function = custom_train_function
        self.custom_predict_function = custom_predict_function
        self.device = resolve_device(device)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)
        self._state: Optional[AdamState] = None

    def _one_hot(self, tokens) -> torch.Tensor:
        return one_hot(torch.as_tensor(np.asarray(tokens), device=self.device), len(self.alphabet))

    def _ensure_init(self) -> None:
        if self._state is None:
            self._state = adam_init(init_flat(self.module, 1, self._generator))

    def train(self, sequences: SEQUENCES_TYPE, labels, verbose: bool = False):
        """Fit for `self.epochs` epochs at `self.batch_size` (warm start)."""
        tokens = self.alphabet.encode(list(sequences))
        if self.custom_train_function is not None:
            self.custom_train_function(self._one_hot(tokens), np.asarray(labels))
            return
        n = len(tokens)
        bucket = next_bucket(n, minimum=self.batch_size)
        # Every epoch is a fixed grid of full minibatches; padding rows
        # (token 0) carry zero weight.
        bucket = -(-bucket // self.batch_size) * self.batch_size
        padded = np.zeros((bucket, tokens.shape[1]), tokens.dtype)
        padded[:n] = tokens
        y = torch.zeros(bucket, device=self.device)
        y[:n] = torch.as_tensor(np.asarray(labels, np.float32), device=self.device)
        w = torch.zeros(bucket, device=self.device)
        w[:n] = 1.0

        self._ensure_init()
        self._state, losses = fit(
            self.module, self._state, self._one_hot(padded)[None], y[None], w[None],
            [self._generator], self.epochs, self.batch_size, self.learning_rate, self.loss,
            mesh=self.mesh,
        )
        if verbose:
            print(f"{self.name}: epoch losses {losses[:, 0].cpu().numpy()}")

    def _fitness_function(self, sequences: SEQUENCES_TYPE) -> np.ndarray:
        tokens = self.alphabet.encode(list(sequences))
        if self.custom_predict_function is not None:
            preds = torch.as_tensor(self.custom_predict_function(self._one_hot(tokens)))
            return np.nan_to_num(np.asarray(preds.detach().cpu(), np.float64)).reshape(-1)
        return self.fitness_from_tokens(tokens)

    @torch.no_grad()
    def fitness_from_tokens(self, tokens) -> np.ndarray:
        """f64[B] predictions of int[B, L] tokens."""
        if len(tokens) == 0:
            return np.zeros(0, np.float64)
        self._ensure_init()
        preds = forward_flat(self.module, self._state.params, self._one_hot(tokens)[None])[0]
        return np.nan_to_num(preds.cpu().numpy().astype(np.float64))

