"""Exact Gaussian-process and k-NN regressors on the run's device.

The port of the JAX package's `jax_gp.py`.  The reference's DynaPPO
ensemble includes sklearn's `GaussianProcessRegressor()` and
`KNeighborsRegressor()` over flattened one-hot encodings (reference
dyna_ppo.py:51-85).  For fixed-length tokens the squared Euclidean
distance between one-hot encodings is 2 * Hamming, so both reduce to a
Hamming matrix, here one matrix product of one-hot features (exact: its
entries are integer counts far below 2^24), plus a Cholesky factorization
for the GP.

  * `gp_fit` maximizes the log marginal likelihood of sklearn's default
    kernel `ConstantKernel(1.0) * RBF(1.0)` (alpha = 1e-10, plus 1e-8 on
    the diagonal for the f32 factorization) over (log c, log l) from
    (0, 0) with 150 steps of `optax.adam(0.1)` (the port's `adam_step`),
    keeping the best point seen.  A factorization that fails makes the
    step's value, gradient and factor NaN, as `jnp.linalg.cholesky` does:
    that step is never the best, and Adam's NaN update makes every later
    point NaN, so the best point stays where it was.  The failure flag
    stays on the device: no step waits for the host.
  * `TorchKNNRegressor` is sklearn's default k = 5 with uniform weights;
    ties at the k-th neighbour go to the lower training index, through an
    int64 key distance * (n + 1) + index.  The k labels are summed in
    order and scaled by 1/k, the order XLA uses on the CPU, so predictions
    equal the JAX package's bitwise.

The JAX package pads the training rows to power-of-two buckets so that
XLA compiles once per bucket; padded rows are masked out of both models'
results (a padded GP row is decoupled: zero kernel row, unit diagonal), so
the port does not pad.  Its functions still take a `valid` mask, which
the in-run surrogate (`runtime/surrogate.py`, arch "gp") uses for its
fixed-capacity buffer and for the JAX package's padded state carried
across (`convert.gp_state_from_jax`).
"""
from typing import NamedTuple, Optional

import numpy as np
import torch

from flexs_tpu_torch.baselines.models.torch_linear import DeviceModel
from flexs_tpu_torch.baselines.models.torch_model import adam_init, adam_step, one_hot
from flexs_tpu_torch.types import SEQUENCES_TYPE

GP_OPT_STEPS = 150
GP_LEARNING_RATE = 0.1


def hamming(a: torch.Tensor, b: torch.Tensor, alphabet_size: int) -> torch.Tensor:
    """Hamming distances f32[N, M] of int[N, L] and int[M, L] tokens (exact integers)."""
    xa = one_hot(a, alphabet_size).reshape(len(a), -1)
    xb = one_hot(b, alphabet_size).reshape(len(b), -1)
    return a.shape[1] - xa @ xb.T


def _kernel(d2, theta):
    """ConstantKernel * RBF over squared distances (sklearn's default)."""
    return torch.exp(theta[0]) * torch.exp(-0.5 * d2 / torch.exp(2.0 * theta[1]))


def _cholesky(k):
    """(lower factor, failed): failed is NaN where the factorization failed, else 0.

    A failed factor is NaN on and below its diagonal, as JAX's is; the flag
    stays on the device (no host sync).
    """
    chol, info = torch.linalg.cholesky_ex(k)
    failed = torch.where(info == 0, 0.0, torch.nan)
    return chol + torch.tril(failed.expand_as(chol)), failed


class GPFit(NamedTuple):
    theta: torch.Tensor  # f32[2]: (log constant, log length scale)
    dual: torch.Tensor  # f32[n]: K^-1 y
    chol: torch.Tensor  # f32[n, n]: lower Cholesky factor of K


def gp_fit(tokens: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor, alphabet_size: int,
           opt_steps: int = GP_OPT_STEPS) -> GPFit:
    """Maximize the log marginal likelihood over the valid rows; return the fit.

    Rows where `valid` is False are decoupled: their kernel rows are zero
    and their diagonal 1, so they add a constant to the likelihood and
    nothing to the posterior.
    """
    n = len(tokens)
    d2 = 2.0 * hamming(tokens, tokens, alphabet_size)
    y = torch.where(valid, labels, 0.0)
    outer = valid[:, None] & valid[None, :]
    # alpha = 1e-10 is sklearn's; the 1e-8 everywhere stabilizes the f32
    # factorization (sklearn factorizes in f64).
    jitter = torch.diag(torch.where(valid, 1e-10, 1.0))
    stabilizer = 1e-8 * torch.eye(n, device=d2.device)

    def build_k(theta):
        return torch.where(outer, _kernel(d2, theta), 0.0) + jitter + stabilizer

    def neg_lml(theta):
        chol, failed = _cholesky(build_k(theta))
        alpha = torch.cholesky_solve(y[:, None], chol)[:, 0]
        logdet = 2.0 * torch.log(torch.diagonal(chol)).sum()
        return 0.5 * (y @ alpha) + 0.5 * logdet, failed

    theta0 = torch.zeros(2, device=d2.device)
    with torch.no_grad():
        best_val = neg_lml(theta0)[0]
    best_theta = theta0
    state = adam_init(theta0[None])
    for _ in range(opt_steps):
        theta = state.params[0].detach().requires_grad_()
        with torch.enable_grad():
            val, failed = neg_lml(theta)
            (grad,) = torch.autograd.grad(val, theta)
        val = val.detach()
        better = torch.isfinite(val) & (val < best_val)
        best_theta = torch.where(better, theta.detach(), best_theta)
        best_val = torch.where(better, val, best_val)
        state = adam_step(state, (grad + failed)[None], GP_LEARNING_RATE)
    with torch.no_grad():
        chol = _cholesky(build_k(best_theta))[0]
        dual = torch.cholesky_solve(y[:, None], chol)[:, 0]
    return GPFit(best_theta, dual, chol)


@torch.no_grad()
def gp_posterior(tokens: torch.Tensor, train_tokens: torch.Tensor, fit: GPFit,
                 valid: torch.Tensor, alphabet_size: int, with_std: bool = True):
    """Posterior (mean f32[B], std f32[B] or None) at `tokens`."""
    d2 = 2.0 * hamming(tokens, train_tokens, alphabet_size)
    k_star = torch.where(valid[None, :], _kernel(d2, fit.theta), 0.0)
    mu = k_star @ fit.dual
    if not with_std:
        return mu, None
    v = torch.linalg.solve_triangular(fit.chol, k_star.T, upper=False)
    var = torch.exp(fit.theta[0]) - (v * v).sum(dim=0)
    return mu, torch.sqrt(torch.clamp(var, min=0.0))


class _TokenModel(DeviceModel):
    """A model over the training rows' tokens, all of them valid."""

    def _train_tensors(self, sequences, labels):
        tokens = self._tokens(self.alphabet.encode(list(sequences)))
        return tokens, self._labels(labels), torch.ones(len(tokens), dtype=torch.bool,
                                                        device=self.device)

    def _check_fitted(self):
        if self._state is None:
            raise RuntimeError(f"{self.name} queried before train()")


class GPState(NamedTuple):
    """A fitted GP: its training rows and their mask, and the fit."""

    train_tokens: torch.Tensor  # int64[n, L]
    valid: torch.Tensor  # bool[n]
    fit: GPFit


class TorchGaussianProcessRegressor(_TokenModel):
    """Exact GP regression on the device (RBF kernel over token Hamming)."""

    def __init__(self, alphabet: str, name: Optional[str] = None, device=None):
        """Create a GP with sklearn's default kernel form."""
        super().__init__(alphabet, name or "gaussian_process", device)

    def train(self, sequences: SEQUENCES_TYPE, labels):
        """Fit the kernel hyperparameters and the dual coefficients."""
        tokens, y, valid = self._train_tensors(sequences, labels)
        self._state = GPState(tokens, valid, gp_fit(tokens, y, valid, len(self.alphabet)))

    def _posterior(self, tokens, with_std: bool):
        self._check_fitted()
        return gp_posterior(self._tokens(tokens), self._state.train_tokens, self._state.fit,
                            self._state.valid, len(self.alphabet), with_std)

    def fitness_from_tokens(self, tokens) -> np.ndarray:
        """Posterior mean f64[B] of int[B, L] tokens."""
        return self._posterior(tokens, with_std=False)[0].cpu().numpy().astype(np.float64)

    def fitness_std_from_tokens(self, tokens) -> np.ndarray:
        """Posterior standard deviation f64[B] (a real GP sigma, unlike the
        reference's ensemble-spread proxy, reference bo.py:318-319)."""
        return self._posterior(tokens, with_std=True)[1].cpu().numpy().astype(np.float64)


class KNNState(NamedTuple):
    """A k-NN model's training rows, their labels and mask, and k."""

    train_tokens: torch.Tensor  # int64[n, L]
    train_labels: torch.Tensor  # f32[n]
    valid: torch.Tensor  # bool[n]
    k: int


@torch.no_grad()
def knn_predict(tokens: torch.Tensor, state: KNNState, alphabet_size: int) -> torch.Tensor:
    """Mean label f32[B] of each query's k nearest valid training rows."""
    n = len(state.train_tokens)
    dists = hamming(tokens, state.train_tokens, alphabet_size).long()
    index = torch.arange(n, device=dists.device)
    keys = torch.where(state.valid[None, :], dists * (n + 1) + index,
                       torch.iinfo(torch.int64).max)
    nearest = torch.topk(keys, state.k, dim=1, largest=False, sorted=True).indices
    labels = state.train_labels[nearest]
    total = labels[:, 0]
    for j in range(1, state.k):
        total = total + labels[:, j]
    return total * torch.tensor(1.0 / state.k, dtype=torch.float32, device=total.device)


class TorchKNNRegressor(_TokenModel):
    """k-nearest-neighbours regression on the device (Hamming metric)."""

    def __init__(self, alphabet: str, n_neighbors: int = 5, name: Optional[str] = None,
                 device=None):
        """Create a k-NN regressor (sklearn defaults: k = 5, uniform weights)."""
        super().__init__(alphabet, name or "nearest_neighbors", device)
        self.n_neighbors = n_neighbors

    def train(self, sequences: SEQUENCES_TYPE, labels):
        """Keep the training set on the device."""
        tokens, y, valid = self._train_tensors(sequences, labels)
        self._state = KNNState(tokens, y, valid, min(self.n_neighbors, len(tokens)))

    def fitness_from_tokens(self, tokens) -> np.ndarray:
        """Mean of the k nearest training labels, f64[B]."""
        self._check_fitted()
        preds = knn_predict(self._tokens(tokens), self._state, len(self.alphabet))
        return preds.cpu().numpy().astype(np.float64)
