"""Closed-form linear models fitted on the run's device.

The port of the JAX package's `jax_linear.py`.  The reference's linear
members come from sklearn (sklearn_models.py:67-91) and run on the host;
these solve the same problems with tensor ops over flattened one-hot
features:
  * `TorchRidgeRegression`: weighted ridge over one-hot features plus a
    bias column, solved through an eigh pseudo-inverse with a
    1e-6 * max(s) cut, since the one-hot blocks are collinear with the
    bias column (alpha = 0 is sklearn's minimum-norm LinearRegression);
  * `TorchBayesianRidge`: sklearn BayesianRidge's evidence maximization
    (centred X and y, hyperpriors 1e-6, at most 300 iterations, stop when
    the coefficients move less than 1e-3 in L1, a final refresh);
  * `TorchLasso`: 1000 FISTA steps on sklearn Lasso's objective
    1/(2n)||y - Xw||^2 + alpha ||w||_1.

The JAX package pads the training rows to a power-of-two bucket with
zero-weight rows so that XLA compiles once per bucket; a zero-weight row
adds nothing to these fits, so the port does not pad.  The ridge solve
runs in f64 (LAPACK's f32 eigh can fail to converge on the rank-deficient
Gram matrix, and `ridge_coef` says why its right-hand side needs f64 too);
predictions, not coefficients, are compared with the JAX package, as
eigenvector signs and the near-zero eigenvalues differ between LAPACK
builds.
"""
from typing import Optional

import numpy as np
import torch

from flexs_tpu_torch.alphabet import as_alphabet
from flexs_tpu_torch.baselines.models.torch_model import one_hot
from flexs_tpu_torch.device import resolve_device
from flexs_tpu_torch.model import Model
from flexs_tpu_torch.types import SEQUENCES_TYPE

BAYES_MAX_ITERS = 300
# The evidence iteration stops on the device; the host looks every this
# many iterations (one sync each), which changes no result.
_BAYES_CHECK_EVERY = 10
LASSO_ITERS = 1000


def features(tokens: torch.Tensor, alphabet_size: int) -> torch.Tensor:
    """Flattened one-hot features f32[N, L * A] of int[N, L] tokens."""
    return one_hot(tokens, alphabet_size).reshape(len(tokens), -1)


def ridge_coef(x: torch.Tensor, labels: torch.Tensor, weight: torch.Tensor,
               lam: float = 0.0) -> torch.Tensor:
    """Weighted ridge solution f32[P + 1] over features f32[N, P] and a bias column.

    The minimum-norm solution through an eigh pseudo-inverse of the Gram
    matrix, eigenvalues below 1e-6 * max(s) cut.  All in f64: with fewer
    rows than features the kept eigenvalues span six decades, so f32
    rounding in the right-hand side (its sum order differs between devices)
    would move predictions by 3e-4 at L = 100.
    """
    xf = torch.cat([x, torch.ones((len(x), 1), device=x.device)], dim=1).double()
    xw = xf * weight.double()[:, None]
    gram = xw.T @ xf
    rhs = xw.T @ labels.double()
    s, v = torch.linalg.eigh(gram)
    inv_s = torch.where(s + lam > 1e-6 * s.max(), 1.0 / (s + lam), 0.0)
    return (v @ (inv_s * (v.T @ rhs))).float()


def _centred(x, labels):
    n = torch.tensor(float(len(x)), device=x.device)
    x_mean = x.sum(dim=0) / n
    y_mean = labels.sum() / n
    return n, x_mean, y_mean, x - x_mean, labels - y_mean


def fit_bayesian_ridge(x: torch.Tensor, labels: torch.Tensor):
    """sklearn BayesianRidge's fit: (coef f32[P], intercept f32[]).

    X is factorized once by SVD; each iteration is a diagonal reweighting.
    A converged state is kept unchanged by later iterations, as in the
    JAX package's fixed-length scan.
    """
    n, x_mean, y_mean, xc, yc = _centred(x, labels)
    u, s, vt = torch.linalg.svd(xc, full_matrices=False)
    uty = u.T @ yc
    s2 = s * s
    eps = torch.finfo(torch.float32).eps
    y_var = torch.clamp((yc * yc).sum() / n, min=eps)
    a1 = a2 = l1 = l2 = 1e-6

    alpha_, lambda_ = 1.0 / y_var, torch.ones((), device=x.device)
    coef = torch.zeros(x.shape[1], device=x.device)
    done = torch.zeros((), dtype=torch.bool, device=x.device)
    for i in range(BAYES_MAX_ITERS):
        scale = s / (s2 + lambda_ / alpha_)
        new_coef = vt.T @ (scale * uty)
        gamma = ((alpha_ * s2) / (lambda_ + alpha_ * s2)).sum()
        resid = yc - xc @ new_coef
        rmse = (resid * resid).sum()
        new_lambda = (gamma + 2 * l1) / ((new_coef * new_coef).sum() + 2 * l2)
        new_alpha = (n - gamma + 2 * a1) / (rmse + 2 * a2)
        converged = (new_coef - coef).abs().sum() < 1e-3
        alpha_ = torch.where(done, alpha_, new_alpha)
        lambda_ = torch.where(done, lambda_, new_lambda)
        coef = torch.where(done, coef, new_coef)
        done = done | converged
        if (i + 1) % _BAYES_CHECK_EVERY == 0 and bool(done):
            break
    # sklearn recomputes coef_ at the converged hyperparameters.
    scale = s / (s2 + lambda_ / alpha_)
    coef = vt.T @ (scale * uty)
    return coef, y_mean - x_mean @ coef


def _soft(z, t):
    return torch.sign(z) * torch.clamp(z.abs() - t, min=0.0)


def fit_lasso(x: torch.Tensor, labels: torch.Tensor, alpha: float, iters: int = LASSO_ITERS):
    """Lasso by FISTA on centred X and y: (coef f32[P], intercept f32[]).

    sklearn solves the same convex objective by coordinate descent; with
    collinear one-hot columns the minimizing coefficients may differ but
    the fitted values agree.  The step size is 1 / the Lipschitz constant
    of the gradient, the largest eigenvalue of X^T X / n.
    """
    n, x_mean, y_mean, xc, yc = _centred(x, labels)
    gram = xc.T @ xc
    lip = torch.linalg.eigvalsh(gram.double())[-1].float() / n + 1e-6
    xty = xc.T @ yc
    thresh = alpha / lip
    coef = z = torch.zeros(x.shape[1], device=x.device)
    t = np.float32(1.0)
    for _ in range(iters):
        grad = (gram @ z - xty) / n
        new_coef = _soft(z - grad / lip, thresh)
        # The momentum schedule is data-independent: f32 arithmetic on the host.
        new_t = (np.float32(1.0) + np.sqrt(np.float32(1.0) + np.float32(4.0) * t * t)) / np.float32(2.0)
        z = new_coef + float((t - np.float32(1.0)) / new_t) * (new_coef - coef)
        coef, t = new_coef, new_t
    return coef, y_mean - x_mean @ coef


def predict_linear(x: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """f32[N] predictions of features f32[N, P] under coef f32[P + 1] (last: bias)."""
    return x @ coef[:-1] + coef[-1]


class DeviceModel(Model):
    """A model of int tokens on a device, f64 numpy out: the plumbing shared by
    the linear, GP, k-NN and tree models."""

    def __init__(self, alphabet, name: str, device=None):
        super().__init__(name)
        self.alphabet = as_alphabet(alphabet)
        self.device = resolve_device(device)
        self._state = None

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(np.asarray(tokens), device=self.device)

    def _features(self, tokens) -> torch.Tensor:
        return features(self._tokens(tokens), len(self.alphabet))

    def _labels(self, labels) -> torch.Tensor:
        return torch.as_tensor(np.asarray(labels, np.float32), device=self.device)

    def _fitness_function(self, sequences: SEQUENCES_TYPE) -> np.ndarray:
        return self.fitness_from_tokens(self.alphabet.encode(list(sequences)))


class _LinearModel(DeviceModel):
    """A fit to (coef f32[P + 1] with the bias last, intercept added in f64)."""

    def __init__(self, alphabet, name: str, device=None):
        super().__init__(alphabet, name, device)
        self._coef: Optional[torch.Tensor] = None
        self._intercept = 0.0

    def _train_args(self, sequences, labels):
        return self._features(self.alphabet.encode(list(sequences))), self._labels(labels)

    @torch.no_grad()
    def fitness_from_tokens(self, tokens) -> np.ndarray:
        """f64[B] predictions of int[B, L] tokens."""
        if self._coef is None:
            raise RuntimeError(f"{self.name} queried before train()")
        preds = predict_linear(self._features(tokens), self._coef)
        return preds.cpu().numpy().astype(np.float64) + float(self._intercept)


class TorchRidgeRegression(_LinearModel):
    """(Weighted) ridge regression over one-hot features, solved on the device."""

    def __init__(self, alphabet: str, alpha: float = 0.0, name: Optional[str] = None,
                 device=None):
        """Create a ridge model; `alpha=0` is ordinary least squares (minimum norm)."""
        super().__init__(alphabet, name or f"jax_ridge_alpha={alpha}", device)
        self.alpha = alpha

    @torch.no_grad()
    def train(self, sequences: SEQUENCES_TYPE, labels):
        """Solve the normal equations for the measured set."""
        x, y = self._train_args(sequences, labels)
        self._coef = ridge_coef(x, y, torch.ones_like(y), self.alpha)


class _CentredLinear(_LinearModel):
    """A fit that returns (coef, intercept) over centred data."""

    def _set(self, coef, intercept):
        self._coef = torch.cat([coef, torch.zeros(1, device=coef.device)])
        self._intercept = float(intercept)


class TorchBayesianRidge(_CentredLinear):
    """BayesianRidge on the device (sklearn's evidence-maximization defaults)."""

    def __init__(self, alphabet: str, name: Optional[str] = None, device=None):
        """Create a Bayesian ridge model."""
        super().__init__(alphabet, name or "bayesian_ridge", device)

    @torch.no_grad()
    def train(self, sequences: SEQUENCES_TYPE, labels):
        """Run the evidence iteration on the measured set."""
        self._set(*fit_bayesian_ridge(*self._train_args(sequences, labels)))


class TorchLasso(_CentredLinear):
    """Lasso on the device (FISTA on sklearn's objective; alpha 1.0 by default)."""

    def __init__(self, alphabet: str, alpha: float = 1.0, name: Optional[str] = None,
                 device=None):
        """Create a Lasso model (`alpha` as in sklearn.linear_model.Lasso)."""
        super().__init__(alphabet, name or "lasso", device)
        self.alpha = alpha

    @torch.no_grad()
    def train(self, sequences: SEQUENCES_TYPE, labels):
        """Run FISTA towards the Lasso optimum of the measured set."""
        self._set(*fit_lasso(*self._train_args(sequences, labels), self.alpha))
