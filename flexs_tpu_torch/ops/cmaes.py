"""CMA-ES (covariance matrix adaptation evolution strategy) on tensors.

Contract (the JAX package's `ops/cmaes.py`, a from-scratch (mu/mu_w,
lambda) CMA-ES with Hansen's tutorial hyperparameters, replacing the
reference's `cma` package, reference cmaes.py:96-114):
  * MINIMIZES fitness, as `cma` does; callers that maximize negate.
  * `init` builds a state; `ask` samples x_i ~ N(mean, sigma^2 C) through
    the cached eigendecomposition C = B diag(d^2) B^T; `tell` ranks the
    solutions (stable, as `jnp.argsort`), moves the mean, updates the two
    evolution paths (with the h_sigma stall test, its generation count as
    f32), the rank-one and rank-mu covariance terms and sigma (clipped to
    [1e-12, 1e6]), and refreshes the eigendecomposition lazily, every
    max(1, int(1 / (10 n (c1 + c_mu)))) generations.
  * All state is f32 on one device.

The draw is separate from the transform: `ask` draws z ~ N(0, I) from a
`torch.Generator` and calls `sample(state, z)`, so the transform can be fed
any z (the JAX package's, in the tests).  `torch.linalg.eigh` returns
eigenvectors whose signs (and, for ties, order) differ from XLA's; the
covariance B diag(d^2) B^T they describe is the same.
"""
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from flexs_tpu_torch.device import resolve_device


class CMAState(NamedTuple):
    """CMA-ES evolution state (tensors on one device; `count` a host int)."""

    mean: torch.Tensor  # [n]
    sigma: torch.Tensor  # scalar step size
    cov: torch.Tensor  # [n, n] covariance
    p_sigma: torch.Tensor  # [n] step-size evolution path
    p_c: torch.Tensor  # [n] covariance evolution path
    eig_b: torch.Tensor  # [n, n] eigenbasis of cov
    eig_d: torch.Tensor  # [n] sqrt eigenvalues
    count: int  # generation counter


def _hyperparams(dim: int, popsize: int) -> dict:
    mu = popsize // 2
    ranks = np.arange(1, mu + 1)
    weights = np.log(mu + 0.5) - np.log(ranks)
    weights = weights / weights.sum()
    mu_eff = 1.0 / np.sum(weights**2)

    c_sigma = (mu_eff + 2) / (dim + mu_eff + 5)
    d_sigma = 1 + 2 * max(0.0, np.sqrt((mu_eff - 1) / (dim + 1)) - 1) + c_sigma
    c_c = (4 + mu_eff / dim) / (dim + 4 + 2 * mu_eff / dim)
    c_1 = 2 / ((dim + 1.3) ** 2 + mu_eff)
    c_mu = min(1 - c_1, 2 * (mu_eff - 2 + 1 / mu_eff) / ((dim + 2) ** 2 + mu_eff))
    chi_n = np.sqrt(dim) * (1 - 1 / (4 * dim) + 1 / (21 * dim**2))
    return {
        "mu": mu,
        "weights": weights.astype(np.float32),
        "mu_eff": float(mu_eff),
        "c_sigma": float(c_sigma),
        "d_sigma": float(d_sigma),
        "c_c": float(c_c),
        "c_1": float(c_1),
        "c_mu": float(c_mu),
        "chi_n": float(chi_n),
    }


def lazy_gap(dim: int, popsize: int) -> int:
    """Generations between two refreshes of the eigendecomposition."""
    hp = _hyperparams(dim, popsize)
    return max(1, int(1.0 / (10.0 * dim * (hp["c_1"] + hp["c_mu"]))))


def init(x0, sigma: float, device=None) -> CMAState:
    """A fresh state centered at `x0` with step size `sigma`, on `device` (default "cuda")."""
    dev = resolve_device(device)
    mean = torch.as_tensor(np.asarray(x0, np.float32), device=dev)
    n = mean.shape[0]
    return CMAState(
        mean=mean,
        sigma=torch.tensor(np.float32(sigma), device=dev),
        cov=torch.eye(n, device=dev),
        p_sigma=torch.zeros(n, device=dev),
        p_c=torch.zeros(n, device=dev),
        eig_b=torch.eye(n, device=dev),
        eig_d=torch.ones(n, device=dev),
        count=0,
    )


def sample(state: CMAState, z: torch.Tensor) -> torch.Tensor:
    """Candidates mean + sigma * B diag(d) z of isotropic draws z f32[popsize, n]."""
    z = torch.as_tensor(z, dtype=torch.float32, device=state.mean.device)
    y = torch.matmul(z * state.eig_d[None, :], state.eig_b.T)
    return state.mean[None, :] + state.sigma * y


def ask(state: CMAState, generator: torch.Generator, popsize: int) -> torch.Tensor:
    """Sample `popsize` candidate solutions x_i ~ N(mean, sigma^2 C)."""
    n = state.mean.shape[0]
    z = torch.randn((popsize, n), generator=generator, device=state.mean.device)
    return sample(state, z)


def tell(state: CMAState, solutions, fitnesses, popsize: Optional[int] = None) -> CMAState:
    """Update the state from evaluated solutions (minimization).

    `popsize` (JAX's static argument) is the number of rows of `solutions`;
    a `popsize` that is given and differs raises ValueError.
    """
    dev = state.mean.device
    solutions = torch.as_tensor(solutions, dtype=torch.float32, device=dev)
    fitnesses = torch.as_tensor(fitnesses, dtype=torch.float32, device=dev)
    if popsize is not None and popsize != solutions.shape[0]:
        raise ValueError(f"popsize {popsize} != {solutions.shape[0]} solutions")
    popsize, n = solutions.shape
    hp = _hyperparams(n, popsize)
    weights = torch.as_tensor(hp["weights"], device=dev)
    mu = hp["mu"]

    order = torch.argsort(fitnesses, stable=True)
    elite = solutions[order[:mu]]  # [mu, n]
    y_elite = (elite - state.mean[None, :]) / state.sigma
    y_bar = torch.matmul(weights, y_elite)  # [n]

    new_mean = state.mean + state.sigma * y_bar

    # C^{-1/2} y_bar through the cached eigendecomposition.
    inv_sqrt_y = torch.matmul(
        state.eig_b, torch.matmul(state.eig_b.T, y_bar) / state.eig_d.clamp(min=1e-20)
    )
    c_sigma = hp["c_sigma"]
    p_sigma = (1 - c_sigma) * state.p_sigma + math.sqrt(
        c_sigma * (2 - c_sigma) * hp["mu_eff"]
    ) * inv_sqrt_y

    count = state.count + 1
    ps_norm = torch.linalg.vector_norm(p_sigma)
    decay = torch.pow(
        torch.tensor(1 - c_sigma, dtype=torch.float32, device=dev),
        torch.tensor(2 * np.float32(count), dtype=torch.float32, device=dev),
    )
    h_sigma = (
        ps_norm / torch.sqrt(1 - decay) < (1.4 + 2 / (n + 1)) * hp["chi_n"]
    ).float()

    c_c = hp["c_c"]
    p_c = (1 - c_c) * state.p_c + h_sigma * math.sqrt(c_c * (2 - c_c) * hp["mu_eff"]) * y_bar

    delta_h = (1 - h_sigma) * c_c * (2 - c_c)
    rank_one = torch.outer(p_c, p_c)
    rank_mu = torch.matmul((y_elite * weights[:, None]).T, y_elite)
    c_1, c_mu = hp["c_1"], hp["c_mu"]
    cov = (1 - c_1 - c_mu) * state.cov + c_1 * (rank_one + delta_h * state.cov) + c_mu * rank_mu
    cov = (cov + cov.T) / 2

    sigma = state.sigma * torch.exp((c_sigma / hp["d_sigma"]) * (ps_norm / hp["chi_n"] - 1))
    # Guard against overflow or collapse under pathological objectives.
    sigma = sigma.clamp(1e-12, 1e6)

    # Lazy eigendecomposition (standard CMA-ES practice): an O(n^3) eigh
    # every generation would dominate the wall clock in high dimension.
    if count % lazy_gap(n, popsize) == 0:
        eig_vals, eig_b = torch.linalg.eigh(cov)
    else:
        eig_vals, eig_b = torch.square(state.eig_d), state.eig_b
    eig_d = torch.sqrt(eig_vals.clamp(min=1e-20))

    return CMAState(
        mean=new_mean, sigma=sigma, cov=cov, p_sigma=p_sigma, p_c=p_c, eig_b=eig_b,
        eig_d=eig_d, count=count,
    )


def ask_numpy(state: CMAState, generator: torch.Generator, popsize: int) -> np.ndarray:
    """Host `ask`: f32[popsize, n] numpy solutions."""
    return ask(state, generator, popsize).cpu().numpy()


def tell_numpy(state: CMAState, solutions: np.ndarray, fitnesses: np.ndarray) -> CMAState:
    """Host `tell` taking numpy arrays."""
    return tell(state, np.asarray(solutions, np.float32), np.asarray(fitnesses, np.float32))


def covariance(state: CMAState) -> torch.Tensor:
    """B diag(d^2) B^T: the covariance the sampling basis describes."""
    return torch.matmul(state.eig_b * torch.square(state.eig_d)[None, :], state.eig_b.T)


def minimize(
    fn, x0: np.ndarray, sigma: float, popsize: int, iterations: int, seed: int = 0,
    device=None,
) -> Tuple[np.ndarray, float]:
    """Minimize `fn` (batched [pop, n] -> [pop]) from `x0`; returns (best x, best f)."""
    state = init(x0, sigma, device)
    generator = torch.Generator(device=state.mean.device)
    generator.manual_seed(seed)
    best_x, best_f = np.asarray(x0), np.inf
    for _ in range(iterations):
        solutions = ask_numpy(state, generator, popsize)
        fitnesses = np.asarray(fn(solutions))
        i = int(np.argmin(fitnesses))
        if fitnesses[i] < best_f:
            best_x, best_f = solutions[i], float(fitnesses[i])
        state = tell_numpy(state, solutions, fitnesses)
    return best_x, best_f
