"""The port's CMA-ES against the JAX package's `ops/cmaes.py`, and the CMAES explorer.

`tell` is held to JAX's `tell_numpy` from the same state and solutions:
mean, sigma, the covariance, the evolution paths, and the sampling basis
as B diag(d^2) B^T (eigenvector signs differ between eigh
implementations), within 1e-5.  The sample transform is fed JAX's own
normal draws.
"""
import jax
import numpy as np
import pytest
import torch

import flexs_tpu
import flexs_tpu_torch
from flexs_tpu.ops import cmaes as jax_cma
from flexs_tpu_torch.ops import cmaes as cma

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel worker processes."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def _carry(state) -> cma.CMAState:
    """The port's state (CPU) of a JAX CMAState."""
    fields = {k: torch.tensor(np.asarray(v)) for k, v in state._asdict().items()
              if k != "count"}
    return cma.CMAState(**fields, count=int(state.count))


def _jax_state(n, popsize, generations, sigma=0.5, seed=0):
    """A JAX state after `generations` seeded ask/tell steps on a quadratic."""
    rng = np.random.default_rng(seed)
    state = jax_cma.init(rng.normal(size=n).astype(np.float32), sigma)
    key = jax.random.PRNGKey(seed)
    for _ in range(generations):
        key, k = jax.random.split(key)
        sols = jax_cma.ask_numpy(state, k, popsize)
        state = jax_cma.tell_numpy(state, sols, np.sum(sols**2, axis=1) + rng.random(popsize))
    return state


def _assert_states_close(port, ref, tol=TOL):
    for name in ("mean", "sigma", "cov", "p_sigma", "p_c"):
        np.testing.assert_allclose(getattr(port, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=tol, atol=tol, err_msg=name)
    basis = cma.covariance(port).numpy()
    ref_basis = (np.asarray(ref.eig_b) * np.asarray(ref.eig_d) ** 2) @ np.asarray(ref.eig_b).T
    np.testing.assert_allclose(basis, ref_basis, rtol=tol, atol=tol)
    assert port.count == int(ref.count)


@pytest.mark.parametrize("n,popsize,generations", [
    (8, 8, 0),  # the first generation, refreshing every step (gap 1)
    (8, 8, 5),
    (80, 8, 2),  # gap 2: the third tell keeps the cached basis
    (80, 8, 3),  # ... and the fourth refreshes it
])
def test_tell_matches_jax(n, popsize, generations):
    ref = _jax_state(n, popsize, generations)
    rng = np.random.default_rng(n + generations)
    sols = rng.normal(size=(popsize, n)).astype(np.float32)
    fits = rng.random(popsize).astype(np.float32)
    fits[1] = fits[0]  # a tie: the ranking is stable in both
    want = jax_cma.tell_numpy(ref, sols, fits)
    got = cma.tell_numpy(_carry(ref), sols, fits)
    refreshed = (generations + 1) % cma.lazy_gap(n, popsize) == 0
    if not refreshed:
        np.testing.assert_array_equal(got.eig_b.numpy(), np.asarray(ref.eig_b))
    assert cma.lazy_gap(n, popsize) == (2 if n == 80 else 1)
    _assert_states_close(got, want)


@pytest.mark.parametrize("sigma,spread,bound", [
    (1e-12, 0.0, 1e-12),  # solutions at the mean: p_sigma is 0 and sigma shrinks
    (1e6, 1e9, 1e6),  # far-flung solutions: sigma grows past the cap
])
def test_tell_clips_sigma_like_jax(sigma, spread, bound):
    ref = jax_cma.init(np.zeros(6, np.float32), sigma)
    rng = np.random.default_rng(3)
    sols = (rng.normal(size=(10, 6)) * spread).astype(np.float32)
    fits = rng.random(10).astype(np.float32)
    want = jax_cma.tell_numpy(ref, sols, fits)
    got = cma.tell_numpy(_carry(ref), sols, fits)
    assert float(want.sigma) == float(got.sigma) == float(np.float32(bound))
    _assert_states_close(got, want)


def test_sample_transform_matches_jax_ask():
    ref = _jax_state(12, 10, 4)
    key = jax.random.PRNGKey(7)
    want = jax_cma.ask_numpy(ref, key, 10)
    z = np.asarray(jax.random.normal(key, (10, 12), np.float32))
    got = cma.sample(_carry(ref), torch.tensor(z)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_ask_draws_from_the_generator():
    state = cma.init(np.zeros(5, np.float32), 0.3, device="cpu")
    g1, g2 = torch.Generator().manual_seed(1), torch.Generator().manual_seed(1)
    a, b = cma.ask_numpy(state, g1, 4), cma.ask_numpy(state, g2, 4)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (4, 5) and a.dtype == np.float32
    np.testing.assert_array_equal(cma.ask_numpy(state, g1, 4) == a, False)


def test_minimize_sphere_like_jax():
    """The band of the JAX package's test_cmaes_core_minimizes_sphere."""
    target = np.full(8, 3.0, dtype=np.float32)

    def sphere(x):
        return np.sum((x - target) ** 2, axis=1)

    best_x, best_f = cma.minimize(
        sphere, np.zeros(8, np.float32), sigma=1.0, popsize=16, iterations=60, seed=0,
        device="cpu",
    )
    assert best_f < 1e-2
    np.testing.assert_allclose(best_x, target, atol=0.15)


def test_sigma_stays_finite_on_flat_objective():
    state = cma.init(np.zeros(4, np.float32), 0.5, device="cpu")
    g = torch.Generator().manual_seed(0)
    for _ in range(5):
        sols = cma.ask_numpy(state, g, 8)
        state = cma.tell_numpy(state, sols, np.zeros(len(sols)))
    assert np.isfinite(float(state.sigma))
    assert torch.isfinite(state.cov).all()


class _FakeLandscape(flexs_tpu_torch.Landscape):
    def __init__(self):
        super().__init__(name="FakeLandscape")
        self.rng = np.random.default_rng(0)

    def _fitness_function(self, sequences):
        return self.rng.random(size=len(sequences))


class _CountA(flexs_tpu_torch.Model):
    def __init__(self):
        super().__init__(name="CountA")

    def train(self, *args):
        pass

    def _fitness_function(self, sequences):
        return np.array([s.count("A") / len(s) for s in sequences])


@pytest.mark.parametrize("maximize", [False, True])
def test_cmaes_explorer_run_invariants(maximize):
    """The JAX package's CMAES smoke invariants (3 rounds, batch 5, 30 queries)."""
    model = _CountA()
    explorer = flexs_tpu_torch.baselines.explorers.CMAES(
        model, rounds=3, sequences_batch_size=5, model_queries_per_batch=30,
        starting_sequence="TTGCAGCA", alphabet=flexs_tpu.DNAA, population_size=8, seed=0,
        maximize=maximize, device="cpu",
    )
    df, _ = explorer.run(_FakeLandscape(), verbose=False)
    assert df["round"].max() == 3
    for r in range(1, 4):
        assert 0 < len(df[df["round"] == r]) <= 5
    costs = df.groupby("round")["model_cost"].first().to_numpy()
    assert (np.diff(costs) >= 0).all() and costs[-1] <= 3 * 30
    assert explorer.name == "CMAES_popsize8"
