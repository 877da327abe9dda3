"""The port's exact GP and k-NN regressors against the JAX package and sklearn.

Same numpy-seeded data through both packages.  Tolerances: k-NN equal to
JAX's bitwise (integer keys, the same tie-breaks, labels summed in XLA's
order); a GP fit carried across (`convert.gp_state_from_jax`) within
1e-6; a GP fitted by each package: posterior mean within 1e-4, std
within 1e-3 (the best point is picked among f32 likelihood values that
are flat to their last bits, so the two fits' length scales differ by
about 1e-4, largest seen 1.2e-4 in the std); sklearn agreement at
tests/test_jax_gp.py's own tolerances.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexs_tpu.baselines.models import jax_gp

from flexs_tpu_torch.alphabet import as_alphabet
from flexs_tpu_torch.baselines.models import torch_gp
from flexs_tpu_torch.baselines.models.convert import gp_state_from_jax, knn_state_from_jax

ALPHA = as_alphabet("TGCA")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel worker processes."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


@pytest.fixture(scope="module")
def data():
    """tests/test_jax_gp.py's data."""
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 4, size=(40, 8)).astype(np.int32)
    labels = rng.normal(size=40)
    queries = rng.integers(0, 4, size=(32, 8)).astype(np.int32)
    return tokens, labels, queries


def _one_hot(tokens):
    return np.eye(4)[tokens].reshape(len(tokens), -1)


def _gp(device="cpu"):
    return torch_gp.TorchGaussianProcessRegressor("TGCA", device=device)


def test_hamming_is_exact():
    rng = np.random.default_rng(1)
    a, b = rng.integers(0, 4, (30, 50)), rng.integers(0, 4, (20, 50))
    got = torch_gp.hamming(torch.as_tensor(a), torch.as_tensor(b), 4)
    assert torch.equal(got, torch.as_tensor((a[:, None] != b[None]).sum(-1), dtype=torch.float32))


def test_gp_matches_sklearn(data):
    from sklearn.gaussian_process import GaussianProcessRegressor

    tokens, labels, queries = data
    sk = GaussianProcessRegressor().fit(_one_hot(tokens), labels)
    sk_mu, sk_std = sk.predict(_one_hot(queries), return_std=True)
    gp = _gp()
    gp.train(ALPHA.decode(tokens), labels)
    np.testing.assert_allclose(gp.fitness_from_tokens(queries), sk_mu, atol=1e-4)
    np.testing.assert_allclose(gp.fitness_std_from_tokens(queries), sk_std, atol=1e-4)


def test_gp_interpolates_training_points(data):
    tokens, labels, _ = data
    gp = _gp()
    gp.train(ALPHA.decode(tokens), labels)
    np.testing.assert_allclose(gp.fitness_from_tokens(tokens), labels, atol=1e-2)
    assert gp.fitness_std_from_tokens(tokens).max() < 0.1


def test_gp_string_api_and_guard(data):
    tokens, labels, queries = data
    gp = _gp()
    assert gp.name == "gaussian_process"
    with pytest.raises(RuntimeError):
        gp.get_fitness(ALPHA.decode(queries[:2]))
    gp.train(ALPHA.decode(tokens), labels)
    np.testing.assert_array_equal(gp.get_fitness(ALPHA.decode(queries)),
                                  gp.fitness_from_tokens(queries))


def test_gp_fit_equals_jax(data):
    tokens, labels, queries = data
    jm = jax_gp.JaxGaussianProcessRegressor("TGCA")
    jm.train(ALPHA.decode(tokens), labels)
    gp = _gp()
    gp.train(ALPHA.decode(tokens), labels)
    np.testing.assert_allclose(gp._state.fit.theta.numpy(), np.asarray(jm._state[1]), atol=1e-3)
    np.testing.assert_allclose(gp.fitness_from_tokens(queries), jm.fitness_from_tokens(queries),
                               atol=1e-4)
    np.testing.assert_allclose(gp.fitness_std_from_tokens(queries),
                               jm.fitness_std_from_tokens(queries), atol=1e-3)


def test_gp_carried_state_predicts_as_jax(data):
    """JAX's padded state (a 64-row bucket for 40 rows) carried across."""
    tokens, labels, queries = data
    jm = jax_gp.JaxGaussianProcessRegressor("TGCA")
    jm.train(ALPHA.decode(tokens), labels)
    gp = _gp()
    gp._state = gp_state_from_jax(*(np.asarray(a) for a in jm._state))
    assert len(gp._state.valid) == 64 and int(gp._state.valid.sum()) == 40
    np.testing.assert_allclose(gp.fitness_from_tokens(queries), jm.fitness_from_tokens(queries),
                               atol=1e-6)
    np.testing.assert_allclose(gp.fitness_std_from_tokens(queries),
                               jm.fitness_std_from_tokens(queries), atol=1e-6)


def test_failed_factorization_is_nan_as_in_jax():
    """jnp.linalg.cholesky gives NaN where torch.linalg.cholesky would raise."""
    k = torch.tensor([[1.0, 2.0], [2.0, 1.0]])
    chol, failed = torch_gp._cholesky(k)
    want = np.asarray(jnp.linalg.cholesky(jnp.asarray(k.numpy())))
    np.testing.assert_array_equal(chol.numpy(), want)  # NaN below the diagonal, 0 above
    assert torch.isnan(torch.tril(chol)[torch.tril(torch.ones(2, 2)) > 0]).all()
    assert torch.isnan(failed)
    chol, failed = torch_gp._cholesky(torch.eye(2) * 4)
    assert torch.equal(chol, torch.eye(2) * 2) and float(failed) == 0.0


def test_duplicate_rows_fail_at_the_start_as_in_jax(data):
    """Without the surrogate's dedup a duplicate row makes K exactly singular at
    theta = (0, 0): the first value is NaN, so no step is ever better and the
    best point stays (0, 0), whose factor is NaN, in both packages."""
    tokens, labels, queries = data
    tokens = tokens.copy()
    tokens[5] = tokens[2]
    valid = np.ones(len(tokens), bool)
    theta, dual, chol = jax_gp.gp_fit(jnp.asarray(tokens), jnp.asarray(labels, jnp.float32),
                                      jnp.asarray(valid))
    fit = torch_gp.gp_fit(torch.as_tensor(tokens).long(), torch.as_tensor(labels).float(),
                          torch.as_tensor(valid), 4)
    np.testing.assert_array_equal(fit.theta.numpy(), np.asarray(theta))
    np.testing.assert_array_equal(fit.theta.numpy(), [0.0, 0.0])
    for got, want in ((fit.dual, dual), (fit.chol, chol)):
        np.testing.assert_array_equal(torch.isnan(got).numpy(), np.isnan(np.asarray(want)))
    mu, std = torch_gp.gp_posterior(torch.as_tensor(queries).long(), torch.as_tensor(tokens).long(),
                                    fit, torch.as_tensor(valid), 4)
    assert torch.isnan(mu).all() and torch.isnan(std).all()


def test_failure_mid_run_keeps_the_best_point_before_it(data, monkeypatch):
    """A factorization that fails at step 40 of 150: its value and gradient are
    NaN, Adam's update makes every later point NaN, and the fit is the one
    the first 40 steps give.  (Where K becomes ill conditioned on its own,
    the two packages' f32 factorizations round apart and their runs fail at
    different steps; ROADMAP.md, queue 3, records the case.)"""
    tokens, labels, _ = data
    args = (torch.as_tensor(tokens).long(), torch.as_tensor(labels).float(),
            torch.ones(len(tokens), dtype=torch.bool), 4)
    want = torch_gp.gp_fit(*args, opt_steps=40)
    calls, cholesky_ex = [], torch.linalg.cholesky_ex

    def failing_at_step_40(k):
        calls.append(None)
        chol, info = cholesky_ex(k)
        return chol, info + (len(calls) == 1 + 40 + 1)  # the first call is theta0's value

    grads, adam_step = [], torch_gp.adam_step

    def spy(state, grad, lr):
        grads.append(grad)
        return adam_step(state, grad, lr)

    monkeypatch.setattr(torch.linalg, "cholesky_ex", failing_at_step_40)
    monkeypatch.setattr(torch_gp, "adam_step", spy)
    got = torch_gp.gp_fit(*args, opt_steps=150)
    finite = [bool(torch.isfinite(g).all()) for g in grads]
    assert finite == [True] * 40 + [False] * 110
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_knn_matches_handwritten(data):
    tokens, labels, queries = data
    knn = torch_gp.TorchKNNRegressor("TGCA", device="cpu")
    knn.train(ALPHA.decode(tokens), labels)
    preds = knn.fitness_from_tokens(queries)
    dists = (queries[:, None, :] != tokens[None, :, :]).sum(-1)
    expected = np.array([labels[np.argsort(d, kind="stable")[:5]].mean() for d in dists])
    np.testing.assert_allclose(preds, expected, atol=1e-6)


def test_knn_matches_sklearn_on_tie_free_queries(data):
    from sklearn.neighbors import KNeighborsRegressor

    tokens, labels, queries = data
    sk = KNeighborsRegressor().fit(_one_hot(tokens), labels)
    knn = torch_gp.TorchKNNRegressor("TGCA", device="cpu")
    knn.train(ALPHA.decode(tokens), labels)
    dists = np.sort((queries[:, None, :] != tokens[None, :, :]).sum(-1), axis=1)
    tie_free = dists[:, 4] < dists[:, 5]
    assert tie_free.any()
    np.testing.assert_allclose(knn.fitness_from_tokens(queries)[tie_free],
                               sk.predict(_one_hot(queries))[tie_free], atol=1e-6)


@pytest.mark.parametrize("k,rows", [(5, 40), (3, 40), (5, 3), (5, 200)])
def test_knn_equals_jax_bitwise(k, rows):
    """Fitted, and from JAX's padded state: equal bits, ties included."""
    rng = np.random.default_rng(k + rows)
    tokens = rng.integers(0, 4, size=(rows, 6)).astype(np.int32)  # many distance ties
    labels = rng.normal(size=rows) * 100
    queries = rng.integers(0, 4, size=(64, 6)).astype(np.int32)
    jm = jax_gp.JaxKNNRegressor("TGCA", n_neighbors=k)
    jm.train(ALPHA.decode(tokens), labels)
    want = jm.fitness_from_tokens(queries)
    knn = torch_gp.TorchKNNRegressor("TGCA", n_neighbors=k, device="cpu")
    knn.train(ALPHA.decode(tokens), labels)
    assert knn.name == jm.name == "nearest_neighbors"
    np.testing.assert_array_equal(knn.fitness_from_tokens(queries), want)
    knn._state = knn_state_from_jax(*jm._state)
    np.testing.assert_array_equal(knn.fitness_from_tokens(queries), want)


def test_knn_k_capped_by_train_size():
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 4, size=(3, 8)).astype(np.int32)
    labels = np.array([1.0, 2.0, 3.0])
    knn = torch_gp.TorchKNNRegressor("TGCA", device="cpu")
    knn.train(ALPHA.decode(tokens), labels)
    np.testing.assert_allclose(knn.fitness_from_tokens(tokens), labels.mean(), atol=1e-6)
    with pytest.raises(RuntimeError):
        torch_gp.TorchKNNRegressor("TGCA", device="cpu").fitness_from_tokens(tokens)
