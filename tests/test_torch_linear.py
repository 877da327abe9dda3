"""The port's closed-form linear models against the JAX package and sklearn.

Same numpy-seeded data through both packages.  Tolerances: predictions
from a fit carried across (`convert.linear_state_from_jax`) 1e-6 (f32
products in another order); fits 1e-4 for ridge and Bayesian ridge (an
f64 eigh here, XLA's f32 eigh and SVD there; fitted values, never
coefficients, are compared), 3e-3 for Lasso (both FISTA runs stop short
of the optimum, as in tests/test_jax_gp.py); sklearn agreement at the JAX
tests' own tolerances.
"""
import numpy as np
import pytest
import torch

from flexs_tpu.baselines.models import jax_linear

from flexs_tpu_torch.alphabet import as_alphabet
from flexs_tpu_torch.baselines.models import torch_linear
from flexs_tpu_torch.baselines.models.convert import linear_state_from_jax

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
    """tests/test_jax_gp.py's data, with additive labels (its linear cases)."""
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 4, size=(40, 8)).astype(np.int32)
    rng.normal(size=40)
    queries = rng.integers(0, 4, size=(32, 8)).astype(np.int32)
    rng = np.random.default_rng(3)
    true_w = rng.normal(size=(8, 4))
    labels = true_w[np.arange(8), tokens].sum(-1) + 0.1 * rng.normal(size=len(tokens))
    return ALPHA.decode(tokens), labels, queries


def _one_hot(tokens):
    return np.eye(4)[tokens].reshape(len(tokens), -1)


MODELS = {
    "ridge": (lambda: jax_linear.JaxRidgeRegression("TGCA", name="linear_regression"),
              lambda: torch_linear.TorchRidgeRegression("TGCA", name="linear_regression",
                                                        device="cpu")),
    "bayesian_ridge": (lambda: jax_linear.JaxBayesianRidge("TGCA"),
                       lambda: torch_linear.TorchBayesianRidge("TGCA", device="cpu")),
    "lasso": (lambda: jax_linear.JaxLasso("TGCA", alpha=0.02),
              lambda: torch_linear.TorchLasso("TGCA", alpha=0.02, device="cpu")),
}


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_carried_fit_predicts_as_jax(data, kind):
    seqs, labels, queries = data
    jm = MODELS[kind][0]()
    jm.train(seqs, labels)
    tm = MODELS[kind][1]()
    intercept = None if kind == "ridge" else np.asarray(jm._intercept)
    tm._coef, tm._intercept = linear_state_from_jax(np.asarray(jm._coef), intercept)
    np.testing.assert_allclose(tm.fitness_from_tokens(queries), jm.get_fitness(ALPHA.decode(queries)),
                               atol=1e-6)


@pytest.mark.parametrize("kind,tolerance", [("ridge", 1e-4), ("bayesian_ridge", 1e-4),
                                            ("lasso", 3e-3)])
def test_fit_equals_jax(data, kind, tolerance):
    seqs, labels, queries = data
    jm, tm = MODELS[kind][0](), MODELS[kind][1]()
    jm.train(seqs, labels)
    tm.train(seqs, labels)
    np.testing.assert_allclose(tm.fitness_from_tokens(queries), jm.get_fitness(ALPHA.decode(queries)),
                               atol=tolerance)


def test_ridge_is_sklearn_linear_regression(data):
    from sklearn.linear_model import LinearRegression

    seqs, labels, queries = data
    tokens = ALPHA.encode(seqs)
    sk = LinearRegression().fit(_one_hot(tokens), labels)
    tm = torch_linear.TorchRidgeRegression("TGCA", device="cpu")
    tm.train(seqs, labels)
    np.testing.assert_allclose(tm.fitness_from_tokens(queries), sk.predict(_one_hot(queries)),
                               atol=1e-4)


def test_bayesian_ridge_matches_sklearn(data):
    from sklearn.linear_model import BayesianRidge

    seqs, labels, queries = data
    sk = BayesianRidge().fit(_one_hot(ALPHA.encode(seqs)), labels)
    br = torch_linear.TorchBayesianRidge("TGCA", device="cpu")
    br.train(seqs, labels)
    np.testing.assert_allclose(br.fitness_from_tokens(queries), sk.predict(_one_hot(queries)),
                               atol=1e-4)


def test_lasso_matches_sklearn(data):
    from sklearn.linear_model import Lasso

    seqs, labels, queries = data
    for alpha in (1.0, 0.02):
        sk = Lasso(alpha=alpha).fit(_one_hot(ALPHA.encode(seqs)), labels)
        la = torch_linear.TorchLasso("TGCA", alpha=alpha, device="cpu")
        la.train(seqs, labels)
        np.testing.assert_allclose(la.fitness_from_tokens(queries),
                                   sk.predict(_one_hot(queries)), atol=3e-3)
        if alpha == 0.02:
            # Soft-thresholding exercised: sparse but nonzero.
            coef = la._coef[:-1].abs()
            assert (coef > 1e-8).any() and (coef <= 1e-8).any()


def test_bayesian_ridge_stops_when_converged(data):
    """The host looks every 10 iterations; the fit equals the full 300-step scan's."""
    seqs, labels, _ = data
    x = torch_linear.features(torch.as_tensor(ALPHA.encode(seqs)), 4)
    y = torch.as_tensor(labels, dtype=torch.float32)
    early = torch_linear.fit_bayesian_ridge(x, y)
    check_every = torch_linear._BAYES_CHECK_EVERY
    try:
        torch_linear._BAYES_CHECK_EVERY = torch_linear.BAYES_MAX_ITERS + 1
        full = torch_linear.fit_bayesian_ridge(x, y)
    finally:
        torch_linear._BAYES_CHECK_EVERY = check_every
    for a, b in zip(early, full):
        assert torch.equal(a, b)


def test_names_string_api_and_guard(data):
    seqs, labels, queries = data
    for kind, (make_jax, make_port) in MODELS.items():
        tm = make_port()
        assert tm.name == make_jax().name
        with pytest.raises(RuntimeError):
            tm.get_fitness(seqs[:2])
        tm.train(seqs, labels)
        np.testing.assert_array_equal(tm.get_fitness(ALPHA.decode(queries)),
                                      tm.fitness_from_tokens(queries))
    assert torch_linear.TorchRidgeRegression("TGCA", alpha=0.5, device="cpu").name == (
        jax_linear.JaxRidgeRegression("TGCA", alpha=0.5).name)
