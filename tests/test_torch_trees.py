"""The port's tree regressors against the JAX package and sklearn.

Tolerances: trees carried across (`convert.trees_from_jax`) predict equal
to JAX's bitwise; fitted trees on a dataset without near-tied splits (300
rows of continuous labels, depth <= 4, so every node holds many rows): the
same split features and leaves within 1e-5; fitted at depth 10 and on
tests/test_jax_trees.py's data by agreement, at that file's bands (the
forest draws its bootstrap from a torch generator, which cannot replay
`jax.random`; deep nodes hold few rows, where split gains tie to the last
bit and f32 sums in another order can pick the other split).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import sklearn.ensemble
import sklearn.tree
import torch

from flexs_tpu.baselines.models import jax_trees

from flexs_tpu_torch.alphabet import as_alphabet
from flexs_tpu_torch.baselines.models import torch_trees
from flexs_tpu_torch.baselines.models.convert import trees_from_jax

ALPHABET = "TGCA"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel worker processes."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


@pytest.fixture(scope="module")
def data():
    """tests/test_jax_trees.py's data."""
    rng = np.random.default_rng(0)
    L, A, n = 8, 4, 200
    tokens = rng.integers(0, A, (n, L))
    seqs = ["".join(ALPHABET[t] for t in row) for row in tokens]
    y = (
        np.sum(tokens == 2, 1) * 0.3
        + (tokens[:, 0] == 1) * 0.5
        + (tokens[:, 3] == 0) * (tokens[:, 5] == 2) * 0.7
        + rng.normal(0, 0.05, n)
    )
    te_tokens = rng.integers(0, A, (100, L))
    te_seqs = ["".join(ALPHABET[t] for t in row) for row in te_tokens]
    X = np.eye(A)[tokens].reshape(n, -1)
    Xte = np.eye(A)[te_tokens].reshape(100, -1)
    return seqs, y, te_seqs, X, Xte


PAIRS = {
    "forest": (jax_trees.JaxRandomForest, torch_trees.TorchRandomForest),
    "boosting": (jax_trees.JaxGradientBoosting, torch_trees.TorchGradientBoosting),
    "extra_tree": (jax_trees.JaxExtraTree, torch_trees.TorchExtraTree),
}


@pytest.mark.parametrize("port_cls,sk_model,min_corr", [
    (torch_trees.TorchGradientBoosting, sklearn.ensemble.GradientBoostingRegressor(), 0.99),
    (torch_trees.TorchRandomForest, sklearn.ensemble.RandomForestRegressor(random_state=0), 0.95),
    (torch_trees.TorchExtraTree, sklearn.tree.ExtraTreeRegressor(random_state=0), 0.9),
])
def test_member_agreement_vs_sklearn(data, port_cls, sk_model, min_corr):
    seqs, y, te_seqs, X, Xte = data
    model = port_cls(ALPHABET, device="cpu")
    model.train(seqs, y)
    sk_model.fit(X, y)
    corr = np.corrcoef(model.get_fitness(te_seqs), sk_model.predict(Xte))[0, 1]
    assert corr > min_corr, (model.name, corr)


@pytest.mark.parametrize("kind", sorted(PAIRS))
def test_carried_trees_predict_bitwise_as_jax(data, kind):
    seqs, y, te_seqs, _, _ = data
    jm = PAIRS[kind][0](ALPHABET)
    jm.train(seqs, y)
    model = PAIRS[kind][1](ALPHABET, device="cpu")
    state = [np.asarray(a) for a in jm._state]
    model._state = trees_from_jax(*state[1:], init=state[0]) if kind == "boosting" else (
        trees_from_jax(*state))
    assert model.name == jm.name
    np.testing.assert_array_equal(model.get_fitness(te_seqs), jm.get_fitness(te_seqs))


@pytest.mark.parametrize("trees,depth", [(1, 3), (7, 3), (20, 2), (33, 4), (65, 2), (100, 10)])
def test_tree_sums_follow_xla_order(trees, depth):
    """Random heaps: the forest mean and the boosted sum equal JAX's to the bit.

    (From 21 to 32 trees XLA sums in yet another order, which the port does
    not reproduce; the models' defaults are 100 trees.)"""
    rng = np.random.default_rng(trees)
    feats = rng.integers(0, 32, (trees, 2 ** depth - 1))
    leaves = (rng.normal(size=(trees, 2 ** depth))
              * rng.uniform(0.1, 100, size=(trees, 1))).astype(np.float32)
    x = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (128, 8))].reshape(128, -1)
    feat, leaf = trees_from_jax(feats, leaves)
    xt = torch.as_tensor(x)
    np.testing.assert_array_equal(
        torch_trees.predict_forest(feat, leaf, xt, depth).numpy(),
        np.asarray(jax_trees.predict_forest(jnp.asarray(feats, jnp.int32), jnp.asarray(leaves),
                                            jnp.asarray(x), depth)))
    np.testing.assert_array_equal(
        torch_trees.predict_boosted(torch.tensor(0.3), feat, leaf, xt, depth, 0.1).numpy(),
        np.asarray(jax_trees.predict_boosted(jnp.float32(0.3), jnp.asarray(feats, jnp.int32),
                                             jnp.asarray(leaves), jnp.asarray(x), depth, 0.1)))


@pytest.fixture(scope="module")
def tie_free():
    """300 rows, continuous labels: no two splits of a node at depth <= 4 tie."""
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 4, (300, 8))
    y = rng.normal(size=300).astype(np.float32)
    return np.eye(4, dtype=np.float32)[tokens].reshape(300, -1), y


@pytest.mark.parametrize("depth", [3, 4])
def test_fitted_tree_equals_jax_without_ties(tie_free, depth):
    x, y = tie_free
    w = np.ones(len(y), np.float32)
    feat_j, leaf_j = jax_trees._jit_grow(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w), depth)
    feat, leaf = torch_trees.grow_trees(torch.as_tensor(x), torch.as_tensor(y)[None],
                                        torch.as_tensor(w)[None], depth)
    np.testing.assert_array_equal(feat[0].numpy(), np.asarray(feat_j))
    np.testing.assert_allclose(leaf[0].numpy(), np.asarray(leaf_j), atol=1e-5)


def test_fitted_boosting_equals_jax_without_ties(tie_free):
    x, y = tie_free
    w = np.ones(len(y), np.float32)
    init_j, feats_j, leaves_j = jax_trees.fit_boosted(jnp.asarray(x), jnp.asarray(y),
                                                      jnp.asarray(w), 100, 3, 0.1)
    init, feats, leaves = torch_trees.fit_boosted(torch.as_tensor(x), torch.as_tensor(y),
                                                  torch.as_tensor(w), 100, 3, 0.1)
    np.testing.assert_array_equal(feats.numpy(), np.asarray(feats_j))
    np.testing.assert_allclose(leaves.numpy(), np.asarray(leaves_j), atol=1e-5)
    np.testing.assert_allclose(float(init), float(init_j), atol=1e-7)


@pytest.mark.parametrize("kind,min_corr", [("forest", 0.95), ("boosting", 0.99),
                                           ("extra_tree", 0.9)])
def test_fitted_models_agree_with_jax(data, kind, min_corr):
    seqs, y, te_seqs, _, _ = data
    jm, model = PAIRS[kind][0](ALPHABET), PAIRS[kind][1](ALPHABET, device="cpu")
    jm.train(seqs, y)
    model.train(seqs, y)
    corr = np.corrcoef(model.get_fitness(te_seqs), jm.get_fitness(te_seqs))[0, 1]
    assert corr > min_corr, (kind, corr)


def test_bootstrap_draws_live_rows_only():
    rng = np.random.default_rng(2)
    x = torch.as_tensor(np.eye(4, dtype=np.float32)[rng.integers(0, 4, (50, 6))].reshape(50, -1))
    y = torch.as_tensor(rng.normal(size=50).astype(np.float32))
    w = torch.ones(50)
    w[30:] = 0
    seen = {}

    def spy(x_, resid, counts, depth):
        seen["counts"] = counts
        return grow(x_, resid, counts, depth)

    grow = torch_trees.grow_trees
    torch_trees.grow_trees = spy
    try:
        torch_trees.fit_forest(x, y, w, torch.Generator().manual_seed(0), 8, 3)
    finally:
        torch_trees.grow_trees = grow
    counts = seen["counts"]
    assert counts.shape == (8, 50) and (counts.sum(dim=1) == 30).all()
    assert not counts[:, 30:].any()


def test_forest_is_seeded(data):
    seqs, y, te_seqs, _, _ = data
    preds = []
    for seed in (0, 0, 1):
        model = torch_trees.TorchRandomForest(ALPHABET, n_trees=10, seed=seed, device="cpu")
        model.train(seqs, y)
        preds.append(model.get_fitness(te_seqs))
    np.testing.assert_array_equal(preds[0], preds[1])
    assert not np.array_equal(preds[0], preds[2])


def test_token_fast_path_and_not_fitted(data):
    seqs, y, te_seqs, _, _ = data
    model = torch_trees.TorchGradientBoosting(ALPHABET, device="cpu")
    with pytest.raises(torch_trees.NotFittedError):
        model.get_fitness(te_seqs)
    model.train(seqs, y)
    tokens = as_alphabet(ALPHABET).encode(te_seqs)
    np.testing.assert_array_equal(model.get_fitness(te_seqs), model.fitness_from_tokens(tokens))
    with pytest.raises(torch_trees.NotFittedError):
        torch_trees.TorchRandomForest(ALPHABET, device="cpu").get_fitness(["TGCATGCA"])
