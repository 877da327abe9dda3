"""AdaptiveEnsemble and the sklearn wrappers against the JAX package, and host runs.

The ensemble's split and weights are numpy on the host in both packages,
so members with equal predictions (k-NN is exact, tests/test_torch_gp.py)
give equal splits, weights and combined scores, and a seeded host Adalead
run over such an ensemble reproduces the JAX package's row for row.  The
sklearn wrappers call the same sklearn objects on the same features, so
their outputs are equal.  A host run over the 11 DynaPPO default members
(nets, linear models, GP, trees) is held to its invariants.
"""
import numpy as np
import pytest
import torch

import flexs_tpu
import flexs_tpu_torch
from flexs_tpu.baselines.models import adaptive_ensemble as jax_ae
from flexs_tpu.baselines.models import jax_gp, sklearn_models as jax_sk

from flexs_tpu_torch.alphabet import as_alphabet
from flexs_tpu_torch.baselines.models import adaptive_ensemble, sklearn_models, torch_gp

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
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 4, size=(40, 8))
    labels = (tokens == 1).sum(1) / 8 + 0.1 * rng.normal(size=40)
    queries = rng.integers(0, 4, size=(32, 8))
    return ALPHA.decode(tokens), labels, ALPHA.decode(queries)


def _knn_pair(k):
    return (jax_gp.JaxKNNRegressor("TGCA", n_neighbors=k),
            torch_gp.TorchKNNRegressor("TGCA", n_neighbors=k, device="cpu"))


def test_r2_weights_equal_jax():
    rng = np.random.default_rng(1)
    preds, labels = rng.normal(size=(4, 30)), rng.normal(size=30)
    np.testing.assert_array_equal(adaptive_ensemble.r2_weights(preds, labels),
                                  jax_ae.r2_weights(preds, labels))


@pytest.mark.parametrize("rows", [40, 8])
def test_split_weights_and_scores_equal_jax(data, rows):
    """>= 10 rows: a seeded holdout split and r^2 weights; < 10: all rows, weights kept."""
    seqs, labels, queries = data
    pairs = [_knn_pair(k) for k in (5, 3, 1)]
    jax_ens = jax_ae.AdaptiveEnsemble([j for j, _ in pairs], seed=4)
    ens = adaptive_ensemble.AdaptiveEnsemble([t for _, t in pairs], seed=4)
    assert ens.name == jax_ens.name == (
        "AdaptiveEns(nearest_neighbors|nearest_neighbors|nearest_neighbors)")
    for _ in range(2):  # the split generator advances alike
        jax_ens.train(seqs[:rows], labels[:rows])
        ens.train(seqs[:rows], labels[:rows])
        np.testing.assert_array_equal(ens.weights, jax_ens.weights)
        np.testing.assert_array_equal(ens.get_fitness(queries), jax_ens.get_fitness(queries))
    if rows < 10:
        np.testing.assert_array_equal(ens.weights, np.ones(3) / 3)
    else:
        assert not np.allclose(ens.weights, 1 / 3)


def test_custom_combine_and_adapt(data):
    seqs, labels, queries = data
    members = [_knn_pair(k)[1] for k in (5, 2)]
    ens = adaptive_ensemble.AdaptiveEnsemble(
        members, combine_with=lambda w, x: np.max(x, axis=1),
        adapt_weights_with=lambda p, y: np.array([0.25, 0.75]))
    ens.train(seqs, labels)
    np.testing.assert_array_equal(ens.weights, [0.25, 0.75])
    scores = np.stack([m.get_fitness(queries) for m in members], axis=1)
    np.testing.assert_array_equal(ens.get_fitness(queries), scores.max(axis=1))


@pytest.mark.parametrize("name,kwargs", [
    ("LinearRegression", {}), ("LogisticRegression", {"max_iter": 200}),
    ("RandomForest", {"n_estimators": 10, "random_state": 0}),
])
def test_sklearn_wrappers_equal_jax(data, name, kwargs):
    seqs, labels, queries = data
    if name == "LogisticRegression":
        labels = (labels > np.median(labels)).astype(int)
    jm, tm = getattr(jax_sk, name)("TGCA", **kwargs), getattr(sklearn_models, name)("TGCA", **kwargs)
    assert tm.name == jm.name
    jm.train(seqs, labels)
    tm.train(seqs, labels)
    np.testing.assert_array_equal(tm.get_fitness(queries), jm.get_fitness(queries))
    np.testing.assert_array_equal(tm.fitness_from_tokens(ALPHA.encode(queries)),
                                  jm.fitness_from_tokens(ALPHA.encode(queries)))


def test_sklearn_classifier_wrapper_uses_predict_proba(data):
    from sklearn.linear_model import LogisticRegression

    seqs, labels, queries = data
    y = (labels > np.median(labels)).astype(int)

    class Classifier(sklearn_models.SklearnClassifier):
        pass

    class JaxClassifier(jax_sk.SklearnClassifier):
        pass

    tm = Classifier(LogisticRegression(), "TGCA", "classifier")
    jm = JaxClassifier(LogisticRegression(), "TGCA", "classifier")
    tm.train(seqs, y)
    jm.train(seqs, y)
    got = tm.get_fitness(queries)
    assert ((got > 0) & (got < 1)).all()
    np.testing.assert_array_equal(got, jm.get_fitness(queries))


PROBLEM = flexs_tpu.landscapes.rna.registry()["L14_RNA1"]


def _host_run(pkg, models, **device):
    landscape = pkg.landscapes.RNABinding(**PROBLEM["params"], **device)
    ensemble = pkg.baselines.models.AdaptiveEnsemble(models, seed=0)
    explorer = pkg.baselines.explorers.Adalead(
        ensemble, rounds=3, sequences_batch_size=10, model_queries_per_batch=60,
        starting_sequence=PROBLEM["starts"][1], alphabet=pkg.RNAA, seed=0,
    )
    df, meta = explorer.run(landscape, verbose=False)
    return df, meta, ensemble, landscape.cost


def test_host_run_over_exact_members_reproduces_jax_row_for_row():
    rna = flexs_tpu.RNAA
    df_j, meta_j, ens_j, cost_j = _host_run(
        flexs_tpu, [jax_gp.JaxKNNRegressor(rna), jax_gp.JaxKNNRegressor(rna, n_neighbors=2)])
    df_t, meta_t, ens_t, cost_t = _host_run(
        flexs_tpu_torch, [torch_gp.TorchKNNRegressor(rna, device="cpu"),
                          torch_gp.TorchKNNRegressor(rna, n_neighbors=2, device="cpu")],
        device="cpu")
    assert len(df_t) == len(df_j) == 1 + 3 * 9
    assert df_t["sequence"].tolist() == df_j["sequence"].tolist()
    for col in ("round", "model_cost", "measurement_cost"):
        np.testing.assert_array_equal(df_t[col].to_numpy(), df_j[col].to_numpy())
    np.testing.assert_array_equal(df_t["model_score"].to_numpy(), df_j["model_score"].to_numpy())
    np.testing.assert_allclose(df_t["true_score"].to_numpy(), df_j["true_score"].to_numpy(),
                               atol=1e-6)
    np.testing.assert_array_equal(ens_t.weights, ens_j.weights)
    assert cost_t == cost_j
    meta_t.pop("run_id"), meta_j.pop("run_id")
    assert meta_t == meta_j


def _default_members(alphabet, seq_len):
    """The port's counterparts of the JAX package's `tpu_native_default_models`."""
    from chip_smoke import default_members

    return default_members(flexs_tpu_torch, seq_len, alphabet, device="cpu")


def test_default_members_mirror_jax():
    from flexs_tpu.baselines.explorers.dyna_ppo import tpu_native_default_models

    ports = _default_members(flexs_tpu.RNAA, 14)
    jax_members = tpu_native_default_models(14, flexs_tpu.RNAA)
    assert [m.name for m in ports] == [m.name for m in jax_members]
    assert not any(isinstance(m, sklearn_models.SklearnModel) for m in ports)


def test_host_run_over_the_default_members_holds_its_invariants():
    members = _default_members(flexs_tpu_torch.RNAA, 14)
    df, meta, ens, cost = _host_run(flexs_tpu_torch, members, device="cpu")
    assert meta["model_name"] == ens.name and ens.name.count("|") == 10
    assert len(df) == cost == 1 + 3 * 9 and df["sequence"].is_unique
    assert df["true_score"].max() >= df["true_score"].iloc[0]
    assert np.isfinite(df["model_score"].to_numpy()[1:]).all()
    assert (df[df["round"] > 0]["model_cost"] > 0).all()
    assert np.isfinite(ens.weights).all() and abs(ens.weights.sum() - 1) < 1e-9
    assert not np.allclose(ens.weights, 1 / 11)  # reweighted from a holdout
