"""The port's serial evaluators held against the JAX package's.

`efficiency` and `adaptivity` build their models through the caller's
factory, so with seeded models both packages' runs must agree row for row
(host runs reproduce each other, tests/test_torch_host_run.py).
`robustness` builds unseeded NoisyAbstractModels, as the reference does, so
it is held to its structure and to the device its models run on.
"""
import numpy as np
import pytest
import torch

import flexs_tpu
import flexs_tpu_torch

START = "TTGCAGCA"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel worker processes."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def _landscape(pkg):
    device = {"device": "cpu"} if pkg is flexs_tpu_torch else {}
    return pkg.landscapes.TFBinding(name="SIX6_REF_R1", **device)


def _adalead(pkg, model, rounds=2, batch=5, queries=20):
    return pkg.baselines.explorers.Adalead(
        model, rounds=rounds, sequences_batch_size=batch, model_queries_per_batch=queries,
        starting_sequence=START, alphabet=pkg.DNAA, seed=0,
    )


def _nam(pkg, landscape):
    device = {"device": "cpu"} if pkg is flexs_tpu_torch else {}
    return pkg.baselines.models.NoisyAbstractModel(landscape, 0.9, seed=0, **device)


def _assert_same_runs(got, want):
    assert [key for key, _ in got] == [key for key, _ in want]
    for (_, (df_t, _)), (_, (df_j, _)) in zip(got, want):
        assert df_t["sequence"].tolist() == df_j["sequence"].tolist()
        for col in ("round", "model_cost", "measurement_cost"):
            np.testing.assert_array_equal(df_t[col].to_numpy(), df_j[col].to_numpy())
        np.testing.assert_allclose(
            df_t["model_score"].to_numpy(), df_j["model_score"].to_numpy(), atol=1e-6
        )


def _efficiency(pkg):
    landscape = _landscape(pkg)
    return pkg.evaluate.efficiency(
        landscape,
        make_explorer=lambda batch, queries: _adalead(
            pkg, _nam(pkg, landscape), batch=batch, queries=queries
        ),
        budgets=[(3, 10), (5, 20)],
    )


def test_efficiency_equals_jax_row_for_row():
    _assert_same_runs(_efficiency(flexs_tpu_torch), _efficiency(flexs_tpu))


def _adaptivity(pkg):
    landscape = _landscape(pkg)
    seen = []

    def make(rounds, batch, queries):
        seen.append((rounds, batch, queries))
        return _adalead(pkg, _nam(pkg, landscape), rounds=rounds, batch=batch, queries=queries)

    results = pkg.evaluate.adaptivity(
        landscape, make, num_rounds=[1, 2], total_ground_truth_measurements=10,
        total_model_queries=40,
    )
    assert seen == [(1, 10, 40), (2, 5, 20)]
    return results


def test_adaptivity_equals_jax_row_for_row():
    _assert_same_runs(_adaptivity(flexs_tpu_torch), _adaptivity(flexs_tpu))


def test_robustness_builds_models_on_the_landscape_device():
    landscape = _landscape(flexs_tpu_torch)
    models = []

    def make(model, ss):
        models.append(model)
        return _adalead(flexs_tpu_torch, model)

    results = flexs_tpu_torch.evaluate.robustness(
        landscape, make, signal_strengths=[0.0, 1.0], verbose=False
    )
    assert [ss for ss, _ in results] == [0.0, 1.0]
    assert [m.name for m in models] == ["NAMb_ss0.0", "NAMb_ss1.0"]
    assert all(m.device == landscape.device for m in models)
    for _, (df, meta) in results:
        assert df["round"].max() == 2
        assert meta["model_name"].startswith("NAMb_ss")
    # Signal strength 1: the model's scores are the truth.
    df = results[1][1][0]
    proposed = df[df["round"] > 0]
    np.testing.assert_allclose(
        proposed["model_score"].to_numpy(), proposed["true_score"].to_numpy(), atol=1e-6
    )
