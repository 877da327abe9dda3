"""A seeded host Adalead + NoisyAbstractModel run reproduces the JAX
package's run row for row.

Both packages draw from numpy Generators seeded alike, in the same order,
and the port's oracle values are bit-equal to the JAX package's, so the
sequences, rounds and costs must be identical.
"""
import numpy as np
import pytest
import torch

import flexs_tpu
import flexs_tpu_torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel worker processes."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


PROBLEM = flexs_tpu.landscapes.rna.registry()["L14_RNA1"]


def _run(pkg, signal_strength, **device):
    landscape = pkg.landscapes.RNABinding(**PROBLEM["params"], **device)
    model = pkg.baselines.models.NoisyAbstractModel(
        landscape, signal_strength, seed=0, **device
    )
    explorer = pkg.baselines.explorers.Adalead(
        model, rounds=2, sequences_batch_size=10, model_queries_per_batch=60,
        starting_sequence=PROBLEM["starts"][1], alphabet=pkg.RNAA, seed=0,
    )
    df, meta = explorer.run(landscape, verbose=False)
    return df, meta, landscape.cost, model.cost


@pytest.mark.parametrize("signal_strength", [0.9, 0.5])
def test_host_run_reproduces_jax_row_for_row(signal_strength):
    df_t, meta_t, cost_t, mcost_t = _run(flexs_tpu_torch, signal_strength, device="cpu")
    df_j, meta_j, cost_j, mcost_j = _run(flexs_tpu, signal_strength)
    assert len(df_t) == len(df_j) == 1 + 2 * 9  # the reference's B-1 proposals
    assert df_t["sequence"].tolist() == df_j["sequence"].tolist()
    for col in ("round", "model_cost", "measurement_cost"):
        np.testing.assert_array_equal(df_t[col].to_numpy(), df_j[col].to_numpy())
    for col in ("true_score", "model_score"):
        np.testing.assert_allclose(
            df_t[col].to_numpy(), df_j[col].to_numpy(), atol=1e-6
        )
    assert (cost_t, mcost_t) == (cost_j, mcost_j)
    meta_t.pop("run_id"), meta_j.pop("run_id")
    assert meta_t == meta_j


def _run_tf_binding(pkg, **device):
    problem = pkg.landscapes.tf_binding.registry()["SIX6_REF_R1"]
    landscape = pkg.landscapes.TFBinding(**problem["params"], **device)
    model = pkg.baselines.models.NoisyAbstractModel(landscape, 0.9, seed=0, **device)
    explorer = pkg.baselines.explorers.Adalead(
        model, rounds=3, sequences_batch_size=20, model_queries_per_batch=200,
        starting_sequence=problem["starts"][0], alphabet=pkg.DNAA, seed=0,
    )
    df, meta = explorer.run(landscape, verbose=False)
    return df, meta, landscape.cost, model.cost


def test_host_run_reproduces_jax_row_for_row_on_tf_binding():
    """TF-Bind-8 SIX6_REF_R1, the JAX package's benchmark landscape."""
    df_t, meta_t, cost_t, mcost_t = _run_tf_binding(flexs_tpu_torch, device="cpu")
    df_j, meta_j, cost_j, mcost_j = _run_tf_binding(flexs_tpu)
    assert len(df_t) == len(df_j) == 1 + 3 * 19  # the reference's B-1 proposals
    assert df_t["sequence"].tolist() == df_j["sequence"].tolist()
    for col in ("round", "model_cost", "measurement_cost"):
        np.testing.assert_array_equal(df_t[col].to_numpy(), df_j[col].to_numpy())
    for col in ("true_score", "model_score"):
        np.testing.assert_allclose(
            df_t[col].to_numpy(), df_j[col].to_numpy(), atol=1e-6
        )
    assert (cost_t, mcost_t) == (cost_j, mcost_j)
    meta_t.pop("run_id"), meta_j.pop("run_id")
    assert meta_t == meta_j
