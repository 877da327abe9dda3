"""The port's fused GPR_BO runner on the CPU, against the JAX package's.

With a perfect model the run has no randomness that reaches its result
(Thompson's noise is 1e-12 * N(0, 1), below the scores' rounding), so it
must equal the JAX runner's row for row: the same sequences, scores and
costs.  Otherwise the runner draws from torch Generators, and is held to
the invariants of the JAX package's cases (tests/test_gpr_bo_runner.py),
to its cell-axis entry point (C = 3) equalling three single runs bitwise,
and to the JAX runner's mean top over the same four seeds within a band.
"""
import numpy as np
import pandas as pd
import pytest
import torch

import flexs_tpu
import flexs_tpu.runtime as jax_runtime
import flexs_tpu_torch as flexs
from flexs_tpu_torch.landscapes import tf_binding
from flexs_tpu_torch.runtime import DeviceGPRBONAM, SurrogateSpec, gpr_bo_runner
from flexs_tpu_torch.runtime.jit_runner import AdaleadConfig, cell_axis_oracle

START = tf_binding.STARTS[0]
SEEDS = (0, 1, 2, 3)
BAND = 0.15  # |port - JAX| of the mean top over SEEDS
RUN = dict(rounds=3, sequences_batch_size=6, model_queries_per_batch=60)
COLUMNS = ["sequence", "model_score", "true_score", "round", "model_cost", "measurement_cost"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel worker processes."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


@pytest.fixture(scope="module")
def landscape():
    return flexs.landscapes.TFBinding(name="SIX6_REF_R1", device="cpu")


@pytest.fixture(scope="module")
def jax_landscape():
    problem = flexs_tpu.landscapes.tf_binding.registry()["SIX6_REF_R1"]
    return flexs_tpu.landscapes.TFBinding(**problem["params"])


def _run(landscape, **kw):
    kw = {**RUN, "signal_strength": 0.9, "seed": 0, **kw}
    return DeviceGPRBONAM(landscape, flexs.DNAA, starting_sequence=START, device="cpu",
                          **kw).run(verbose=False)


def _gen(seed):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return gen


def test_schema_and_costs(landscape):
    df, meta = _run(landscape)
    assert df["round"].max() == 3
    assert np.isnan(df["model_score"].iloc[0])
    assert meta["exp_name"] == "DeviceGPR_BO_method=Thompson"
    # Unbudgeted by design: the model is charged the whole 4^8 space a round.
    per_round = df.groupby("round")["model_cost"].max()
    assert per_round.loc[1] == 4**8 and per_round.loc[3] == 3 * 4**8
    for r in range(1, 4):
        assert len(df[df["round"] == r]) == 6


def test_never_reproposes(landscape):
    """Measured points are masked out of the ranking: unique over the whole run."""
    df, _ = _run(landscape)
    assert df["sequence"].is_unique


def test_true_scores_match_both_landscapes(landscape, jax_landscape):
    df, _ = _run(landscape)
    seqs = df["sequence"].tolist()
    np.testing.assert_array_equal(df["true_score"].to_numpy(), landscape.get_fitness(seqs))
    np.testing.assert_allclose(df["true_score"].to_numpy(), jax_landscape.get_fitness(seqs),
                               atol=1e-6)


def test_perfect_model_equals_jax_row_for_row(landscape, jax_landscape):
    kw = dict(rounds=2, sequences_batch_size=6, model_queries_per_batch=60, model="perfect",
              seed=0)
    got, meta = _run(landscape, **kw)
    want, _ = jax_runtime.DeviceGPRBONAM(jax_landscape, flexs.DNAA, starting_sequence=START,
                                         **kw).run(verbose=False)
    assert meta["model_name"].startswith("LandscapeAsModel=")
    pd.testing.assert_frame_equal(got[COLUMNS], want[COLUMNS])


def test_perfect_model_is_global_topk(landscape):
    """Round 1 proposes the table's top 6 without the start, ties by space index."""
    df, _ = _run(landscape, model="perfect", rounds=1)
    table = landscape.table.numpy()
    start_idx = int(tf_binding.tokens_to_index(flexs.Alphabet(flexs.DNAA).encode_one(START)))
    order = np.argsort(-table, kind="stable")
    want = order[order != start_idx][:6]
    got = tf_binding.tokens_to_index(
        flexs.Alphabet(flexs.DNAA).encode(df[df["round"] == 1]["sequence"].tolist())).numpy()
    np.testing.assert_array_equal(got, want)


def test_nam_ranking_freezes_after_round_one(landscape):
    """Round 1 caches a prediction for every point: later rounds walk down the frozen ranking."""
    df, _ = _run(landscape, method="Greedy")
    mins = df.groupby("round")["model_score"].min()
    maxs = df.groupby("round")["model_score"].max()
    assert maxs.loc[2] <= mins.loc[1] + 1e-6
    assert maxs.loc[3] <= mins.loc[2] + 1e-6


@pytest.mark.parametrize("method", ["Greedy", "UCB"])
def test_methods_run(landscape, method):
    df, meta = _run(landscape, method=method, rounds=2)
    assert meta["exp_name"] == f"DeviceGPR_BO_method={method}"
    assert len(df) == 1 + 2 * 6 and df["sequence"].is_unique


def test_surrogate_ensemble(landscape):
    spec = SurrogateSpec(ensemble_size=2, num_filters=4, hidden_size=8, epochs=2)
    df, meta = _run(landscape, rounds=2, model="surrogate", surrogate_spec=spec)
    assert meta["model_name"].startswith("Ens(CNN")
    assert df["measurement_cost"].max() == len(df) and df["sequence"].is_unique


def test_seed_determinism(landscape):
    a, _ = _run(landscape, seed=3)
    b, _ = _run(landscape, seed=3)
    assert a["sequence"].tolist() == b["sequence"].tolist()


def test_rejects_huge_spaces_and_bad_methods():
    land = flexs.landscapes.RNABinding(**flexs.landscapes.rna.registry()["L14_RNA1"]["params"],
                                       device="cpu")
    start = flexs.landscapes.rna.registry()["L14_RNA1"]["starts"][1]
    with pytest.raises(ValueError, match="enumerates the whole space"):
        DeviceGPRBONAM(land, flexs.RNAA, starting_sequence=start, device="cpu", **RUN)
    with pytest.raises(ValueError, match="seq_proposal_method"):
        DeviceGPRBONAM(land, flexs.RNAA, starting_sequence=start, method="EI", device="cpu",
                       **RUN)


@pytest.mark.parametrize("model", ["nam", "perfect"])
def test_cells_equal_single_runs(landscape, model):
    """Three cells in lockstep (other starts, signal strengths, seeds) equal three single runs."""
    fn, params = landscape.device_fitness()
    cfg = AdaleadConfig(rounds=2, sequences_batch_size=6, model_queries_per_batch=60,
                        alphabet_size=4, perfect_model=model == "perfect")
    starts = torch.as_tensor(flexs.Alphabet(flexs.DNAA).encode(tf_binding.STARTS[:3]))
    ss, seeds = [0.5, 0.9, 1.0], [3, 4, 5]
    cells = gpr_bo_runner.run_gpr_bo_nam_cells(cell_axis_oracle(fn), params, starts, cfg, ss,
                                               [_gen(s) for s in seeds])
    for c in range(3):
        single = gpr_bo_runner.run_gpr_bo_nam(fn, params, starts[c], cfg, ss[c], _gen(seeds[c]))
        for name, got, want in zip(single._fields, cells, single):
            assert torch.equal(got[c], want), (c, name)


@pytest.fixture(scope="module")
def mean_tops(landscape, jax_landscape):
    """(port, JAX) mean top over SEEDS at the JAX cases' size, NAM at 0.9, Thompson."""
    port = [_run(landscape, seed=s)[0]["true_score"].max() for s in SEEDS]
    ref = [jax_runtime.DeviceGPRBONAM(
        jax_landscape, flexs.DNAA, starting_sequence=START, signal_strength=0.9, seed=s,
        **RUN).run(verbose=False)[0]["true_score"].max() for s in SEEDS]
    return np.mean(port), np.mean(ref)


def test_quality_matches_jax(mean_tops):
    port, ref = mean_tops
    assert abs(port - ref) <= BAND, (port, ref)


def test_default_device_without_card_raises(landscape):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceGPRBONAM(landscape, flexs.DNAA, starting_sequence=START, **RUN)
