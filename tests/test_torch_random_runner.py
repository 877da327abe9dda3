"""The port's fused Random runner on the CPU, against the JAX package's.

The runner draws from torch Generators, which cannot replay `jax.random`,
so it is held to the invariants of the JAX package's cases
(tests/test_ga_runner.py:68-120), to its cell-axis entry point (C = 3)
equalling three single runs bitwise, and to the JAX runner's mean top over
the same four seeds within a stated band.
"""
import numpy as np
import pytest
import torch

import flexs_tpu
import flexs_tpu.runtime as jax_runtime
import flexs_tpu_torch as flexs
from flexs_tpu_torch.landscapes import tf_binding
from flexs_tpu_torch.runtime import DeviceRandomNAM, random_runner
from flexs_tpu_torch.runtime.jit_runner import AdaleadConfig, cell_axis_oracle

START = tf_binding.STARTS[0]
SEEDS = (0, 1, 2, 3)
BAND = 0.15  # |port - JAX| of the mean top over SEEDS
RUN = dict(rounds=3, sequences_batch_size=5, model_queries_per_batch=30, batch=8)


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
    return DeviceRandomNAM(landscape, flexs.DNAA, starting_sequence=START, device="cpu",
                           **kw).run(verbose=False)


def _gen(seed):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return gen


def test_schema_and_round_structure(landscape):
    df, meta = _run(landscape)
    assert list(df.columns) == ["sequence", "model_score", "true_score", "round", "model_cost",
                                "measurement_cost"]
    assert df["round"].max() == 3
    assert df["sequence"].iloc[0] == START and np.isnan(df["model_score"].iloc[0])
    for r in range(1, 4):
        assert 0 < len(df[df["round"] == r]) <= 5
    assert meta["exp_name"] == "DeviceRandom_mu=1.0" and meta["model_name"] == "NAMb_ss0.9"


def test_no_reproposal_and_costs_budgeted(landscape):
    df, _ = _run(landscape)
    assert df["sequence"].is_unique
    per_round = df.groupby("round")["model_cost"].first().to_numpy()
    # A batch of 8 runs only while it fits in the 30-query budget.
    assert (np.diff(per_round) > 0).all() and (np.diff(per_round) <= 30).all()


def test_true_scores_match_both_landscapes(landscape, jax_landscape):
    df, _ = _run(landscape)
    seqs = df["sequence"].tolist()
    np.testing.assert_array_equal(df["true_score"].to_numpy(), landscape.get_fitness(seqs))
    np.testing.assert_allclose(df["true_score"].to_numpy(), jax_landscape.get_fitness(seqs),
                               atol=1e-6)


def test_non_elitist_proposals_and_elitist_dominates(landscape):
    """Uniform proposals (with replacement) score no higher than the top-B, at ss 1."""
    uniform, _ = _run(landscape, model_queries_per_batch=50, signal_strength=1.0, elitist=False)
    elitist, _ = _run(landscape, model_queries_per_batch=50, signal_strength=1.0)
    assert 0 < len(uniform[uniform["round"] == 1]) <= 5
    np.testing.assert_array_equal(uniform["true_score"].to_numpy(),
                                  landscape.get_fitness(uniform["sequence"].tolist()))
    first = [df[df["round"] == 1]["model_score"].mean() for df in (elitist, uniform)]
    assert first[0] >= first[1]


def test_perfect_model_costs(landscape):
    before = landscape.cost
    df, meta = _run(landscape, model="perfect")
    prop = df[df["round"] > 0]
    np.testing.assert_array_equal(prop["model_score"].to_numpy(), prop["true_score"].to_numpy())
    assert meta["model_name"].startswith("LandscapeAsModel=")
    assert landscape.cost - before == len(df)


def test_climbs(landscape):
    df, _ = _run(landscape, rounds=5, sequences_batch_size=20, model_queries_per_batch=200,
                 signal_strength=1.0)
    assert df["true_score"].max() > 0.9


def test_seed_determinism(landscape):
    a, _ = _run(landscape, seed=7)
    b, _ = _run(landscape, seed=7)
    assert a["sequence"].tolist() == b["sequence"].tolist()
    np.testing.assert_array_equal(a["model_score"].to_numpy()[1:], b["model_score"].to_numpy()[1:])


@pytest.mark.parametrize("elitist", [True, False])
def test_cells_equal_single_runs(landscape, elitist):
    """Three cells in lockstep (other starts, signal strengths, seeds) equal three single runs."""
    fn, params = landscape.device_fitness()
    cfg = AdaleadConfig(rounds=3, sequences_batch_size=5, model_queries_per_batch=30,
                        alphabet_size=4)
    starts = torch.as_tensor(flexs.Alphabet(flexs.DNAA).encode(tf_binding.STARTS[:3]))
    ss, seeds = [0.5, 0.9, 1.0], [3, 4, 5]
    cells = random_runner.run_random_nam_cells(
        cell_axis_oracle(fn), params, starts, cfg, ss, [_gen(s) for s in seeds], batch=8,
        elitist=elitist)
    for c in range(3):
        single = random_runner.run_random_nam(fn, params, starts[c], cfg, ss[c], _gen(seeds[c]),
                                              batch=8, elitist=elitist)
        for name, got, want in zip(single._fields, cells, single):
            assert torch.equal(got[c], want), (c, name)


@pytest.fixture(scope="module")
def mean_tops(landscape, jax_landscape):
    """(port, JAX) mean top over SEEDS at the JAX cases' size, elitist and not."""
    out = {}
    for elitist in (True, False):
        kw = dict(RUN, model_queries_per_batch=50, signal_strength=1.0, elitist=elitist)
        port = [_run(landscape, seed=s, **kw)[0]["true_score"].max() for s in SEEDS]
        ref = [jax_runtime.DeviceRandomNAM(jax_landscape, flexs.DNAA, starting_sequence=START,
                                           seed=s, **kw).run(verbose=False)[0]["true_score"].max()
               for s in SEEDS]
        out[elitist] = (np.mean(port), np.mean(ref))
    return out


@pytest.mark.parametrize("elitist", [True, False])
def test_quality_matches_jax(mean_tops, elitist):
    port, ref = mean_tops[elitist]
    assert abs(port - ref) <= BAND, (port, ref)


def test_default_device_without_card_raises(landscape):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceRandomNAM(landscape, flexs.DNAA, rounds=1, sequences_batch_size=5,
                        model_queries_per_batch=30, starting_sequence=START)
