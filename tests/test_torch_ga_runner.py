"""The port's fused GeneticAlgorithm runner on the CPU, against the JAX package's.

The runner draws from torch Generators, which cannot replay `jax.random`,
so it is held to the invariants of the JAX package's cases
(tests/test_ga_runner.py), to its cell-axis entry point (C = 3) equalling
three single runs bitwise, and to the JAX runner's mean top over the same
four seeds within a stated band.
"""
import json

import numpy as np
import pytest
import torch

import flexs_tpu
import flexs_tpu.runtime as jax_runtime
import flexs_tpu_torch as flexs
from flexs_tpu_torch.landscapes import tf_binding
from flexs_tpu_torch.runtime import DeviceGeneticAlgorithmNAM, ga_runner
from flexs_tpu_torch.runtime.jit_runner import AdaleadConfig, cell_axis_oracle

START = tf_binding.STARTS[0]
SEEDS = (0, 1, 2, 3)
BAND = 0.15  # |port - JAX| of the mean top over SEEDS
GA = dict(population_size=10, children_proportion=0.5, parent_selection_proportion=0.5,
          beta=0.05)
RUN = dict(rounds=3, sequences_batch_size=5, model_queries_per_batch=30)
STRATEGIES = ["wright-fisher", "top-proportion"]


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


def _run(landscape, strategy="wright-fisher", **kw):
    kw = {**RUN, **GA, "signal_strength": 0.9, "seed": 0, **kw}
    return DeviceGeneticAlgorithmNAM(
        landscape, flexs.DNAA, starting_sequence=START, parent_selection_strategy=strategy,
        device="cpu", **kw,
    ).run(verbose=False)


def _gen(seed):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return gen


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_schema_and_dedup(landscape, strategy):
    df, meta = _run(landscape, strategy)
    assert df["round"].max() == 3
    assert df["sequence"].is_unique
    assert np.isnan(df["model_score"].iloc[0])
    for r in range(1, 4):
        assert 0 < len(df[df["round"] == r]) <= 5
    assert meta["exp_name"] == f"DeviceGeneticAlgorithm_pop_size=10_parents={strategy}"


def test_costs_budgeted(landscape):
    df, _ = _run(landscape)
    per_round = np.diff(df.groupby("round")["model_cost"].first().to_numpy())
    # Generations run while cost + population < budget; each charges <= 5 children.
    assert (per_round > 0).all() and (per_round <= 30 - 10 + 5).all()


def test_true_scores_match_both_landscapes(landscape, jax_landscape):
    df, _ = _run(landscape)
    seqs = df["sequence"].tolist()
    np.testing.assert_array_equal(df["true_score"].to_numpy(), landscape.get_fitness(seqs))
    np.testing.assert_allclose(df["true_score"].to_numpy(), jax_landscape.get_fitness(seqs),
                               atol=1e-6)


def test_climbs(landscape):
    df, _ = _run(landscape, rounds=5, sequences_batch_size=50, model_queries_per_batch=500,
                 signal_strength=1.0)
    assert df["true_score"].max() > 0.9


def test_seed_determinism(landscape):
    a, _ = _run(landscape, seed=3)
    b, _ = _run(landscape, seed=3)
    assert a["sequence"].tolist() == b["sequence"].tolist()
    c, _ = _run(landscape, seed=4)
    assert a["sequence"].tolist() != c["sequence"].tolist()


def test_log_file_and_bad_strategy(landscape, tmp_path):
    log = tmp_path / "ga.csv"
    df, _ = _run(landscape, rounds=2, log_file=str(log))
    lines = log.read_text().splitlines()
    assert json.loads(lines[0])["exp_name"].startswith("DeviceGeneticAlgorithm")
    assert len(lines) == 2 + len(df)
    with pytest.raises(ValueError, match="parent_selection_strategy"):
        _run(landscape, strategy="roulette")


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_cells_equal_single_runs(landscape, strategy):
    """Three cells in lockstep (other starts, signal strengths, seeds) equal three single runs."""
    fn, params = landscape.device_fitness()
    cfg = AdaleadConfig(**RUN, alphabet_size=4)
    kw = dict(GA, parent_selection_strategy=strategy)
    starts = torch.as_tensor(flexs.Alphabet(flexs.DNAA).encode(tf_binding.STARTS[:3]))
    ss, seeds = [0.5, 0.9, 1.0], [3, 4, 5]
    cells = ga_runner.run_ga_nam_cells(cell_axis_oracle(fn), params, starts, cfg, ss,
                                       [_gen(s) for s in seeds], **kw)
    for c in range(3):
        single = ga_runner.run_ga_nam(fn, params, starts[c], cfg, ss[c], _gen(seeds[c]), **kw)
        for name, got, want in zip(single._fields, cells, single):
            assert torch.equal(got[c], want), (c, name)


@pytest.fixture(scope="module")
def mean_tops(landscape, jax_landscape):
    """(port, JAX) mean top over SEEDS at the JAX cases' size, NAM at 0.9."""
    port = [_run(landscape, seed=s)[0]["true_score"].max() for s in SEEDS]
    ref = [jax_runtime.DeviceGeneticAlgorithmNAM(
        jax_landscape, flexs.DNAA, starting_sequence=START, signal_strength=0.9, seed=s,
        **RUN, **GA).run(verbose=False)[0]["true_score"].max() for s in SEEDS]
    return np.mean(port), np.mean(ref)


def test_quality_matches_jax(mean_tops):
    port, ref = mean_tops
    assert abs(port - ref) <= BAND, (port, ref)


def test_default_device_without_card_raises(landscape):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceGeneticAlgorithmNAM(landscape, flexs.DNAA, starting_sequence=START, **RUN)
