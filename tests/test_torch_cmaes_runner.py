"""The port's fused CMA-ES runner on the CPU, against the JAX package's.

The runner draws from torch Generators, which cannot replay `jax.random`,
so it is held to the invariants of the JAX package's cases
(tests/test_cmaes_runner.py), to its cell-axis entry point (C = 3)
equalling three single runs bitwise (one CMA-ES state and eigh per cell),
and to the JAX runner's mean top over the same four seeds within a stated
band.
"""
import numpy as np
import pytest
import torch

import flexs_tpu
import flexs_tpu.runtime as jax_runtime
import flexs_tpu_torch as flexs
from flexs_tpu_torch.landscapes import tf_binding
from flexs_tpu_torch.runtime import DeviceCMAESNAM, cmaes_runner
from flexs_tpu_torch.runtime.jit_runner import AdaleadConfig, cell_axis_oracle

START = tf_binding.STARTS[0]
SEEDS = (0, 1, 2, 3)
BAND = 0.15  # |port - JAX| of the mean top over SEEDS
RUN = dict(rounds=2, sequences_batch_size=5, model_queries_per_batch=32, population_size=8)


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
    kw = {**RUN, "signal_strength": 1.0, "seed": 0, **kw}
    return DeviceCMAESNAM(landscape, flexs.DNAA, starting_sequence=START, device="cpu",
                          **kw).run(verbose=False)


def _gen(seed):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return gen


def test_schema_and_rounds(landscape):
    df, meta = _run(landscape)
    assert df["round"].max() == 2
    assert np.isnan(df["model_score"].iloc[0])
    for r in range(1, 3):
        rows = df[df["round"] == r]
        assert 0 < len(rows) <= 5 and rows["sequence"].is_unique
    assert meta["exp_name"] == "DeviceCMAES_popsize8"


def test_budget_respected(landscape):
    df, _ = _run(landscape, rounds=1)
    # One round: model cost <= budget (+ at most one extra population).
    assert int(df["model_cost"].iloc[-1]) <= 32 + 8


def test_max_iter_bounds_generations(landscape):
    """With max_iter 1, a round pays at most one population."""
    df, _ = _run(landscape, rounds=2, max_iter=1)
    assert (np.diff(df.groupby("round")["model_cost"].first().to_numpy()) <= 8).all()


def test_true_scores_match_both_landscapes(landscape, jax_landscape):
    df, _ = _run(landscape)
    seqs = df["sequence"].tolist()
    np.testing.assert_array_equal(df["true_score"].to_numpy(), landscape.get_fitness(seqs))
    np.testing.assert_allclose(df["true_score"].to_numpy(), jax_landscape.get_fitness(seqs),
                               atol=1e-6)


def test_maximize_climbs(landscape):
    df, _ = _run(landscape, rounds=4, sequences_batch_size=20, model_queries_per_batch=200,
                 population_size=16, maximize=True)
    assert df["true_score"].max() > 0.9


def test_seed_determinism(landscape):
    a, _ = _run(landscape, seed=5)
    b, _ = _run(landscape, seed=5)
    assert a["sequence"].tolist() == b["sequence"].tolist()


@pytest.mark.parametrize("maximize", [False, True])
def test_cells_equal_single_runs(landscape, maximize):
    """Three cells in lockstep (other starts, signal strengths, seeds) equal three single runs."""
    fn, params = landscape.device_fitness()
    cfg = AdaleadConfig(rounds=2, sequences_batch_size=5, model_queries_per_batch=40,
                        alphabet_size=4)
    kw = dict(population_size=8, maximize=maximize)
    starts = torch.as_tensor(flexs.Alphabet(flexs.DNAA).encode(tf_binding.STARTS[:3]))
    ss, seeds = [0.5, 0.9, 1.0], [3, 4, 5]
    cells = cmaes_runner.run_cmaes_nam_cells(cell_axis_oracle(fn), params, starts, cfg, ss,
                                             [_gen(s) for s in seeds], **kw)
    for c in range(3):
        single = cmaes_runner.run_cmaes_nam(fn, params, starts[c], cfg, ss[c], _gen(seeds[c]),
                                            **kw)
        for name, got, want in zip(single._fields, cells, single):
            assert torch.equal(got[c], want), (c, name)


@pytest.fixture(scope="module")
def mean_tops(landscape, jax_landscape):
    """(port, JAX) mean top over SEEDS at the JAX cases' size."""
    port = [_run(landscape, seed=s)[0]["true_score"].max() for s in SEEDS]
    ref = [jax_runtime.DeviceCMAESNAM(
        jax_landscape, flexs.DNAA, starting_sequence=START, signal_strength=1.0, seed=s,
        **RUN).run(verbose=False)[0]["true_score"].max() for s in SEEDS]
    return np.mean(port), np.mean(ref)


def test_quality_matches_jax(mean_tops):
    port, ref = mean_tops
    assert abs(port - ref) <= BAND, (port, ref)


def test_default_device_without_card_raises(landscape):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceCMAESNAM(landscape, flexs.DNAA, starting_sequence=START, **RUN)
