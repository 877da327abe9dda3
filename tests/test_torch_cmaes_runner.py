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


# The 3-CNN ensemble surrogate (the runner's default spec): the port's mean
# top against JAX's over the same seeds, at 3 rounds x 20 x 200 on
# SIX6_REF_R1 from STARTS[0].  The band is three standard errors of the
# difference of two 4-seed means, from each package's per-run spread over
# 96 seeds at this size (`test_surrogate_band_covers_the_seed_spread`).
SURROGATE_RUN = dict(rounds=3, sequences_batch_size=20, model_queries_per_batch=200,
                     maximize=True, model="surrogate")
SURROGATE_BAND = 0.17
SURROGATE_SPREAD_SEEDS = tuple(range(96))
# The full-size comparison: scripts/bench_surrogate.py:71-103's bench (10
# rounds x 100 x 2000 on SIX6_REF_R1 and VAX2_REF_R1 from STARTS[:2]) over
# seeds 0-7, 32 runs a package; the means must differ by less than twice
# the standard error of their difference.
PAPER_SURROGATE_RUN = dict(rounds=10, sequences_batch_size=100, model_queries_per_batch=2000,
                           maximize=True, model="surrogate")
PAPER_SURROGATE_LANDSCAPES = ("SIX6_REF_R1", "VAX2_REF_R1")
PAPER_SURROGATE_SEEDS = tuple(range(8))


def _surrogate_tops(name: str, starts, seeds, run: dict):
    """(port tops, JAX tops) of DeviceCMAESNAM with the 3-CNN surrogate, start-major."""
    from flexs_tpu.runtime.surrogate import SurrogateSpec as JaxSpec
    from flexs_tpu_torch.runtime.surrogate import SurrogateSpec

    land = flexs.landscapes.TFBinding(name=name, device="cpu")
    jax_land = flexs_tpu.landscapes.TFBinding(
        **flexs_tpu.landscapes.tf_binding.registry()[name]["params"])
    port, ref = [], []
    for start in starts:
        for seed in seeds:
            port.append(DeviceCMAESNAM(
                land, flexs.DNAA, starting_sequence=start, seed=seed, device="cpu",
                surrogate_spec=SurrogateSpec(ensemble_size=3), **run,
            ).run(verbose=False)[0]["true_score"].max())
            ref.append(jax_runtime.DeviceCMAESNAM(
                jax_land, flexs.DNAA, starting_sequence=start, seed=seed,
                surrogate_spec=JaxSpec(ensemble_size=3), **run,
            ).run(verbose=False)[0]["true_score"].max())
    return np.array(port), np.array(ref)


def test_surrogate_quality_matches_jax():
    port, ref = _surrogate_tops("SIX6_REF_R1", [START], SEEDS, SURROGATE_RUN)
    assert abs(port.mean() - ref.mean()) <= SURROGATE_BAND, (port, ref)


@pytest.mark.slow
def test_surrogate_band_covers_the_seed_spread():
    """SURROGATE_BAND is at least three standard errors of a 4-seed difference, and no gap."""
    port, ref = _surrogate_tops("SIX6_REF_R1", [START], SURROGATE_SPREAD_SEEDS, SURROGATE_RUN)
    se4 = np.sqrt((port.var(ddof=1) + ref.var(ddof=1)) / len(SEEDS))
    se = np.sqrt((port.var(ddof=1) + ref.var(ddof=1)) / len(SURROGATE_SPREAD_SEEDS))
    print(f"port mean {port.mean():.4f} sd {port.std(ddof=1):.4f}; "
          f"JAX mean {ref.mean():.4f} sd {ref.std(ddof=1):.4f}; 4-seed se {se4:.4f}")
    assert 3 * se4 <= SURROGATE_BAND + 0.005, se4
    assert abs(port.mean() - ref.mean()) < 2 * se, (port.mean(), ref.mean())


@pytest.mark.slow
def test_paper_surrogate_quality_matches_jax():
    """The 3-CNN CMA-ES bench over 32 runs a package: any gap is within seed spread."""
    port, ref = [], []
    for name in PAPER_SURROGATE_LANDSCAPES:
        p, r = _surrogate_tops(name, tf_binding.STARTS[:2], PAPER_SURROGATE_SEEDS,
                               PAPER_SURROGATE_RUN)
        port += list(p)
        ref += list(r)
    port, ref = np.array(port), np.array(ref)
    se = np.sqrt(port.var(ddof=1) / len(port) + ref.var(ddof=1) / len(ref))
    print(f"port mean {port.mean():.4f} sd {port.std(ddof=1):.4f}; "
          f"JAX mean {ref.mean():.4f} sd {ref.std(ddof=1):.4f}; se of the difference {se:.4f}")
    assert abs(port.mean() - ref.mean()) < 2 * se, (port, ref)
