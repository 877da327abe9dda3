"""The port's fused Evo-BO runner on the CPU, against the JAX package's.

The runner draws from torch Generators, which cannot replay `jax.random`,
so it is held to the invariants of the JAX package's cases
(tests/test_bo_runner.py), to its cell-axis entry point (C = 3) equalling
three single runs bitwise, and to the JAX runner's mean top over the same
four seeds within a stated band.  The member statistics and the Gaussian
EI are held to their closed forms.
"""
import math

import numpy as np
import pytest
import torch

import flexs_tpu
import flexs_tpu.runtime as jax_runtime
import flexs_tpu_torch as flexs
from flexs_tpu_torch.landscapes import tf_binding
from flexs_tpu_torch.runtime import DeviceBONAM, SurrogateSpec, bo_runner
from flexs_tpu_torch.runtime.jit_runner import AdaleadConfig, cell_axis_oracle

START = tf_binding.STARTS[0]
SEEDS = (0, 1, 2, 3)
BAND = 0.15  # |port - JAX| of the mean top over SEEDS
RUN = dict(rounds=3, sequences_batch_size=6, model_queries_per_batch=60, num_chains=3)


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
    return DeviceBONAM(landscape, flexs.DNAA, starting_sequence=START, device="cpu",
                       **kw).run(verbose=False)


def _gen(seed):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return gen


def test_schema_and_costs(landscape):
    df, meta = _run(landscape)
    assert df["round"].max() == 3
    assert np.isnan(df["model_score"].iloc[0])
    assert meta["exp_name"] == "DeviceBO_method=EI"
    # 3 chains x 2 steps x 10 candidates = 60 screens a round.
    per_round = df.groupby("round")["model_cost"].max()
    assert per_round.loc[1] == 60 and per_round.loc[3] == 180
    for r in range(1, 4):
        assert 0 < len(df[df["round"] == r]) <= 6


def test_round_dedup(landscape):
    """Visited-state pools are deduplicated within a round (the `samples` dict keys)."""
    df, _ = _run(landscape)
    for r in range(1, 4):
        assert df[df["round"] == r]["sequence"].is_unique


def test_true_scores_match_both_landscapes(landscape, jax_landscape):
    df, _ = _run(landscape)
    seqs = df["sequence"].tolist()
    np.testing.assert_array_equal(df["true_score"].to_numpy(), landscape.get_fitness(seqs))
    np.testing.assert_allclose(df["true_score"].to_numpy(), jax_landscape.get_fitness(seqs),
                               atol=1e-6)


def test_climbs(landscape):
    df, _ = _run(landscape, rounds=5, sequences_batch_size=20, model_queries_per_batch=400,
                 num_chains=5, signal_strength=1.0)
    assert df["true_score"].max() > 0.9
    assert df["true_score"].max() > df["true_score"].iloc[0]


def test_perfect_model_costs(landscape):
    df, meta = _run(landscape, model="perfect")
    assert meta["model_name"].startswith("LandscapeAsModel=")
    # Perfect-model screens never charge the landscape; only the start and proposals do.
    assert df["measurement_cost"].max() == len(df)


def test_seed_determinism(landscape):
    a, _ = _run(landscape, seed=7)
    b, _ = _run(landscape, seed=7)
    assert a["sequence"].tolist() == b["sequence"].tolist()
    c, _ = _run(landscape, seed=8)
    assert a["sequence"].tolist() != c["sequence"].tolist()


def test_surrogate_ensemble_and_methods(landscape):
    """A trained 2-CNN ensemble under EI and UCB: screens charge the model, not the landscape."""
    spec = SurrogateSpec(ensemble_size=2, num_filters=4, hidden_size=8, epochs=2)
    for method in ("EI", "UCB"):
        df, meta = _run(landscape, rounds=2, model="surrogate", surrogate_spec=spec,
                        method=method)
        assert meta["model_name"].startswith("Ens(CNN")
        assert df.groupby("round")["model_cost"].max().loc[2] == 120
        assert df["measurement_cost"].max() == len(df)
    with pytest.raises(ValueError, match="method"):
        _run(landscape, method="Thompson")


def test_member_stats_and_gaussian_ei():
    rng = np.random.default_rng(0)
    members = rng.normal(size=(2, 3, 7)).astype(np.float32)
    mean, std = bo_runner.member_stats(torch.tensor(members))
    np.testing.assert_allclose(mean.numpy(), members.mean(axis=1), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(std.numpy(), members.std(axis=1), rtol=1e-5, atol=1e-6)
    mu, sigma, best = np.array([0.2, 0.5, 0.9]), np.array([0.1, 0.0, 0.3]), 0.4
    got = bo_runner.gaussian_ei(torch.tensor(mu), torch.tensor(sigma), best).numpy()
    want = []
    for m, s in zip(mu, sigma):
        if s == 0:
            want.append(max(m - best, 0.0))
            continue
        z = (m - best) / s
        want.append(s * (math.exp(-z * z / 2) / math.sqrt(2 * math.pi)
                         + z * 0.5 * (1 + math.erf(z / math.sqrt(2)))))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("model", ["nam", "perfect"])
def test_cells_equal_single_runs(landscape, model):
    """Three cells in lockstep (other starts, signal strengths, seeds) equal three single runs."""
    fn, params = landscape.device_fitness()
    cfg = AdaleadConfig(rounds=3, sequences_batch_size=6, model_queries_per_batch=60,
                        alphabet_size=4, perfect_model=model == "perfect")
    starts = torch.as_tensor(flexs.Alphabet(flexs.DNAA).encode(tf_binding.STARTS[:3]))
    ss, seeds = [0.5, 0.9, 1.0], [3, 4, 5]
    cells = bo_runner.run_bo_nam_cells(cell_axis_oracle(fn), params, starts, cfg, ss,
                                       [_gen(s) for s in seeds], num_chains=3)
    for c in range(3):
        single = bo_runner.run_bo_nam(fn, params, starts[c], cfg, ss[c], _gen(seeds[c]),
                                      num_chains=3)
        for name, got, want in zip(single._fields, cells, single):
            assert torch.equal(got[c], want), (c, name)


@pytest.fixture(scope="module")
def mean_tops(landscape, jax_landscape):
    """(port, JAX) mean top over SEEDS at the JAX cases' size, NAM at 0.9."""
    port = [_run(landscape, seed=s)[0]["true_score"].max() for s in SEEDS]
    ref = [jax_runtime.DeviceBONAM(
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
        DeviceBONAM(landscape, flexs.DNAA, starting_sequence=START, rounds=1,
                    sequences_batch_size=6, model_queries_per_batch=60)
