"""The port's fused mutative DynaPPO runner on the CPU, against the JAX package's.

The runner draws from torch Generators, which cannot replay `jax.random`,
so it is held to the invariants of the JAX package's cases
(tests/test_dyna_ppo_mutative_runner.py), to its cell-axis entry point
(C = 3) equalling three single runs bitwise, to the JAX runner's mean top
over the same four seeds within a stated band, and to the annealed
experiment budget: round r (0-based) proposes at most B - ((R - r + 1) *
B) // (2 * R) sequences (`dyna_ppo_mutative_runner.py:633-638`, :670-679).
"""
import numpy as np
import pytest
import torch

import flexs_tpu
import flexs_tpu.runtime as jax_runtime
import flexs_tpu_torch as flexs
from flexs_tpu_torch.landscapes import tf_binding
from flexs_tpu_torch.runtime import (
    DeviceDynaPPOMutativeNAM,
    SurrogateSpec,
    dyna_ppo_mutative_runner,
)
from flexs_tpu_torch.runtime.jit_runner import AdaleadConfig, cell_axis_oracle

START = tf_binding.STARTS[0]
SEEDS = (0, 1, 2, 3)
BAND = 0.15  # |port - JAX| of the mean top over SEEDS
RUN = dict(rounds=2, sequences_batch_size=8, model_queries_per_batch=32, env_batch_size=4,
           episode_len=6, train_epochs=2)


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
    kw = {**RUN, "signal_strength": 0.9, "model": "perfect", "seed": 0, **kw}
    return DeviceDynaPPOMutativeNAM(landscape, flexs.DNAA, starting_sequence=START,
                                    device="cpu", **kw).run(verbose=False)


def _gen(seed):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return gen


def test_schema_and_annealed_budget(landscape):
    df, meta = _run(landscape)
    assert df["round"].max() == 2
    assert df["sequence"].is_unique
    assert meta["exp_name"] == "DeviceDynaPPOMutative_Agent_10_1"
    # B = 8: the experiment budget is 4 at round 1, then interpolates down.
    r1 = (df["round"] == 1).sum()
    r2 = (df["round"] == 2).sum()
    assert r1 <= 4
    assert r2 >= r1


def test_proposal_counts_obey_the_annealed_budget(landscape):
    """Round r proposes at most B - ((R - r + 1) B) // (2 R); here the pools fill it exactly."""
    R, B = 4, 12
    df, _ = _run(landscape, rounds=R, sequences_batch_size=B, model_queries_per_batch=120,
                 env_batch_size=8, model="nam", seed=2)
    want = [B - dyna_ppo_mutative_runner.experiment_budget(R, B, r) for r in range(R)]
    assert want == [B - ((R - r + 1) * B) // (2 * R) for r in range(R)] == [5, 6, 8, 9]
    got = [int((df["round"] == r + 1).sum()) for r in range(R)]
    assert got == want, got


def test_a_pool_smaller_than_the_batch_still_proposes():
    """A round whose model phase records fewer than B sequences (B = 100 of a 100-query budget).

    The proposals are the pool's top B, the unfilled ranks invalid, as
    JAX's top-k over its fixed-capacity pool gives them; the port's pool
    once returned fewer than B columns and the round raised.
    """
    land = flexs.landscapes.TFBinding(name="VAX2_REF_R1", device="cpu")
    df, _ = DeviceDynaPPOMutativeNAM(
        land, flexs.DNAA, rounds=2, sequences_batch_size=100, model_queries_per_batch=100,
        starting_sequence=START, model="perfect", seed=0, device="cpu").run(verbose=False)
    want = [100 - dyna_ppo_mutative_runner.experiment_budget(2, 100, r) for r in range(2)]
    got = [int((df["round"] == r + 1).sum()) for r in range(2)]
    assert 0 < got[0] and all(0 < g <= w for g, w in zip(got, want)), (got, want)
    assert df["sequence"].is_unique


@pytest.mark.parametrize("model", ["nam", "perfect"])
def test_truth_matches_both_landscapes(landscape, jax_landscape, model):
    df, _ = _run(landscape, model=model)
    seqs = df["sequence"].tolist()
    np.testing.assert_array_equal(df["true_score"].to_numpy(), landscape.get_fitness(seqs))
    np.testing.assert_allclose(df["true_score"].to_numpy(), jax_landscape.get_fitness(seqs),
                               atol=1e-6)


def test_density_metric_edit_runs(landscape):
    """density_metric='edit' (exact in-walk Levenshtein) keeps the contract."""
    df, _ = _run(landscape, density_metric="edit")
    assert df["round"].max() == 2
    assert df["sequence"].is_unique
    np.testing.assert_array_equal(df["true_score"].to_numpy(),
                                  landscape.get_fitness(df["sequence"].tolist()))
    a, _ = _run(landscape, density_metric="edit", seed=5)
    b, _ = _run(landscape, density_metric="edit", seed=5)
    assert a["sequence"].tolist() == b["sequence"].tolist()


def test_mutative_climbs_with_budget(landscape):
    df, _ = _run(landscape, rounds=3, sequences_batch_size=16, model_queries_per_batch=64,
                 episode_len=8, signal_strength=1.0)
    assert df["true_score"].max() > 0.7


def test_seed_determinism(landscape):
    a, _ = _run(landscape, seed=4)
    b, _ = _run(landscape, seed=4)
    assert a["sequence"].tolist() == b["sequence"].tolist()
    c, _ = _run(landscape, seed=6)
    assert a["sequence"].tolist() != c["sequence"].tolist()


def test_nam_mode_runs(landscape):
    df, _ = _run(landscape, model="nam", signal_strength=0.9)
    assert df["true_score"].max() >= df["true_score"].iloc[0] - 1e-6


@pytest.mark.parametrize("density_metric", ["hamming", "edit"])
def test_cells_equal_single_runs(landscape, density_metric):
    """Three cells in lockstep (other starts, signal strengths, seeds) equal three single runs.

    Cells run different numbers of batches a phase, so the check covers a
    finished cell changing nothing and drawing nothing.
    """
    fn, params = landscape.device_fitness()
    cfg = AdaleadConfig(rounds=2, sequences_batch_size=8, model_queries_per_batch=32,
                        alphabet_size=4)
    kw = dict(env_batch_size=4, episode_len=6, train_epochs=2, density_metric=density_metric)
    starts = torch.as_tensor(flexs.Alphabet(flexs.DNAA).encode(tf_binding.STARTS[:3]))
    ss, seeds = [0.5, 0.9, 1.0], [3, 4, 5]
    cells = dyna_ppo_mutative_runner.run_dyna_ppo_mutative_nam_cells(
        cell_axis_oracle(fn), params, starts, cfg, ss, [_gen(s) for s in seeds], **kw)
    for c in range(3):
        single = dyna_ppo_mutative_runner.run_dyna_ppo_mutative_nam(
            fn, params, starts[c], cfg, ss[c], _gen(seeds[c]), **kw)
        for name, got, want in zip(single._fields, cells, single):
            assert torch.equal(got[c], want), (c, name)


@pytest.fixture(scope="module")
def mean_tops(landscape, jax_landscape):
    """(port, JAX) mean top over SEEDS at the JAX cases' size, a perfect model."""
    port = [_run(landscape, seed=s)[0]["true_score"].max() for s in SEEDS]
    ref = [jax_runtime.DeviceDynaPPOMutativeNAM(
        jax_landscape, flexs.DNAA, starting_sequence=START, model="perfect", seed=s,
        **RUN).run(verbose=False)[0]["true_score"].max() for s in SEEDS]
    return np.mean(port), np.mean(ref)


def test_quality_matches_jax(mean_tops):
    port, ref = mean_tops
    assert abs(port - ref) <= BAND, (port, ref)


def test_surrogate_raises(landscape):
    """A trained surrogate does not apply (the JAX package's ValueErrors)."""
    with pytest.raises(ValueError, match="model must be 'nam' or 'perfect'"):
        _run(landscape, model="surrogate")
    fn, params = landscape.device_fitness()
    cfg = AdaleadConfig(rounds=1, sequences_batch_size=8, model_queries_per_batch=32,
                        alphabet_size=4, surrogate=SurrogateSpec())
    with pytest.raises(ValueError, match="model='surrogate' does not apply"):
        dyna_ppo_mutative_runner.run_dyna_ppo_mutative_nam(
            fn, params, torch.as_tensor([0] * 8), cfg, 1.0, _gen(0))


def test_mutative_in_generic_sweep(landscape):
    from flexs_tpu_torch.parallel import run_landscape_robustness_sweep

    kw = {"env_batch_size": 4, "episode_len": 6, "train_epochs": 2}
    df = run_landscape_robustness_sweep(
        [landscape], flexs.DNAA, starts=[START], signal_strengths=[1.0], seeds=[0], rounds=2,
        sequences_batch_size=8, model_queries_per_batch=32, algorithm="dynappo_mutative",
        algorithm_kwargs=kw, device="cpu")
    single, _ = _run(landscape, model="nam", signal_strength=1.0)
    assert len(df) == 1
    assert df["max_fitness"].iloc[0] >= df["start_fitness"].iloc[0]
    assert df["max_fitness"].iloc[0] == single["true_score"].max()


def test_default_device_without_card_raises(landscape):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceDynaPPOMutativeNAM(landscape, flexs.DNAA, starting_sequence=START, **RUN)
