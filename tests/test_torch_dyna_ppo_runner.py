"""The port's fused constructive DynaPPO runner on the CPU, against the JAX package's.

The runner draws from torch Generators, which cannot replay `jax.random`,
so it is held to the invariants of the JAX package's cases
(tests/test_dyna_ppo_runner.py), to its cell-axis entry point (C = 3)
equalling three single runs bitwise, to the JAX runner's mean top over the
same four seeds within a stated band, and to the JAX runner's static
schedule: a perfect-model run charges the same model cost each round.  The
densities are held to the JAX runner's: `_edit_density` (the block-shift
pair and the dead-row mask of tests/test_dyna_ppo_runner.py included) and
the Hamming density of `dyna_ppo_runner.py:231-238`, their distances
exactly and the fitness-weighted sums within 1e-6 relative (the two
packages' dot products add in different orders: one ulp apart).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexs_tpu
import flexs_tpu.runtime as jax_runtime
import flexs_tpu_torch as flexs
from flexs_tpu.ops import packed_hamming as jax_packed
from flexs_tpu.runtime import dyna_ppo_runner as jax_dyna
from flexs_tpu.runtime.jit_runner import _dists_to_cache
from flexs_tpu_torch.landscapes import tf_binding
from flexs_tpu_torch.ops import packed_hamming
from flexs_tpu_torch.runtime import DeviceDynaPPONAM, SurrogateSpec, dyna_ppo_runner
from flexs_tpu_torch.runtime.jit_runner import AdaleadConfig, cell_axis_oracle

START = tf_binding.STARTS[0]
SEEDS = (0, 1, 2, 3)
BAND = 0.15  # |port - JAX| of the mean top over SEEDS
RUN = dict(rounds=2, sequences_batch_size=8, model_queries_per_batch=32, env_batch_size=8)
DENSITY_RTOL = 1e-6


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
    return DeviceDynaPPONAM(landscape, flexs.DNAA, starting_sequence=START, device="cpu",
                            **kw).run(verbose=False)


def _gen(seed):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return gen


def test_schema_and_costs(landscape):
    df, meta = _run(landscape)
    assert df["round"].max() == 2
    assert df["sequence"].is_unique
    # Model phases spend exactly ceil(budget / E) * E model queries a round.
    assert df["model_cost"].max() == 2 * 32
    assert meta["exp_name"] == "DeviceDynaPPO_Agent_10_1"


@pytest.mark.parametrize("model", ["nam", "perfect"])
def test_truth_matches_both_landscapes(landscape, jax_landscape, model):
    df, _ = _run(landscape, model=model)
    seqs = df["sequence"].tolist()
    np.testing.assert_array_equal(df["true_score"].to_numpy(), landscape.get_fitness(seqs))
    np.testing.assert_allclose(df["true_score"].to_numpy(), jax_landscape.get_fitness(seqs),
                               atol=1e-6)


def test_dynappo_climbs_with_budget(landscape):
    df, _ = _run(landscape, rounds=3, sequences_batch_size=16, model_queries_per_batch=64,
                 signal_strength=1.0)
    assert df["true_score"].max() > 0.75


def test_seed_determinism(landscape):
    a, _ = _run(landscape, seed=4)
    b, _ = _run(landscape, seed=4)
    assert a["sequence"].tolist() == b["sequence"].tolist()
    c, _ = _run(landscape, seed=5)
    assert a["sequence"].tolist() != c["sequence"].tolist()


@pytest.mark.parametrize("density_metric", ["hamming", "edit"])
def test_cells_equal_single_runs(landscape, density_metric):
    """Three cells in lockstep (other starts, signal strengths, seeds) equal three single runs."""
    fn, params = landscape.device_fitness()
    cfg = AdaleadConfig(rounds=2, sequences_batch_size=8, model_queries_per_batch=32,
                        alphabet_size=4)
    kw = dict(env_batch_size=8, train_epochs=3, density_metric=density_metric)
    starts = torch.as_tensor(flexs.Alphabet(flexs.DNAA).encode(tf_binding.STARTS[:3]))
    ss, seeds = [0.5, 0.9, 1.0], [3, 4, 5]
    cells = dyna_ppo_runner.run_dyna_ppo_nam_cells(cell_axis_oracle(fn), params, starts, cfg,
                                                   ss, [_gen(s) for s in seeds], **kw)
    for c in range(3):
        single = dyna_ppo_runner.run_dyna_ppo_nam(fn, params, starts[c], cfg, ss[c],
                                                  _gen(seeds[c]), **kw)
        for name, got, want in zip(single._fields, cells, single):
            assert torch.equal(got[c], want), (c, name)


@pytest.fixture(scope="module")
def mean_tops(landscape, jax_landscape):
    """(port, JAX) mean top over SEEDS at the JAX cases' size, NAM at 0.9."""
    port = [_run(landscape, seed=s)[0]["true_score"].max() for s in SEEDS]
    ref = [jax_runtime.DeviceDynaPPONAM(
        jax_landscape, flexs.DNAA, starting_sequence=START, signal_strength=0.9, seed=s,
        **RUN).run(verbose=False)[0]["true_score"].max() for s in SEEDS]
    return np.mean(port), np.mean(ref)


def test_quality_matches_jax(mean_tops):
    port, ref = mean_tops
    assert abs(port - ref) <= BAND, (port, ref)


def test_perfect_model_cost_schedule_equals_jax(landscape, jax_landscape):
    """No data-dependent loop: a perfect run charges JAX's model cost every round."""
    kw = dict(rounds=3, sequences_batch_size=10, model_queries_per_batch=30, env_batch_size=8,
              train_epochs=2, model="perfect", seed=1)
    port, _ = _run(landscape, **kw)
    ref, _ = jax_runtime.DeviceDynaPPONAM(jax_landscape, flexs.DNAA, starting_sequence=START,
                                          **kw).run(verbose=False)
    per_round = [g["model_cost"].iloc[0] for _, g in port.groupby("round")]
    assert per_round == [g["model_cost"].iloc[0] for _, g in ref.groupby("round")]
    assert per_round == [0, 32, 64, 96]


def test_edit_density_equals_jax_on_the_shift_pair():
    """ACGTACGT vs CGTACGTA: Hamming 8, Levenshtein 2, weighed 1/2; the dead row is masked."""
    query = [[1, 2, 3, 0, 1, 2, 3, 0]]
    den_tokens = [[0, 1, 2, 3, 0, 1, 2, 3], [1, 2, 3, 0, 1, 2, 3, 0]]
    den_fit = [1.0, 50.0]
    got = dyna_ppo_runner._edit_density(torch.tensor(query), torch.tensor(den_tokens),
                                        torch.tensor(den_fit), torch.tensor(1))
    want = jax_dyna._edit_density(jnp.array(query, jnp.int32), jnp.array(den_tokens, jnp.int32),
                                  jnp.array(den_fit, jnp.float32), jnp.int32(1))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(got.numpy(), [0.5], atol=1e-6)


@pytest.fixture(scope="module")
def density_pool():
    """Seeded mutants of one sequence (many within distance 2), with fitnesses and a fill."""
    rng = np.random.default_rng(0)
    length, n = 14, 60
    base = rng.integers(0, 4, length)
    pool = np.repeat(base[None], n, axis=0)
    for row in pool:
        pos = rng.choice(length, rng.integers(0, 4), replace=False)
        row[pos] = rng.integers(0, 4, len(pos))
    pool[5] = np.roll(base, 1)  # a block shift: Hamming far, Levenshtein 2
    queries = np.concatenate([pool[:6], np.roll(pool[6:12], -1, axis=1)])
    fit = rng.random(n).astype(np.float32)
    fit[-1] = np.nan  # the trash row's kind of value, past the fill
    return queries, pool, fit, n - 7


def test_edit_density_equals_jax(density_pool):
    from flexs_tpu.ops.hamming import banded_edit_distance_matrix as jax_banded
    from flexs_tpu_torch.ops.hamming import banded_edit_distance_matrix

    queries, pool, fit, n_den = density_pool
    np.testing.assert_array_equal(
        banded_edit_distance_matrix(torch.as_tensor(queries), torch.as_tensor(pool)).numpy(),
        np.asarray(jax_banded(jnp.asarray(queries, jnp.int32), jnp.asarray(pool, jnp.int32))))
    got = dyna_ppo_runner._edit_density(torch.as_tensor(queries), torch.as_tensor(pool),
                                        torch.as_tensor(fit), torch.tensor(n_den))
    want = jax_dyna._edit_density(jnp.asarray(queries, jnp.int32), jnp.asarray(pool, jnp.int32),
                                  jnp.asarray(fit), jnp.int32(n_den))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=DENSITY_RTOL, atol=0)
    assert (got > 0).sum() >= 6


def test_hamming_density_equals_jax(density_pool):
    """The packed Hamming density of `dyna_ppo_runner.py:231-238`."""
    queries, pool, fit, n_den = density_pool
    bits, per_word, _ = packed_hamming.packing_spec(queries.shape[1], 4)
    pk = packed_hamming.pack_tokens(torch.as_tensor(queries), 4)
    den_pk = packed_hamming.pack_tokens(torch.as_tensor(pool), 4)
    got = dyna_ppo_runner._hamming_density(pk, den_pk, torch.as_tensor(fit), torch.tensor(n_den),
                                           bits, per_word)
    jpk = jax_packed.pack_tokens(jnp.asarray(queries, jnp.int32), 4)
    jden = jax_packed.pack_tokens(jnp.asarray(pool, jnp.int32), 4)
    d = _dists_to_cache(jpk, jden, jnp.int32(n_den), bits, per_word)
    np.testing.assert_array_equal(
        packed_hamming.packed_hamming_matrix(pk, den_pk, bits, per_word).numpy()[:, :n_den],
        np.asarray(d)[:, :n_den])
    w = jnp.where((d > 0) & (d <= 2), 1.0 / jnp.maximum(d, 1.0), 0.0)
    want = w @ jnp.nan_to_num(jnp.asarray(fit))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=DENSITY_RTOL, atol=0)
    assert (got > 0).sum() >= 5


def test_density_metric_edit_runs(landscape):
    """density_metric='edit' keeps the run contract."""
    df, _ = _run(landscape, density_metric="edit")
    assert df["round"].max() == 2
    assert df["sequence"].is_unique
    assert df["model_cost"].max() == 2 * 32
    a, _ = _run(landscape, density_metric="edit", seed=3)
    b, _ = _run(landscape, density_metric="edit", seed=3)
    assert a["sequence"].tolist() == b["sequence"].tolist()
    with pytest.raises(ValueError, match="density_metric"):
        _run(landscape, density_metric="levenshtein")


def test_surrogate_raises(landscape):
    """A trained surrogate does not apply (the JAX package's ValueErrors)."""
    with pytest.raises(ValueError, match="model must be 'nam' or 'perfect'"):
        _run(landscape, model="surrogate")
    fn, params = landscape.device_fitness()
    cfg = AdaleadConfig(rounds=1, sequences_batch_size=8, model_queries_per_batch=32,
                        alphabet_size=4, surrogate=SurrogateSpec())
    with pytest.raises(ValueError, match="model='surrogate' does not apply"):
        dyna_ppo_runner.run_dyna_ppo_nam(fn, params, torch.as_tensor([0] * 8), cfg, 1.0, _gen(0))


def test_dynappo_in_generic_sweep(landscape):
    from flexs_tpu_torch.parallel import run_landscape_robustness_sweep

    df = run_landscape_robustness_sweep(
        [landscape], flexs.DNAA, starts=[START], signal_strengths=[1.0], seeds=[0], rounds=2,
        sequences_batch_size=8, model_queries_per_batch=32, algorithm="dynappo",
        algorithm_kwargs={"env_batch_size": 8}, device="cpu")
    single, _ = _run(landscape, signal_strength=1.0)
    assert len(df) == 1
    assert df["max_fitness"].iloc[0] >= df["start_fitness"].iloc[0]
    assert df["model_cost"].iloc[0] == 2 * 32
    assert df["max_fitness"].iloc[0] == single["true_score"].max()


def test_default_device_without_card_raises(landscape):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceDynaPPONAM(landscape, flexs.DNAA, starting_sequence=START, **RUN)
