"""The port's DyNA-PPO environments, ensemble and explorers against the JAX package's.

Both environments are stepped with the same actions in both packages over
deterministic models: observations, rewards, termination and the density
penalty (banded edit distance to every cached sequence) must be equal.
The r^2-gated ensemble is trained on the same data in both packages (its
holdout split is a seeded numpy permutation) over members whose fits agree
(ridge to 1e-4, k-NN exactly, a fixed function), and must gate alike.
"""
import numpy as np
import pytest
import torch

import flexs_tpu
import flexs_tpu_torch
from flexs_tpu.baselines.explorers import dyna_ppo as jax_dyna_ppo
from flexs_tpu.baselines.explorers.environments import dyna_ppo as jax_envs
from flexs_tpu_torch.baselines.explorers import dyna_ppo
from flexs_tpu_torch.baselines.explorers.environments import dyna_ppo as envs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel worker processes."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def _count_t(pkg):
    class CountT(pkg.Model):
        """Deterministic smooth fitness: fraction of 'T's."""

        def __init__(self):
            super().__init__(name="CountT")

        def train(self, *args):
            pass

        def _fitness_function(self, sequences):
            return np.array([s.count("T") / len(s) for s in sequences])

    return CountT()


def _fake(pkg, cls, seed):
    class Fake(cls):
        def __init__(self):
            super().__init__(name=f"Fake{seed}")
            self.rng = np.random.default_rng(seed)

        def train(self, *args):
            pass

        def _fitness_function(self, sequences):
            return self.rng.random(size=len(sequences))

    return Fake()


PACKAGES = ((flexs_tpu_torch, envs, {"device": "cpu"}), (flexs_tpu, jax_envs, {}))


def test_constructive_environment_matches_jax():
    pair = [mod.DynaPPOEnvironment(pkg.DNAA, 6, _count_t(pkg), _fake(pkg, pkg.Landscape, 0), 3,
                                   **dev)
            for pkg, mod, dev in PACKAGES]
    rng = np.random.default_rng(0)
    for episode in range(6):
        for env in pair:
            env.set_fitness_model_to_gt(episode % 2 == 0)
        np.testing.assert_array_equal(*(env.reset() for env in pair))
        done = False
        while not done:
            # Few distinct letters, so that episodes land near cached sequences.
            actions = rng.integers(0, 2, 3) * 2
            (o1, r1, d1), (o2, r2, d2) = (env.step(actions) for env in pair)
            np.testing.assert_array_equal(o1, o2)
            np.testing.assert_array_equal(r1, r2)
            assert d1 == d2
            done = d1
    assert list(pair[0].all_seqs) == list(pair[1].all_seqs)
    queries = list(pair[1].all_seqs) + ["TTTTTT", "GAGAGA", "ACGTTT"]
    got = pair[0]._density.densities(queries)
    np.testing.assert_array_equal(got, pair[1]._density.densities(queries))
    assert (got > 0).any()
    assert pair[0].model.cost == pair[1].model.cost
    assert pair[0].landscape.cost == pair[1].landscape.cost


def test_mutative_environment_matches_jax():
    pair = [mod.DynaPPOEnvironmentMutative(pkg.DNAA, "TTGCAGCA", _count_t(pkg),
                                           _fake(pkg, pkg.Landscape, 0), max_num_steps=5, **dev)
            for pkg, mod, dev in PACKAGES]
    rng = np.random.default_rng(1)
    for episode in range(8):
        for env in pair:
            env.set_fitness_model_to_gt(episode % 3 == 0)
        np.testing.assert_array_equal(*(env.reset() for env in pair))
        done = False
        while not done:
            action = int(rng.integers(32))
            (o1, r1, d1), (o2, r2, d2) = (env.step(action) for env in pair)
            np.testing.assert_array_equal(o1, o2)
            assert (r1, d1) == (r2, d2)
            done = d1
    assert list(pair[0].all_seqs.items()) == list(pair[1].all_seqs.items())
    assert pair[0].sequence_density("TTGCAGCT") == pair[1].sequence_density("TTGCAGCT")


def test_density_uses_exact_edit_distance():
    """ACGT -> CGTA: Hamming distance 4, Levenshtein 2 (the JAX package's pinned case)."""
    env = envs.DynaPPOEnvironment(flexs_tpu.DNAA, 4, _count_t(flexs_tpu_torch),
                                  _fake(flexs_tpu_torch, flexs_tpu_torch.Landscape, 0), 1,
                                  device="cpu")
    env._density.update(["ACGT"], [1.0])
    assert env.sequence_density("CGTA") == pytest.approx(1.0 / 2)
    env._density.update(["TTTT", "ACGT"], [1.0, 0.5])  # a refit value replaces the old one
    assert env.sequence_density("CGTA") == pytest.approx(0.5 / 2)
    assert env.sequence_density("TTTG") == pytest.approx(1.0)


def _ensemble(pkg, module, **dev):
    m = pkg.baselines.models
    if pkg is flexs_tpu:
        members = [m.JaxRidgeRegression(pkg.DNAA, alpha=0.0, name="linear_regression"),
                   m.JaxKNNRegressor(pkg.DNAA)]
    else:
        members = [m.TorchRidgeRegression(pkg.DNAA, alpha=0.0, name="linear_regression", **dev),
                   m.TorchKNNRegressor(pkg.DNAA, **dev)]
    members += [_count_t(pkg), _fake(pkg, pkg.Model, 1)]
    return module.DynaPPOEnsemble(8, pkg.DNAA, models=members, seed=0, **dev)


def test_ensemble_gating_matches_jax():
    rng = np.random.default_rng(0)
    seqs = flexs_tpu.Alphabet(flexs_tpu.DNAA).decode(rng.integers(0, 4, (60, 8)))
    labels = np.array([s.count("T") / 8 for s in seqs]) + rng.normal(size=60) * 0.05
    port = _ensemble(flexs_tpu_torch, dyna_ppo, device="cpu")
    ref = _ensemble(flexs_tpu, jax_dyna_ppo)
    for ens in (port, ref):
        ens.train(seqs, labels)
    np.testing.assert_allclose(port.r_squared_vals, ref.r_squared_vals, atol=1e-4)
    gate = lambda ens: [r2 >= ens.r_squared_threshold for r2 in ens.r_squared_vals]  # noqa: E731
    assert gate(port) == gate(ref)
    assert gate(port)[2:] == [True, False]  # the fixed function passes, the noise fails
    queries = seqs[:10]
    np.testing.assert_allclose(port.get_fitness(queries), ref.get_fitness(queries), atol=1e-4)
    # Fewer than 10 samples: no refit, the gate stays as it was.
    before = gate(port)
    port.train(seqs[:5], labels[:5])
    assert gate(port) == before


def test_ensemble_falls_back_to_the_best_member():
    port = dyna_ppo.DynaPPOEnsemble(8, flexs_tpu.DNAA, seed=0, models=[
        _fake(flexs_tpu_torch, flexs_tpu_torch.Model, 1), _count_t(flexs_tpu_torch)],
        r_squared_threshold=2.0, device="cpu")
    port.r_squared_vals = [0.1, 0.4]
    np.testing.assert_array_equal(port.get_fitness(["TTTTAAAA"]), [0.5])


def test_default_member_names_match_jax():
    got = [m.name for m in dyna_ppo.tpu_native_default_models(14, flexs_tpu.DNAA, device="cpu")]
    want = [m.name for m in jax_dyna_ppo.tpu_native_default_models(14, flexs_tpu.DNAA)]
    assert got == want and len(got) == 11
    members = dyna_ppo.tpu_native_default_models(14, flexs_tpu.DNAA, device="cpu")
    assert all(m.device.type == "cpu" for m in members)


ROUNDS, BATCH, QUERIES = 2, 5, 20


def _check(df):
    assert df["round"].max() == ROUNDS
    for r in range(1, ROUNDS + 1):
        assert 0 < len(df[df["round"] == r]) <= BATCH
    costs = df.groupby("round")["model_cost"].first().to_numpy()
    assert (np.diff(costs) > 0).all()


@pytest.mark.parametrize("mutative", [False, True], ids=["constructive", "mutative"])
def test_explorer_run_invariants(mutative):
    """The JAX package's smoke invariants (2 rounds, batch 5, 20 queries)."""
    landscape = _fake(flexs_tpu_torch, flexs_tpu_torch.Landscape, 0)
    ex = flexs_tpu_torch.baselines.explorers
    kw = dict(rounds=ROUNDS, sequences_batch_size=BATCH, model_queries_per_batch=QUERIES,
              starting_sequence="TTGC", alphabet=flexs_tpu.DNAA,
              model=_count_t(flexs_tpu_torch), seed=0, device="cpu")
    explorer = (ex.DynaPPOMutative(landscape, **kw) if mutative
                else ex.DynaPPO(landscape, env_batch_size=2, **kw))
    df, _ = explorer.run(landscape, verbose=False)
    _check(df)
    assert explorer.name == "DynaPPO_Agent_10_1"
    assert explorer.agent.device.type == "cpu"


def test_default_ensemble_run():
    """No `model=`: the 11-member ensemble is built, trained, gated and drives a model phase."""
    landscape = _fake(flexs_tpu_torch, flexs_tpu_torch.Landscape, 0)
    explorer = flexs_tpu_torch.baselines.explorers.DynaPPO(
        landscape, rounds=1, sequences_batch_size=3, model_queries_per_batch=10,
        starting_sequence="TTGCATGCATGCAT", alphabet=flexs_tpu.DNAA, env_batch_size=2, seed=0,
        device="cpu",
    )
    assert len(explorer.model.models) == 11
    df, _ = explorer.run(landscape, verbose=False)
    assert df["round"].max() == 1
    assert 0 < len(df[df["round"] == 1]) <= 3
