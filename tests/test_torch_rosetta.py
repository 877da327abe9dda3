"""The port's Rosetta and AAV landscapes (and its PDB parser) against the JAX package.

Both landscapes are gathers and sums over fixed tables, so they are held
to the JAX package's values on the same numpy-seeded tokens: the parsed
structures and the contact features exactly, fitness to 1e-6.  Folding
energies are sums of about 500 f32 terms, taken in another order than
XLA's, so they agree to 1e-6 relative (a few f32 ulps of |E| <= 80).
"""
import numpy as np
import pytest
import torch

import flexs_tpu
from flexs_tpu.landscapes import additive_aav_packaging as jax_aav
from flexs_tpu.landscapes import rosetta as jax_rosetta
from flexs_tpu.ops import pdb as jax_pdb

import flexs_tpu_torch as flexs
from flexs_tpu_torch.landscapes import additive_aav_packaging as aav
from flexs_tpu_torch.landscapes import rosetta
from flexs_tpu_torch.ops import pdb

STRUCTURES = ("3msi", "3mx7")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel worker processes."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


@pytest.fixture(scope="module")
def folding():
    """{name: (port landscape on the CPU, JAX landscape)}."""
    return {
        name: (
            rosetta.RosettaFolding(**rosetta.registry()[name]["params"], device="cpu"),
            jax_rosetta.RosettaFolding(**jax_rosetta.registry()[name]["params"]),
        )
        for name in STRUCTURES
    }


def _random_sequences(length, n, seed):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(list(flexs.AAS), length)) for _ in range(n)]


@pytest.mark.parametrize("name", STRUCTURES)
def test_parse_pdb_equals_jax(name):
    path = rosetta.registry()[name]["params"]["pdb_file"]
    got, want = pdb.parse_pdb(path), jax_pdb.parse_pdb(path)
    assert got.sequence == want.sequence
    np.testing.assert_array_equal(got.ca, want.ca)
    np.testing.assert_array_equal(got.cb, want.cb)
    assert got.ca.dtype == np.float32 and got.cb.dtype == np.float32


@pytest.mark.parametrize("name,length,contacts", [("3msi", 66, 425), ("3mx7", 90, 543)])
def test_compute_features_equal_jax(name, length, contacts):
    structure = pdb.parse_pdb(rosetta.registry()[name]["params"]["pdb_file"])
    got = rosetta.compute_features(structure)
    want = jax_rosetta.compute_features(structure)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert len(got[0]) == length and len(got[1]) == contacts


def test_potentials_equal_jax():
    for a, b in zip(rosetta.load_potential(), jax_rosetta.load_potential()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(rosetta.default_potential(), jax_rosetta.default_potential()):
        np.testing.assert_array_equal(a, b)


def test_registry_equals_jax():
    got, want = rosetta.registry(), jax_rosetta.registry()
    assert set(got) == set(want) == set(STRUCTURES)
    for name in STRUCTURES:
        assert got[name]["starts"] == want[name]["starts"]
        for key in ("sigmoid_center", "sigmoid_norm_value"):
            assert got[name]["params"][key] == want[name]["params"][key]


@pytest.mark.parametrize("name", STRUCTURES)
def test_fitness_equals_jax(folding, name):
    port, ref = folding[name]
    length = len(port.wt_sequence)
    tokens = np.random.default_rng(len(name) + length).integers(0, 20, (300, length))
    got = port.fitness_from_tokens(tokens)
    assert got.dtype == torch.float32 and got.shape == (300,)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref.fitness_from_tokens(tokens)), atol=1e-6)
    seqs = _random_sequences(length, 20, 1) + list(rosetta.registry()[name]["starts"].values())
    np.testing.assert_allclose(port.get_fitness(seqs), ref.get_fitness(seqs), atol=1e-6)


@pytest.mark.parametrize("name", STRUCTURES)
def test_folding_energy_equals_jax(folding, name):
    port, ref = folding[name]
    seqs = [port.wt_sequence] + _random_sequences(len(port.wt_sequence), 20, 2)
    got = np.array([port.get_folding_energy(s) for s in seqs])
    want = np.array([ref.get_folding_energy(s) for s in seqs])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert got[0] == want[0]


def test_wild_type_matches_start_edit_distances(folding):
    port = folding["3msi"][0]
    assert len(port.wt_sequence) == 66 and len(folding["3mx7"][0].wt_sequence) == 90
    for name, start in rosetta.registry()["3msi"]["starts"].items():
        assert sum(a != b for a, b in zip(port.wt_sequence, start)) == int(name.split("_")[1])


def test_length_mismatch_raises(folding):
    port = folding["3msi"][0]
    with pytest.raises(ValueError, match="same length"):
        port.get_fitness(["ACDEFG"])
    with pytest.raises(ValueError, match="same length"):
        port.get_folding_energy("ACDEFG")
    assert port.get_fitness([]).shape == (0,)


def test_fitness_is_sigmoid_of_energy(folding):
    port = folding["3msi"][0]
    e = port.get_folding_energy(port.wt_sequence)
    expected = 1.0 / (1.0 + np.exp(-((-e - (-3)) / 12)))
    assert port.get_fitness([port.wt_sequence])[0] == pytest.approx(expected, abs=1e-6)


def test_device_fitness_is_the_module_function(folding):
    fn, params = folding["3msi"][0].device_fitness()
    assert fn is rosetta._rosetta_fitness
    assert fn is folding["3mx7"][0].device_fitness()[0]
    assert params.pair_i.dtype == torch.int64 and params.consts.tolist() == [-3.0, 12.0]


def test_aav_registry_six_phenotypes():
    problems = aav.registry()
    assert problems == jax_aav.registry()
    assert sorted(problems) == ["blood", "heart", "kidney", "liver", "lung", "spleen"]
    assert aav.AAV2_WT == jax_aav.AAV2_WT


@pytest.mark.parametrize("phenotype", sorted(aav.registry()))
def test_aav_fitness_equals_jax(phenotype):
    params = aav.registry()[phenotype]["params"]
    port = aav.AdditiveAAVPackaging(**params, device="cpu")
    ref = jax_aav.AdditiveAAVPackaging(**params)
    assert port.name == ref.name
    assert port.top_seq == ref.top_seq and port.max_possible == ref.max_possible
    tokens = np.random.default_rng(len(phenotype)).integers(0, 20, (256, 90))
    np.testing.assert_allclose(
        port.fitness_from_tokens(tokens).numpy(), np.asarray(ref.fitness_from_tokens(tokens)),
        atol=1e-6,
    )
    seqs = [port.wild_type, port.top_seq] + _random_sequences(90, 20, 3)
    got = port.get_fitness(seqs)
    np.testing.assert_allclose(got, ref.get_fitness(seqs), atol=1e-6)
    assert (got >= 0).all() and got.dtype == np.float64


def test_aav_noise_seeded_clipped_and_kept_off_the_device_path():
    seqs = _random_sequences(90, 50, 4)
    kw = dict(phenotype="heart", start=450, end=540, noise=0.5, device="cpu")
    a = aav.AdditiveAAVPackaging(**kw, seed=3).get_fitness(seqs)
    b = aav.AdditiveAAVPackaging(**kw, seed=3).get_fitness(seqs)
    c = aav.AdditiveAAVPackaging(**kw, seed=4).get_fitness(seqs)
    np.testing.assert_array_equal(a, b)
    assert (a >= 0).all() and not np.array_equal(a, c)
    noiseless = aav.AdditiveAAVPackaging(**{**kw, "noise": 0}).get_fitness(seqs)
    assert 0.1 < np.abs(a - noiseless).mean() < 1.0
    with pytest.raises(ValueError, match="noiseless"):
        aav.AdditiveAAVPackaging(**kw).device_fitness()


@pytest.mark.parametrize("which", ["rosetta", "aav"])
def test_fused_nam_run_on_the_new_landscapes(which):
    if which == "rosetta":
        problem = rosetta.registry()["3msi"]
        land = rosetta.RosettaFolding(**problem["params"], device="cpu")
        start = problem["starts"]["ed_3_wt"]
    else:
        land = aav.AdditiveAAVPackaging(phenotype="heart", start=450, end=540, device="cpu")
        start = land.wild_type
    df, _ = flexs.runtime.DeviceAdaleadNAM(
        land, flexs.AAS, rounds=2, sequences_batch_size=5, model_queries_per_batch=20,
        starting_sequence=start, signal_strength=1.0, seed=0, device="cpu",
    ).run(verbose=False)
    assert df["round"].max() == 2 and df["sequence"].is_unique
    np.testing.assert_allclose(df["true_score"], land.get_fitness(df["sequence"].tolist()),
                               atol=1e-6)
    assert isinstance(flexs_tpu.AAS, str) and flexs.AAS == flexs_tpu.AAS
