"""The PyTorch RNABinding landscape held against the JAX package's.

Single-target fitness is one f32 division of bit-equal energies; the
multi-target mean adds an f32 sum and a division by T, so values are
compared within rtol=1e-6, atol=1e-7.
"""
import numpy as np
import pytest
import torch

from flexs_tpu.landscapes import rna as jax_rna
from flexs_tpu_torch.landscapes import rna
from flexs_tpu_torch.ops import cuda_duplex


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel worker processes."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


RTOL, ATOL = 1e-6, 1e-7


def _pair(name):
    params = jax_rna.registry()[name]["params"]
    return rna.RNABinding(**params, device="cpu"), jax_rna.RNABinding(**params)


def _queries(problem, length, n_random, seed):
    rng = np.random.default_rng(seed)
    starts = list(jax_rna.registry()[problem]["starts"].values())
    rand = ["".join(rng.choice(list("UGCA"), length)) for _ in range(n_random)]
    return starts + rand


def test_registry_equals_jax():
    assert rna.registry() == jax_rna.registry()


@pytest.mark.parametrize("length", [14, 50, 100])
def test_single_target_fitness_matches(length):
    name = f"L{length}_RNA1"
    port, ref = _pair(name)
    np.testing.assert_array_equal(port.norm_values, ref.norm_values)
    assert port.name == ref.name
    seqs = _queries(name, length, 6, seed=length)
    got = port.get_fitness(seqs)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, ref.get_fitness(seqs), rtol=RTOL, atol=ATOL)


def test_multi_target_fitness_matches():
    port, ref = _pair("L14_RNA1+2")
    np.testing.assert_array_equal(port.norm_values, ref.norm_values)
    seqs = _queries("L14_RNA1+2", 14, 8, seed=3)
    np.testing.assert_allclose(
        port.get_fitness(seqs), ref.get_fitness(seqs), rtol=RTOL, atol=ATOL
    )


def test_conserved_region_fitness_matches():
    port, ref = _pair("C20_L100_RNA1+2")
    seqs = _queries("C20_L100_RNA1+2", 100, 3, seed=4) + ["A" * 100]
    got = port.get_fitness(seqs)
    np.testing.assert_allclose(got, ref.get_fitness(seqs), rtol=RTOL, atol=ATOL)
    assert got[0] != 0  # the starts carry the conserved pattern
    assert got[-1] == 0


def test_cost_accounting():
    port, _ = _pair("L14_RNA1")
    seqs = _queries("L14_RNA1", 14, 0, seed=0)
    port.get_fitness(seqs)
    port.get_fitness(seqs[:2])
    assert port.cost == 7
    port.fitness_from_tokens(np.zeros((3, 14), np.int64))
    assert port.cost == 7  # the token path charges nothing
    port.add_cost(3)
    assert port.cost == 10


def test_wrong_length_raises():
    port, _ = _pair("L14_RNA1")
    with pytest.raises(ValueError):
        port.get_fitness(["ACGU"])


def test_device_fitness_on_cpu_is_the_plain_version():
    port, ref = _pair("L14_RNA1+2")
    fn, params = port.device_fitness()
    assert fn is rna._rna_binding_fitness
    assert all(p.device.type == "cpu" for p in (params[0], params[2], params[3]))
    tokens = torch.as_tensor(np.random.default_rng(5).integers(0, 4, (8, 14)))
    before = cuda_duplex.launches
    got = fn(params, tokens)
    assert cuda_duplex.launches == before
    targets_rev, em, norms, _ = params
    plain = cuda_duplex.duplex_energies_plain(tokens, targets_rev, em, 16)
    np.testing.assert_array_equal(got.numpy(), ((plain / norms).sum(1) / 2).numpy())
    jfn, jparams = ref.device_fitness()
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jfn(jparams, tokens.numpy().astype(np.int32))),
        rtol=RTOL, atol=ATOL,
    )


def test_cuda_landscape_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rna.RNABinding(**jax_rna.registry()["L14_RNA1"]["params"])
