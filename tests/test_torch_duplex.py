"""The PyTorch duplex DP held against the JAX package on the same inputs.

The port's plain version must equal `rna_duplex.duplex_energy_from_slabs`
exactly: both run the same f32 adds and mins in the same association, and
select table entries exactly (index gathers here, one-hot products at
HIGHEST precision there).
"""
import jax
import numpy as np
import pytest
import torch

from flexs_tpu.landscapes import rna as jax_rna
from flexs_tpu.ops import rna_duplex as jrd
from flexs_tpu.ops.pallas_duplex import duplex_energy_batch_pallas
from flexs_tpu_torch.alphabet import RNAA, Alphabet
from flexs_tpu_torch.ops import cuda_duplex
from flexs_tpu_torch.ops import rna_duplex as trd


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel worker processes."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


A = Alphabet(RNAA)
TARGETS = [
    jax_rna.registry()[f"L14_RNA{t}"]["params"]["targets"][0] for t in range(1, 5)
]
_jax_slab_energies = jax.jit(jrd.duplex_energy_from_slabs, static_argnames="maxloop")


def _jax_em():
    return {k: np.asarray(v) for k, v in jrd.DuplexParams.calibrated().energy_model().items()}


def _torch_em():
    return trd.DuplexParams.calibrated().energy_model("cpu")


def _reversed(target):
    return A.encode_one(target)[::-1].copy()


def test_trigram_tables_equal():
    jax_tables = jrd.trigram_tables(jrd.DuplexParams.calibrated().energy_model())
    torch_tables = trd.trigram_tables(_torch_em())
    for j, t in zip(jax_tables, torch_tables):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_energy_model_from_numpy_round_trips_jax_tables():
    em_np = _jax_em()
    em = trd.energy_model_from_numpy(em_np, "cpu")
    assert em.keys() == em_np.keys()
    for k, v in em_np.items():
        assert em[k].dtype == torch.float32
        np.testing.assert_array_equal(em[k].numpy(), v)
    # The port's own calibrated params yield the identical arrays.
    for k, v in _torch_em().items():
        np.testing.assert_array_equal(v.numpy(), em_np[k])


@pytest.mark.parametrize("length,batch", [(14, 16), (50, 8), (100, 4)])
def test_plain_equals_jax_slab_path(length, batch):
    rng = np.random.default_rng(length)
    tokens = rng.integers(0, 4, (batch, length)).astype(np.int32)
    em_j = jrd.DuplexParams.calibrated().energy_model()
    em_t = _torch_em()
    maxloop = trd.DuplexParams.calibrated().maxloop
    for target in TARGETS:
        trev = _reversed(target)
        ref = np.asarray(_jax_slab_energies(tokens, trev, em_j, maxloop=maxloop))
        got = trd.duplex_energy_from_slabs(
            torch.as_tensor(tokens), torch.as_tensor(trev), em_t, maxloop
        )
        np.testing.assert_array_equal(got.numpy(), ref)


def test_plain_equals_jax_pallas_kernel_interpreted():
    """At L14, the Pallas kernel run in interpret mode (as its own tests run it)."""
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 4, (16, 14)).astype(np.int32)
    target = A.encode_one(TARGETS[0])
    ref = np.asarray(duplex_energy_batch_pallas(tokens, target, jrd.DuplexParams.calibrated()))
    got = trd.duplex_energy_batch(tokens, target, trd.DuplexParams.calibrated(), device="cpu")
    np.testing.assert_array_equal(got.numpy(), ref)


def test_multi_target_wrapper_stacks_targets():
    rng = np.random.default_rng(2)
    tokens = torch.as_tensor(rng.integers(0, 4, (6, 14)))
    targets_rev = torch.as_tensor(np.stack([_reversed(t) for t in TARGETS[:2]]))
    em = _torch_em()
    out = cuda_duplex.duplex_energies(tokens, targets_rev, em, 16)
    assert out.shape == (6, 2) and out.dtype == torch.float32
    for t in range(2):
        np.testing.assert_array_equal(
            out[:, t].numpy(),
            trd.duplex_energy_from_slabs(tokens, targets_rev[t], em, 16).numpy(),
        )


def test_unpairable_sequence_scores_zero():
    tokens = A.encode(["AAAAAAAAAAAAAA"])
    target = A.encode_one("A" * 20)
    got = trd.duplex_energy_batch(tokens, target, device="cpu")
    assert got.numpy()[0] == 0.0
    assert np.asarray(jrd.duplex_energy_batch(tokens, target))[0] == 0.0


def test_cpu_tensors_take_the_plain_version():
    before = cuda_duplex.launches
    tokens = torch.as_tensor(A.encode(["GGGGAAAACCCCUU"]))
    out = cuda_duplex.duplex_energies(
        tokens, torch.as_tensor(_reversed(TARGETS[0]))[None], _torch_em(), 16
    )
    assert out.shape == (1, 1)
    assert cuda_duplex.launches == before


def test_maxloop_below_3_raises():
    params = trd.DuplexParams(maxloop=2)
    tokens = torch.zeros((4, 12), dtype=torch.long)
    targets = torch.zeros((1, 12), dtype=torch.long)
    with pytest.raises(ValueError, match="maxloop >= 3"):
        cuda_duplex.duplex_energies(tokens, targets, params.energy_model("cpu"), 2)


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    tokens = A.encode(["GGGGAAAACCCCUU"])
    with pytest.raises(RuntimeError, match="CUDA"):
        trd.duplex_energy_batch(tokens, A.encode_one(TARGETS[0]))
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_duplex.prepare(
            torch.as_tensor(tokens), torch.as_tensor(tokens), _torch_em(), 16
        )
