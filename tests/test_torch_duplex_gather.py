"""The gather-form duplex DP and its fitness factory, held against the JAX package.

The port's `_duplex_dp_batch` must equal JAX's `jax.vmap(_duplex_dp)`
exactly: both run the same f32 adds, mins and selects in the same order on
the same table entries.  Against the slab path it agrees to rounding only,
since the two associate some sums differently; the tolerance is the one
`tests/test_pallas_duplex.py` uses for the same pair of DPs.
"""
import jax
import numpy as np
import pytest
import torch

from flexs_tpu.landscapes import rna as jax_rna
from flexs_tpu.ops import rna_duplex as jrd
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
    jax_rna.registry()[f"L100_RNA{t}"]["params"]["targets"][0] for t in range(1, 5)
]
_jax_gather = jax.jit(
    lambda tokens, trev, em, maxloop: jax.vmap(
        lambda s: jrd._duplex_dp(s, trev, em, maxloop)
    )(tokens),
    static_argnames="maxloop",
)


def _params(maxloop):
    """(JAX params, port params) of the same model."""
    if maxloop == 16:
        return jrd.DuplexParams.calibrated(), trd.DuplexParams.calibrated()
    return jrd.DuplexParams(maxloop=maxloop), trd.DuplexParams(maxloop=maxloop)


def _reversed(target):
    return A.encode_one(target)[::-1].copy()


@pytest.mark.parametrize("target_index", range(4))
@pytest.mark.parametrize("length", [14, 50])
def test_gather_equals_jax_gather(length, target_index):
    rng = np.random.default_rng(length * 10 + target_index)
    tokens = rng.integers(0, 4, (8, length)).astype(np.int32)
    trev = _reversed(TARGETS[target_index])
    jp, tp = _params(16)
    ref = np.asarray(_jax_gather(tokens, trev, jp.energy_model(), maxloop=16))
    got = trd._duplex_dp_batch(
        torch.as_tensor(tokens), torch.as_tensor(trev), tp.energy_model("cpu"), 16
    )
    assert got.dtype == torch.float32 and got.shape == (8,)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("maxloop", [3, 7])
def test_gather_equals_jax_gather_small_windows(maxloop):
    rng = np.random.default_rng(maxloop)
    tokens = rng.integers(0, 4, (16, 14)).astype(np.int32)
    trev = _reversed(TARGETS[0])
    jp, tp = _params(maxloop)
    ref = np.asarray(_jax_gather(tokens, trev, jp.energy_model(), maxloop=maxloop))
    got = trd._duplex_dp_batch(
        torch.as_tensor(tokens), torch.as_tensor(trev), tp.energy_model("cpu"), maxloop
    )
    np.testing.assert_array_equal(got.numpy(), ref)


def test_single_sequence_form_equals_jax():
    rng = np.random.default_rng(5)
    seq = rng.integers(0, 4, 14).astype(np.int32)
    trev = _reversed(TARGETS[1])
    jp, tp = _params(16)
    ref = np.asarray(jrd._duplex_dp(seq, trev, jp.energy_model(), 16))
    got = trd._duplex_dp(torch.as_tensor(seq), torch.as_tensor(trev), tp.energy_model("cpu"), 16)
    assert got.shape == ()
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("target_index", range(4))
def test_fitness_fn_equals_jax(target_index):
    rng = np.random.default_rng(20 + target_index)
    tokens = rng.integers(0, 4, (8, 14)).astype(np.int32)
    target = A.encode_one(TARGETS[target_index])
    ref = np.asarray(
        jrd.make_duplex_fitness_fn(16)(
            jrd.pack_duplex_params(target, jrd.DuplexParams.calibrated()), tokens
        )
    )
    before = cuda_duplex.launches
    got = trd.make_duplex_fitness_fn(16)(
        trd.pack_duplex_params(target, trd.DuplexParams.calibrated(), device="cpu"), tokens
    )
    assert cuda_duplex.launches == before
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("length", [14, 50])
def test_gather_close_to_slab(length):
    rng = np.random.default_rng(30 + length)
    tokens = torch.as_tensor(rng.integers(0, 4, (8, length)))
    em = trd.DuplexParams.calibrated().energy_model("cpu")
    for target in TARGETS:
        trev = torch.as_tensor(_reversed(target))
        gather = trd._duplex_dp_batch(tokens, trev, em, 16)
        slab = trd.duplex_energy_from_slabs(tokens, trev, em, 16)
        np.testing.assert_allclose(gather.numpy(), slab.numpy(), rtol=1e-5, atol=1e-4)


def test_unpairable_row_scores_zero():
    tokens = torch.as_tensor(A.encode(["A" * 14, "GGGGAAAACCCCUU"]))
    trev = torch.as_tensor(A.encode_one("A" * 20))
    em = trd.DuplexParams.calibrated().energy_model("cpu")
    got = trd._duplex_dp_batch(tokens, trev, em, 16)
    assert got.numpy()[0] == 0.0


def test_pack_duplex_params_reverses_the_target():
    target = A.encode_one(TARGETS[0])
    trev, em = trd.pack_duplex_params(target, device="cpu")
    np.testing.assert_array_equal(trev.numpy(), target[::-1])
    assert em is trd.DEFAULT_PARAMS.energy_model("cpu")
    jtrev, _ = jrd.pack_duplex_params(target)
    np.testing.assert_array_equal(trev.numpy(), np.asarray(jtrev))
