"""The CUDA duplex kernel held against its plain version, on the card.

These tests need a CUDA card and the CUDA toolkit; elsewhere they skip.
They import nothing of JAX, so on a machine without it they run as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from flexs_tpu_torch import profile_duplex_rowcost
from flexs_tpu_torch.landscapes import rna
from flexs_tpu_torch.ops import cuda_duplex
from flexs_tpu_torch.ops import rna_duplex as rd

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _tokens(rng, shape, dev):
    return torch.as_tensor(rng.integers(0, 4, shape), device=dev)


@pytest.mark.parametrize(
    "b,l1,n_t,l2,maxloop",
    [
        (7, 37, 1, 37, 16),  # L2 not a multiple of the warp
        (3, 20, 3, 300, 16),  # > 48 KB of shared memory, three targets
        (16, 30, 2, 25, 3),  # the smallest window the kernel takes
        (16, 40, 1, 40, 7),
        (1, 1, 1, 1, 16),  # one cell
    ],
)
def test_kernel_equals_plain(card, b, l1, n_t, l2, maxloop):
    rng = np.random.default_rng(b * 1000 + l2)
    params = rd.DuplexParams.calibrated() if maxloop == 16 else rd.DuplexParams(maxloop=maxloop)
    em = params.energy_model(card)
    tokens = _tokens(rng, (b, l1), card)
    targets_rev = _tokens(rng, (n_t, l2), card)
    before = cuda_duplex.launches
    got = cuda_duplex.duplex_energies(tokens, targets_rev, em, maxloop)
    assert cuda_duplex.launches == before + 1
    want = cuda_duplex.duplex_energies_plain(tokens, targets_rev, em, maxloop)
    torch.cuda.synchronize()
    assert got.shape == (b, n_t) and got.device == tokens.device
    assert torch.equal(got, want), float((got - want).abs().max())


def test_empty_batch_launches_nothing(card):
    em = rd.DuplexParams.calibrated().energy_model(card)
    before = cuda_duplex.launches
    out = cuda_duplex.duplex_energies(
        torch.zeros((0, 10), dtype=torch.long, device=card),
        torch.zeros((1, 10), dtype=torch.long, device=card), em, 16,
    )
    assert out.shape == (0, 1) and cuda_duplex.launches == before


def test_wrapper_rejects_bad_inputs(card):
    em = rd.DuplexParams.calibrated().energy_model(card)
    tokens = torch.zeros((2, 10), dtype=torch.long, device=card)
    with pytest.raises(TypeError):
        cuda_duplex.duplex_energies(tokens.float(), tokens[:1], em, 16)
    with pytest.raises(ValueError, match="unsupported shapes"):
        cuda_duplex.duplex_energies(tokens, torch.zeros((1, 1025), device=card).long(), em, 16)
    with pytest.raises(ValueError, match="expected"):
        cuda_duplex.duplex_energies(tokens, tokens[:1], em, 12)
    with pytest.raises(ValueError, match="is on cpu"):
        cuda_duplex.duplex_energies(tokens, tokens[:1].cpu(), em, 16)


def test_landscape_on_card_equals_cpu(card):
    params = rna.registry()["L50_RNA2+3"]["params"]
    tokens = np.random.default_rng(3).integers(0, 4, (40, 50))
    on_card = rna.RNABinding(**params, device=card)
    on_cpu = rna.RNABinding(**params, device="cpu")
    np.testing.assert_array_equal(on_card.norm_values, on_cpu.norm_values)
    before = cuda_duplex.launches
    got = on_card.fitness_from_tokens(tokens)
    assert cuda_duplex.launches == before + 1
    assert torch.equal(got.cpu(), on_cpu.fitness_from_tokens(tokens))


def test_duplex_energy_batch_launches_the_kernel(card):
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, 4, (32, 50))
    target = rng.integers(0, 4, 60)
    before = cuda_duplex.launches
    got = rd.duplex_energy_batch(tokens, target, device=card)
    assert cuda_duplex.launches == before + 1
    want = rd.duplex_energy_batch(tokens, target, device="cpu")
    assert got.shape == (32,) and got.device == card
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("b,l1,l2", [(64, 100, 100), (7, 37, 37)])
def test_rowcost_baseline_equals_plain(card, b, l1, l2):
    rng = np.random.default_rng(b + l1)
    em = rd.DuplexParams.calibrated().energy_model(card)
    tokens = _tokens(rng, (b, l1), card)
    target_rev = _tokens(rng, (l2,), card)
    before = cuda_duplex.launches
    got = profile_duplex_rowcost.run_variant(tokens, target_rev, em, 16, "baseline")
    assert cuda_duplex.launches == before + 1
    want = cuda_duplex.duplex_energies_plain(tokens, target_rev[None], em, 16)[:, 0]
    assert torch.equal(got, want), float((got - want).abs().max())


def test_rowcost_unrolled_equals_plain(card):
    tokens, target_rev, em, maxloop = profile_duplex_rowcost.seeded_inputs(card)
    tokens = tokens[:128]
    got = profile_duplex_rowcost.run_variant(tokens, target_rev, em, maxloop, "unrolled")
    want = cuda_duplex.duplex_energies_plain(tokens, target_rev[None], em, maxloop)[:, 0]
    assert torch.equal(got, want), float((got - want).abs().max())


@pytest.mark.parametrize("variant", ["const-rec", "carry-windows", "unrolled"])
def test_rowcost_knockout_returns_finite_energies(card, variant):
    tokens, target_rev, em, maxloop = profile_duplex_rowcost.seeded_inputs(card)
    tokens = tokens[:128]
    before = cuda_duplex.knockout_launches[variant]
    got = profile_duplex_rowcost.run_variant(tokens, target_rev, em, maxloop, variant)
    torch.cuda.synchronize()
    assert cuda_duplex.knockout_launches[variant] == before + 1
    assert got.shape == (128,) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
