"""The port's native binding (native/flexs_native.cc) against the port's own oracles.

The cases of tests/test_native.py at its tolerances, with the port's
landscape tensors fed to C++ and the port's plain versions on the CPU as
the reference: Rosetta within rtol 1e-4 / atol 1e-5, RNA duplex within
rtol 1e-4 / atol 1e-3 (the C++ DP associates its sums differently, so it
is never bitwise).  Skipped only when g++ is missing, as the JAX test is.
"""
import os
import shutil

import numpy as np
import pytest
import torch

import flexs_tpu_torch as flexs
from flexs_tpu_torch import native
from flexs_tpu_torch.alphabet import Alphabet
from flexs_tpu_torch.landscapes import rna, rosetta
from flexs_tpu_torch.ops import rna_duplex
from flexs_tpu_torch.utils import sequence_utils as s_utils


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel worker processes."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ is missing: the native library cannot be built")
    return native.load()


def test_rosetta_native_matches_device(lib):
    land = rosetta.RosettaFolding(**rosetta.registry()["3msi"]["params"], device="cpu")
    aa = Alphabet(flexs.AAS)
    seqs = s_utils.generate_random_sequences(
        66, 64, flexs.AAS, rng=np.random.default_rng(0)
    ) + [land.wt_sequence]
    tokens = aa.encode(seqs)
    device = land.fitness_from_tokens(tokens).numpy()
    host = native.rosetta_score_batch(land, tokens)
    np.testing.assert_allclose(host, device, rtol=1e-4, atol=1e-5)


def test_rna_native_matches_device(lib):
    rna_alpha = Alphabet(flexs.RNAA)
    target = rna.registry()["L14_RNA1"]["params"]["targets"][0]
    seqs = s_utils.generate_random_sequences(
        14, 64, flexs.RNAA, rng=np.random.default_rng(1)
    )
    tokens = rna_alpha.encode(seqs)
    t_tokens = rna_alpha.encode_one(target)
    params = rna_duplex.DuplexParams.calibrated()
    device = rna_duplex.duplex_energy_batch(tokens, t_tokens, params, device="cpu").numpy()
    host = native.rna_duplex_energy_batch(tokens, t_tokens, params)
    np.testing.assert_allclose(host, device, rtol=1e-4, atol=1e-3)


def test_rna_native_matches_the_landscape_at_full_width(lib):
    """L100_RNA1's own params and target, the width the card check holds the kernel at."""
    problem = rna.registry()["L100_RNA1"]["params"]
    land = rna.RNABinding(**problem, device="cpu")
    rna_alpha = Alphabet(flexs.RNAA)
    tokens = np.random.default_rng(2).integers(0, 4, (12, 100))
    t_tokens = rna_alpha.encode_one(problem["targets"][0])
    device = rna_duplex.duplex_energy_batch(tokens, t_tokens, land.params, device="cpu").numpy()
    host = native.rna_duplex_energy_batch(tokens, t_tokens, land.params)
    assert land.params.maxloop == 16
    np.testing.assert_allclose(host, device, rtol=1e-4, atol=1e-3)
    assert (host < 0).all()


def test_build_goes_to_the_build_dir_and_a_failure_raises(lib, tmp_path, monkeypatch):
    assert os.path.dirname(native.library_path()) == native.BUILD_DIR
    assert os.path.exists(native.library_path())
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    assert not os.listdir(tmp_path / "build")
