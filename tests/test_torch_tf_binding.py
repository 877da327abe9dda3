"""The port's TF-binding landscape held against the JAX package's.

Scores are table gathers, so they must be equal bit for bit; `get_fitness`
returns float64 in both packages and must be equal too.
"""
import numpy as np
import pytest
import torch

import flexs_tpu
import flexs_tpu_torch
from flexs_tpu_torch.landscapes import tf_binding

NAMES, _ = tf_binding._packed_tables()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel worker processes."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def test_registry_identical_to_jax():
    got = tf_binding.registry()
    want = flexs_tpu.landscapes.tf_binding.registry()
    assert got == want
    assert len(got) == 200
    assert tf_binding.STARTS == flexs_tpu.landscapes.tf_binding.STARTS


def test_tokens_to_index_equals_jax():
    tokens = np.random.default_rng(0).integers(0, 4, (256, 8))
    got = tf_binding.tokens_to_index(tokens).numpy()
    want = np.asarray(flexs_tpu.landscapes.tf_binding._tokens_to_index(tokens))
    np.testing.assert_array_equal(got, want)


def test_fitness_from_tokens_bitwise_on_every_landscape():
    tokens = np.random.default_rng(1).integers(0, 4, (512, 8)).astype(np.int32)
    for name in NAMES:
        got = tf_binding.TFBinding(name=name, device="cpu").fitness_from_tokens(tokens)
        want = np.asarray(flexs_tpu.landscapes.TFBinding(name=name).fitness_from_tokens(tokens))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


@pytest.mark.parametrize("name", ["SIX6_REF_R1", NAMES[0], NAMES[-1]])
def test_get_fitness_equal_as_float64(name):
    rng = np.random.default_rng(2)
    seqs = flexs_tpu_torch.utils.sequence_utils.generate_random_sequences(
        8, 300, flexs_tpu_torch.DNAA, rng=rng
    )
    port = tf_binding.TFBinding(name=name, device="cpu")
    jax_land = flexs_tpu.landscapes.TFBinding(name=name)
    got, want = port.get_fitness(seqs), jax_land.get_fitness(seqs)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    assert port.cost == jax_land.cost == 300
    assert port.name == jax_land.name == "TF_Binding"


def test_both_strands_same_score():
    landscape = tf_binding.TFBinding(name="SIX6_REF_R1", device="cpu")
    comp = {"A": "T", "T": "A", "G": "C", "C": "G"}
    seqs = flexs_tpu_torch.utils.sequence_utils.generate_random_sequences(
        8, 50, flexs_tpu_torch.DNAA, rng=np.random.default_rng(3)
    )
    rcs = ["".join(comp[c] for c in reversed(s)) for s in seqs]
    np.testing.assert_array_equal(landscape.get_fitness(seqs), landscape.get_fitness(rcs))


def test_table_state_carries_over_from_jax():
    jax_land = flexs_tpu.landscapes.TFBinding(name="SIX6_REF_R1")
    port = tf_binding.TFBinding(table=np.asarray(jax_land.table), device="cpu")
    tokens = np.random.default_rng(4).integers(0, 4, (128, 8))
    np.testing.assert_array_equal(
        port.fitness_from_tokens(tokens).numpy(), np.asarray(jax_land.fitness_from_tokens(tokens))
    )


def _write_tsv(path, rng):
    """A reference-format TSV: each 8-mer once with its reverse complement."""
    comp = {"A": "T", "T": "A", "G": "C", "C": "G"}
    seqs = sorted(set(flexs_tpu_torch.utils.sequence_utils.generate_random_sequences(
        8, 400, flexs_tpu_torch.DNAA, rng=rng
    )))
    lines = ["8-mer\t8-mer.1\tE-score"]
    for s, score in zip(seqs, rng.uniform(-0.5, 0.5, len(seqs))):
        lines.append(f"{s}\t{''.join(comp[c] for c in reversed(s))}\t{score:.5f}")
    path.write_text("\n".join(lines) + "\n")


def test_table_from_tsv_equals_jax(tmp_path):
    tsv = tmp_path / "synthetic_8mers.txt"
    _write_tsv(tsv, np.random.default_rng(5))
    got = tf_binding.table_from_tsv(str(tsv))
    want = flexs_tpu.landscapes.tf_binding.table_from_tsv(str(tsv))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    port = tf_binding.TFBinding(landscape_file=str(tsv), device="cpu")
    np.testing.assert_array_equal(port.table.numpy(), want)


def test_unknown_name_and_no_source_raise():
    with pytest.raises(ValueError, match="Unknown TF-binding landscape"):
        tf_binding.TFBinding(name="NOPE", device="cpu")
    with pytest.raises(ValueError, match="Provide one of"):
        tf_binding.TFBinding(device="cpu")


def test_device_fitness_is_the_gather():
    landscape = tf_binding.TFBinding(name="SIX6_REF_R1", device="cpu")
    fn, table = landscape.device_fitness()
    assert fn is tf_binding.device_fitness_fn and table is landscape.table
    tokens = torch.as_tensor(np.random.default_rng(6).integers(0, 4, (64, 8)))
    assert torch.equal(fn(table, tokens), landscape.fitness_from_tokens(tokens))


def test_default_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tf_binding.TFBinding(name="SIX6_REF_R1")
