"""The PyTorch distance ops held against the JAX package's (integer-equal)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexs_tpu.ops import hamming as jax_hamming
from flexs_tpu.ops import packed_hamming as jax_packed
from flexs_tpu_torch.ops import hamming, packed_hamming


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel worker processes."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


@pytest.mark.parametrize(
    "length,alphabet_size",
    [(8, 4), (14, 4), (100, 4), (66, 20), (90, 20), (735, 20), (5, 2), (100, 32)],
)
def test_packed_words_and_distances_match_jax(length, alphabet_size):
    rng = np.random.default_rng(length)
    q = rng.integers(0, alphabet_size, (11, length)).astype(np.int32)
    c = rng.integers(0, alphabet_size, (23, length)).astype(np.int32)
    c[3] = q[5]  # one exact match
    assert packed_hamming.packing_spec(length, alphabet_size) == jax_packed.packing_spec(
        length, alphabet_size
    )
    bits, per_word, _ = packed_hamming.packing_spec(length, alphabet_size)

    pq = packed_hamming.pack_tokens(torch.as_tensor(q), alphabet_size)
    pc = packed_hamming.pack_tokens(torch.as_tensor(c), alphabet_size)
    jq = np.asarray(jax_packed.pack_tokens(q, alphabet_size))
    jc = np.asarray(jax_packed.pack_tokens(c, alphabet_size))
    assert pq.dtype == torch.int64 and int(pq.max()) < 2**32
    np.testing.assert_array_equal(pq.numpy().astype(np.uint32), jq)
    np.testing.assert_array_equal(pc.numpy().astype(np.uint32), jc)

    got = packed_hamming.packed_hamming_matrix(pq, pc, bits, per_word)
    assert got.dtype == torch.int32
    ref = np.asarray(jax_packed.packed_hamming_matrix(jq, jc, bits, per_word))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got[5, 3] == 0


def test_min_and_argmin_take_the_first_tie():
    dists = np.array(
        [[3, 1, 1, 2], [0, 0, 0, 0], [5, 4, 3, 3], [2, 9, 2, 1]], dtype=np.int32
    )
    mins, idx = hamming.min_hamming_and_argmin(torch.as_tensor(dists))
    jmins, jidx = jax_hamming.min_hamming_and_argmin(jnp.asarray(dists))
    np.testing.assert_array_equal(mins.numpy(), np.asarray(jmins))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(idx.numpy(), [1, 0, 2, 3])


def test_packed_distances_then_argmin_match_jax_on_random_ties():
    rng = np.random.default_rng(9)
    q = rng.integers(0, 4, (16, 6)).astype(np.int32)  # short rows: many ties
    c = rng.integers(0, 4, (40, 6)).astype(np.int32)
    bits, per_word, _ = packed_hamming.packing_spec(6, 4)
    d = packed_hamming.packed_hamming_matrix(
        packed_hamming.pack_tokens(torch.as_tensor(q), 4),
        packed_hamming.pack_tokens(torch.as_tensor(c), 4), bits, per_word,
    )
    _, idx = hamming.min_hamming_and_argmin(d)
    ref = jax_hamming.hamming_distance_matrix(q, c, alphabet_size=4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jnp.argmin(ref, axis=1)))


def test_edit_distance_matrix_matches_jax():
    rng = np.random.default_rng(7)
    q = rng.integers(0, 4, (5, 8)).astype(np.int32)
    c = rng.integers(0, 4, (6, 8)).astype(np.int32)
    q[1, 5:] = -1  # variable true lengths, padded at the end
    c[2, 3:] = -1
    c[4] = -1  # an empty row
    got = hamming.edit_distance_matrix(q, c)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jax_hamming.edit_distance_matrix(q, c))
    a = np.array([[0, 1, 2, 3, 0]], np.int32)  # ACGTA vs CGTAA: Levenshtein 2
    b = np.array([[1, 2, 3, 0, 0]], np.int32)
    assert hamming.edit_distance_matrix(a, b)[0, 0] == 2


def _today(q, c, n_rows, bound, bits, per_word, fill):
    """The distance op as the runners composed it before the masked op: the
    unmasked matrix of the first `bound` rows, then the fill mask."""
    d = packed_hamming.packed_hamming_matrix(q, c[..., :bound, :], bits, per_word)
    if n_rows is None:
        return d
    filled = torch.arange(bound) < n_rows[..., None]
    return torch.where(filled[..., None, :], d, fill)


@pytest.mark.parametrize("bits", [1, 2, 3, 5])
@pytest.mark.parametrize("words", [1, 7, 40])
@pytest.mark.parametrize("cells", [None, 3])
def test_masked_matrix_equals_the_unmasked_matrix_then_the_mask(bits, words, cells):
    rng = np.random.default_rng(bits * 100 + words)
    per_word = 32 // bits
    lead = () if cells is None else (cells,)
    q = torch.as_tensor(rng.integers(0, 2**32, lead + (13, words)))
    c = torch.as_tensor(rng.integers(0, 2**32, lead + (45, words)))
    c[..., 7, :] = q[..., 2, :]  # an exact match
    fills = [None, torch.tensor(0), torch.tensor(9), torch.tensor(45)] if cells is None else [
        None, torch.tensor([0, 9, 45]), torch.tensor([45, 45, 45])]
    for bound in (1, 30, 45):
        for n_rows in fills:
            got = packed_hamming.masked_hamming_matrix(q, c, n_rows, bound, bits, per_word, 99)
            want = _today(q, c, n_rows, bound, bits, per_word, 99)
            assert got.dtype == torch.int32 and got.shape == lead + (13, bound)
            assert torch.equal(got, want), (bound, n_rows)
    assert packed_hamming.launches == 0


@pytest.mark.parametrize("length,alphabet_size", [(8, 4), (100, 4), (66, 20)])
def test_masked_matrix_matches_jax_dists_to_cache(length, alphabet_size):
    """The runners' masked lookup against the JAX package's, whose masked rows
    read inf where the port's read L + 1."""
    from flexs_tpu.runtime.jit_runner import _dists_to_cache

    rng = np.random.default_rng(length)
    q = rng.integers(0, alphabet_size, (2, 9, length)).astype(np.int32)
    c = rng.integers(0, alphabet_size, (2, 31, length)).astype(np.int32)
    c[1, 4] = q[1, 0]
    bits, per_word, _ = packed_hamming.packing_spec(length, alphabet_size)
    pq = packed_hamming.pack_tokens(torch.as_tensor(q), alphabet_size)
    pc = packed_hamming.pack_tokens(torch.as_tensor(c), alphabet_size)
    jq = np.asarray(jax_packed.pack_tokens(q, alphabet_size))
    jc = np.asarray(jax_packed.pack_tokens(c, alphabet_size))
    for n in (0, 17, 31):
        got = packed_hamming.masked_hamming_matrix(
            pq, pc, torch.tensor([n, 31]), 31, bits, per_word, length + 1)
        for cell, fill in enumerate((n, 31)):
            want = np.asarray(_dists_to_cache(jq[cell], jc[cell], jnp.int32(fill), bits,
                                              per_word))
            np.testing.assert_array_equal(got[cell].numpy(), np.where(np.isinf(want),
                                                                      length + 1, want))


def test_masked_matrix_reads_a_slice_as_given():
    """Non-contiguous rows and queries (slices of wider buffers) give what
    their contiguous copies give."""
    rng = np.random.default_rng(5)
    wide = torch.as_tensor(rng.integers(0, 2**32, (4, 60, 2)))
    q = torch.as_tensor(rng.integers(0, 2**32, (4, 22, 2)))[:, ::2]
    n_rows = torch.tensor([3, 0, 41, 60])
    got = packed_hamming.masked_hamming_matrix(q, wide[:, :41], n_rows, 37, 2, 16, 7)
    want = _today(q.contiguous(), wide[:, :41].contiguous(), n_rows, 37, 2, 16, 7)
    assert got.shape == (4, 11, 37) and torch.equal(got, want)


def test_masked_matrix_rejects_what_neither_version_takes(monkeypatch):
    def no_kernel():
        raise AssertionError("a CPU tensor reached the kernel")

    monkeypatch.setattr(packed_hamming, "_load", no_kernel)
    q = torch.zeros((2, 5, 1), dtype=torch.long)
    c = torch.zeros((2, 9, 1), dtype=torch.long)
    n = torch.tensor([1, 2])
    with pytest.raises(TypeError, match="int64"):
        packed_hamming.masked_hamming_matrix(q.int(), c, n, 9, 2, 16, 9)
    with pytest.raises(TypeError, match="int64"):
        packed_hamming.masked_hamming_matrix(q, c, n.int(), 9, 2, 16, 9)
    with pytest.raises(ValueError, match="bound"):
        packed_hamming.masked_hamming_matrix(q, c, n, 10, 2, 16, 9)
    with pytest.raises(ValueError, match="n_rows"):
        packed_hamming.masked_hamming_matrix(q, c, n[:1], 9, 2, 16, 9)
    with pytest.raises(ValueError, match="shapes"):
        packed_hamming.masked_hamming_matrix(q, c[..., :0], n, 9, 2, 16, 9)
    with pytest.raises(ValueError, match="shapes"):
        packed_hamming.masked_hamming_matrix(q[0], c, n, 9, 2, 16, 9)
    with pytest.raises(ValueError, match="packing"):
        packed_hamming.masked_hamming_matrix(q, c, n, 9, 6, 5, 9)
    assert packed_hamming.masked_hamming_matrix(q, c, n, 9, 2, 16, 9).shape == (2, 5, 9)
    assert packed_hamming.launches == 0
