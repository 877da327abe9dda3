"""Ensemble, sequence utilities and distance ops held against the JAX package.

Tolerances: the numpy functions and integer distances must be equal
exactly; the token-space random primitives draw from torch generators, so
they are held to shape, range, rate and per-seed determinism.
"""
import numpy as np
import pytest
import torch

import flexs_tpu
import flexs_tpu_torch
from flexs_tpu.ops import hamming as jax_hamming
from flexs_tpu.utils import sequence_utils as jax_su
from flexs_tpu_torch.ops import hamming
from flexs_tpu_torch.utils import sequence_utils as su


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel worker processes."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def _tf_landscapes(pkg, names, **device):
    return [pkg.landscapes.TFBinding(name=n, **device) for n in names]


@pytest.mark.parametrize("combine", ["mean", "identity"])
def test_ensemble_equals_jax(combine):
    names = ["SIX6_REF_R1", "ARX_L343Q_R1"]
    kw = {} if combine == "mean" else {"combine_with": lambda x: x}
    port = flexs_tpu_torch.Ensemble(_tf_landscapes(flexs_tpu_torch, names, device="cpu"), **kw)
    ref = flexs_tpu.Ensemble(_tf_landscapes(flexs_tpu, names), **kw)
    assert port.name == ref.name
    seqs = su.generate_random_sequences(8, 64, flexs_tpu_torch.DNAA, rng=np.random.default_rng(0))
    np.testing.assert_array_equal(port.get_fitness(seqs), ref.get_fitness(seqs))
    tokens = flexs_tpu_torch.Alphabet(flexs_tpu_torch.DNAA).encode(seqs)
    np.testing.assert_array_equal(port.fitness_from_tokens(tokens), ref.fitness_from_tokens(tokens))
    assert port.cost == ref.cost == 64


def test_ensemble_trains_only_models():
    class Recorder(flexs_tpu_torch.Model):
        def __init__(self):
            super().__init__("rec")
            self.seen = None

        def train(self, sequences, labels):
            self.seen = list(sequences)

        def _fitness_function(self, sequences):
            return np.zeros(len(sequences))

    rec = Recorder()
    landscape = flexs_tpu_torch.landscapes.TFBinding(name="SIX6_REF_R1", device="cpu")
    ens = flexs_tpu_torch.Ensemble([rec, landscape])
    ens.train(["AAAAAAAA"], [1.0])
    assert rec.seen == ["AAAAAAAA"]
    assert ens.name == "Ens(rec|TF_Binding)"


@pytest.mark.parametrize("alphabet", [flexs_tpu_torch.DNAA, flexs_tpu_torch.AAS])
def test_numpy_sequence_utils_equal_jax(alphabet):
    rng_t, rng_j = np.random.default_rng(1), np.random.default_rng(1)
    assert su.generate_random_sequences(12, 20, alphabet, rng=rng_t) == \
        jax_su.generate_random_sequences(12, 20, alphabet, rng=rng_j)
    wt = su.generate_random_sequences(12, 1, alphabet, rng=np.random.default_rng(2))[0]
    assert su.generate_single_mutants(wt, alphabet) == jax_su.generate_single_mutants(wt, alphabet)
    for _ in range(5):
        assert su.generate_random_mutant(wt, 0.3, alphabet, rng=rng_t) == \
            jax_su.generate_random_mutant(wt, 0.3, alphabet, rng=rng_j)
    one_hot = su.string_to_one_hot(wt, alphabet)
    np.testing.assert_array_equal(one_hot, jax_su.string_to_one_hot(wt, alphabet))
    assert su.one_hot_to_string(one_hot, alphabet) == wt == jax_su.one_hot_to_string(one_hot, alphabet)
    pwm = np.zeros_like(one_hot)
    pwm[[1, 4], [0, len(alphabet) - 1]] = 0.7
    np.testing.assert_array_equal(
        su.construct_mutant_from_sample(pwm, one_hot),
        jax_su.construct_mutant_from_sample(pwm, one_hot),
    )


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def test_random_mutants_shape_range_rate_and_determinism():
    tokens = torch.zeros((400, 50), dtype=torch.long)
    out = su.random_mutants(_gen(0), tokens, 0.2, 4)
    assert out.shape == tokens.shape and out.dtype == tokens.dtype
    assert int(out.min()) >= 0 and int(out.max()) < 4
    # A mutated residue resamples uniformly, so it changes with prob 0.2 * 3/4.
    assert abs(float((out != tokens).float().mean()) - 0.15) < 0.01
    assert torch.equal(out, su.random_mutants(_gen(0), tokens, 0.2, 4))
    assert not torch.equal(out, su.random_mutants(_gen(1), tokens, 0.2, 4))
    assert torch.equal(su.random_mutants(_gen(0), tokens, 0.0, 4), tokens)


def test_recombine_shape_rate_and_determinism():
    a = torch.zeros((300, 40), dtype=torch.long)
    b = torch.ones((300, 40), dtype=torch.long)
    child_a, child_b = su.recombine(_gen(0), a, b, 0.1)
    assert child_a.shape == a.shape and child_b.shape == b.shape
    # Each position comes from exactly one parent in each child.
    assert torch.equal(child_a + child_b, a + b)
    # The switch flips at each position with prob 0.1: the first position
    # takes parent a with prob 0.1.
    assert abs(float(child_a[:, 0].float().mean()) - 0.9) < 0.05
    again = su.recombine(_gen(0), a, b, 0.1)
    assert torch.equal(child_a, again[0]) and torch.equal(child_b, again[1])
    none_a, none_b = su.recombine(_gen(2), a, b, 0.0)
    assert torch.equal(none_a, b) and torch.equal(none_b, a)


@pytest.mark.parametrize("shape,alphabet_size", [((30, 40, 14), 4), ((17, 23, 9), 20)])
def test_hamming_distance_matrix_equals_jax(shape, alphabet_size):
    b, n, length = shape
    rng = np.random.default_rng(b)
    q = rng.integers(0, alphabet_size, (b, length))
    c = np.concatenate([q[:5], rng.integers(0, alphabet_size, (n - 5, length))])
    got = hamming.hamming_distance_matrix(q, c, alphabet_size)
    want = np.asarray(jax_hamming.hamming_distance_matrix(q, c, alphabet_size))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    mins, idx = hamming.min_hamming_and_argmin(got)
    want_min, want_idx = jax_hamming.min_hamming_and_argmin(want)
    np.testing.assert_array_equal(mins.numpy(), np.asarray(want_min))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))


def test_argmin_ties_go_to_the_first_index():
    dists = torch.tensor([[3, 1, 1, 2], [0, 0, 0, 0]], dtype=torch.int32)
    _, idx = hamming.min_hamming_and_argmin(dists)
    assert idx.tolist() == [1, 0]


@pytest.mark.parametrize("band", [1, 2, 3])
def test_banded_edit_distance_matrix_equals_jax(band):
    rng = np.random.default_rng(band)
    width = 10
    rows = []
    for _ in range(24):
        n = int(rng.integers(5, width + 1))
        row = np.full(width, -1)
        row[:n] = rng.integers(0, 4, n)
        rows.append(row)
    rows = np.array(rows)
    # Near neighbours: single edits of the first rows.
    near = rows[:8].copy()
    near[:, 2] = (near[:, 2] + 1) % 4
    cache = np.concatenate([rows[8:], near])
    got = hamming.banded_edit_distance_matrix(rows, cache, band=band)
    want = np.asarray(jax_hamming.banded_edit_distance_matrix(rows, cache, band=band))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    exact = hamming.edit_distance_matrix(rows, cache)
    np.testing.assert_array_equal(got.numpy(), np.minimum(exact, band + 1))
