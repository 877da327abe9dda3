"""Each plain reference against the port on small inputs, and the lower precisions they reject."""
import json
import os

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.families import bert_gfp as gfp_family
from benchmark.reference import bert_gfp as gfp_ref
from benchmark.reference import hamming
from benchmark.reference import tf_binding as tf_ref
from benchmark.tests import tiny


def _config(name):
    with open(os.path.join(tiny.ROOT, "benchmark", "configs", name + ".json")) as f:
        return json.load(f)


def test_tf_binding_reference_equals_the_port_bitwise():
    from flexs_tpu_torch.landscapes import tf_binding

    config = _config("tfbind8-adalead-nam")
    ref = tf_ref.Reference(config, tiny.ROOT, {}, "cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 4, (500, 8))
    for name in ("SIX6_REF_R1", ref.names[0], ref.names[-1], ref.names[117]):
        port = tf_binding.TFBinding(name=name, device="cpu").fitness_from_tokens(tokens)
        assert np.array_equal(ref.truth(name, tokens), port.numpy().astype(np.float64))


def _small_gfp():
    config = _config("gfp-adalead-nam")
    config.update(tiny.TINY["gfp-adalead-nam.run1"]["config"])
    weights = gfp_ref.make_weights(config, 12345, "cpu")
    return config, weights


@pytest.mark.parametrize("length,alphabet", [(8, 4), (238, 20)])
def test_hamming_reference_equals_the_port_distance_op(length, alphabet):
    """The masked lookup of the fused runner against numpy over the unpacked rows, both widths."""
    from flexs_tpu_torch.ops import packed_hamming

    rng = np.random.default_rng(length)
    bits, per_word, _ = packed_hamming.packing_spec(length, alphabet)
    cache = rng.integers(0, alphabet, (50, length))
    queries = cache[rng.integers(0, 50, 20)].copy()
    flip = rng.random(queries.shape) < 0.2
    queries[flip] = rng.integers(0, alphabet, flip.sum())
    queries[0] = cache[3]  # a cached row: distance 0
    q_pk = packed_hamming.pack_tokens(torch.as_tensor(queries), alphabet, length=length)
    c_pk = packed_hamming.pack_tokens(torch.as_tensor(cache), alphabet, length=length)
    assert np.array_equal(hamming.unpack(q_pk.numpy(), bits, per_word, length), queries)
    port = packed_hamming.packed_hamming_matrix(q_pk, c_pk, bits, per_word).numpy()
    ref = hamming.masked_distances(q_pk.numpy(), c_pk.numpy(), 50, bits, per_word, length)
    assert np.array_equal(port, ref) and ref.min() == 0 and ref.max() >= 2
    masked = hamming.masked_distances(q_pk.numpy(), c_pk.numpy(), 30, bits, per_word, length)
    assert (masked[:, 30:] == length + 1).all() and np.array_equal(masked[:, :30], ref[:, :30])


def test_gfp_reference_matches_the_port():
    config, weights = _small_gfp()
    land = gfp_family.landscape(config, {"weights": weights}, "cpu")
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 20, (40, 238))
    port = land.fitness_from_tokens(tokens).numpy().astype(np.float64)
    ref = gfp_ref.Reference(config, tiny.ROOT, {"weights": weights}, "cpu").truth("GFP", tokens)
    assert np.abs(port - ref).max() / np.abs(ref).max() < 1e-5
    assert np.std(ref) > 0  # the rows' scores differ


def test_a_bf16_bert_forward_fails_the_gfp_comparison():
    config, weights = _small_gfp()
    limit = _config("gfp-adalead-nam")["limits"]["oracle_gap"]
    tokens = np.random.default_rng(2).integers(0, 20, (64, 238))
    ref = gfp_ref.Reference(config, tiny.ROOT, {"weights": weights}, "cpu")
    f32 = ref.truth("GFP", tokens)
    bf16 = ref.truth("GFP", tokens, dtype=torch.bfloat16)
    assert np.abs(bf16 - f32).max() / np.abs(f32).max() > 3 * limit


def test_weights_come_from_the_seed():
    config, a = _small_gfp()
    b = gfp_ref.make_weights(config, 12345, "cpu")
    c = gfp_ref.make_weights(config, 12346, "cpu")
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["layer_0.attention.query.weight"], c["layer_0.attention.query.weight"])
    spec = run.load_cell(tiny.root_of("gfp-adalead-nam.run1"), "gfp-adalead-nam.run1")
    assert spec.config["hidden"] == 768 and spec.config["layers"] == 12
