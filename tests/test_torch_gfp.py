"""The port's GFP landscape (ProteinBERT oracle) held against the JAX package.

At hidden 64 and 2 layers (one head).  The port cannot replay `jax.random`,
so its seeded weights are its own; the forward pass is compared by carrying
the JAX package's Flax params across (`bert_params_from_flax`) and through
one synthetic TAPE checkpoint that both packages load.
"""
import math
import warnings

import jax
import numpy as np
import pytest
import torch

import flexs_tpu_torch
from flexs_tpu.landscapes import bert_gfp as jax_gfp
from flexs_tpu_torch.baselines.models.convert import bert_params_from_flax
from flexs_tpu_torch.landscapes import bert_gfp

HIDDEN, LAYERS = 64, 2
WT = bert_gfp.BertGFPBrightness.gfp_wt_sequence
SEQS = [WT, *bert_gfp.BertGFPBrightness.starts.values()]


def _port(**kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return bert_gfp.BertGFPBrightness(hidden=HIDDEN, layers=LAYERS, device="cpu", **kw)


@pytest.fixture(scope="module")
def jax_landscape():
    with pytest.warns(UserWarning, match="DETERMINISTIC"):
        return jax_gfp.BertGFPBrightness(model_path="/nonexistent", hidden=HIDDEN, layers=LAYERS)


@pytest.fixture(scope="module")
def carried(jax_landscape):
    """A port landscape holding the JAX landscape's seeded weights."""
    land = _port(model_path="/nonexistent")
    params = jax.tree.map(np.asarray, jax_landscape.params)
    land.module.load_state_dict(bert_params_from_flax(params))
    return land


def test_vocabulary_and_encoding_equal_jax():
    assert bert_gfp.IUPAC_TOKENS == jax_gfp.IUPAC_TOKENS and bert_gfp.VOCAB == jax_gfp.VOCAB
    seqs = SEQS + ["ACDJ", ""]  # J is not in the vocabulary: <unk>
    np.testing.assert_array_equal(bert_gfp.encode_tape(seqs, 256), jax_gfp.encode_tape(seqs, 256))
    assert bert_gfp.BertGFPBrightness.starts == jax_gfp.BertGFPBrightness.starts
    assert WT == jax_gfp.BertGFPBrightness.gfp_wt_sequence


def test_state_dict_keeps_flax_names(jax_landscape):
    """Every Flax leaf maps onto one port tensor of the same submodule path."""
    leaf = {"kernel": "weight", "scale": "weight", "embedding": "weight", "bias": "bias"}
    flat = jax.tree_util.tree_flatten_with_path(jax_landscape.params["params"])[0]
    flax_names = {".".join(k.key for k in path[:-1]) + "." + leaf[path[-1].key]
                  for path, _ in flat}
    assert flax_names == set(_port(model_path="/nonexistent").module.state_dict())


def test_forward_equals_flax(jax_landscape, carried):
    tokens = bert_gfp.encode_tape(SEQS + ["MSKGE", "A" * 200], 256)
    want = np.asarray(jax_landscape.module.apply(jax_landscape.params, tokens))
    with torch.no_grad():
        got = carried.module(torch.as_tensor(tokens).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(carried.get_fitness(SEQS), jax_landscape.get_fitness(SEQS),
                               rtol=0, atol=1e-5)


def test_device_fitness_equals_host_path(carried):
    alphabet = flexs_tpu_torch.Alphabet(flexs_tpu_torch.AAS)
    fn, params = carried.device_fitness()
    tokens = torch.as_tensor(alphabet.encode(SEQS)).long()
    got = fn(params, tokens)
    assert torch.equal(got, carried.fitness_from_tokens(tokens))
    # One chunk shape everywhere, so the paths agree bit for bit.
    np.testing.assert_array_equal(got.numpy().astype(np.float64), carried.get_fitness(SEQS))


def test_scores_do_not_depend_on_the_batch(carried):
    alone = [carried.get_fitness([s])[0] for s in SEQS]
    np.testing.assert_array_equal(carried.get_fitness(SEQS), alone)
    tokens = torch.as_tensor(bert_gfp.encode_tape(SEQS, 256)).long()
    with torch.no_grad():
        unchunked = carried.module(tokens).numpy()
    np.testing.assert_allclose(_port(model_path="/nonexistent", batch_size=3).get_fitness(SEQS),
                               _port(model_path="/nonexistent").get_fitness(SEQS), atol=1e-6)
    np.testing.assert_allclose(carried.get_fitness(SEQS), unchunked, rtol=0, atol=1e-6)


def test_fully_padded_rows_stay_finite(carried):
    tokens = torch.zeros((3, 256), dtype=torch.long)
    tokens[1, :5] = torch.tensor([2, 5, 6, 7, 3])
    with torch.no_grad():
        out = carried.module(tokens)
    assert torch.isfinite(out).all()


def test_seeded_oracle_warns_and_repeats():
    with pytest.warns(UserWarning, match="DETERMINISTIC"):
        a = bert_gfp.BertGFPBrightness(model_path="/nonexistent", hidden=HIDDEN, layers=LAYERS,
                                       device="cpu")
    b, c = _port(model_path="/nonexistent"), _port(model_path="/nonexistent", seed=1)
    scores = a.get_fitness(SEQS)
    assert np.isfinite(scores).all() and len(set(np.round(scores, 6))) == len(SEQS)
    np.testing.assert_array_equal(scores, b.get_fitness(SEQS))
    assert not np.array_equal(scores, c.get_fitness(SEQS))
    assert a.name == "GFP" and a.module.max_len == 256 and a.max_len == 240


def test_allow_download_raises():
    with pytest.raises(NotImplementedError, match="network"):
        bert_gfp.BertGFPBrightness(allow_download=True, hidden=HIDDEN, layers=LAYERS,
                                   device="cpu")


def test_own_checkpoint_round_trip(tmp_path, carried):
    torch.save(carried.module.state_dict(), tmp_path / "torch_params.pt")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        loaded = bert_gfp.BertGFPBrightness(model_path=str(tmp_path), hidden=HIDDEN,
                                            layers=LAYERS, device="cpu")
    np.testing.assert_array_equal(loaded.get_fitness(SEQS), carried.get_fitness(SEQS))


def _tape_checkpoint(seed, wn_dim, prefix="predict.value_prediction.main", max_pos=512):
    """A TAPE ProteinBertForValuePrediction state dict (random weights, TAPE's keys).

    The value head's Linears are weight-normed: `weight_g` is a scalar
    (dim=None) or one magnitude per output row (dim=0).
    """
    gen = torch.Generator().manual_seed(seed)

    def rand(*shape, scale=0.1):
        return torch.randn(shape, generator=gen) * scale

    sd = {
        "bert.embeddings.word_embeddings.weight": rand(len(bert_gfp.VOCAB), HIDDEN),
        "bert.embeddings.position_embeddings.weight": rand(max_pos, HIDDEN),
        "bert.embeddings.token_type_embeddings.weight": rand(1, HIDDEN),
        "bert.embeddings.LayerNorm.weight": 1 + rand(HIDDEN),
        "bert.embeddings.LayerNorm.bias": rand(HIDDEN),
    }

    def linear(name, n_in, n_out):
        sd[name + ".weight"] = rand(n_out, n_in, scale=1 / math.sqrt(n_in))
        sd[name + ".bias"] = rand(n_out)

    for i in range(LAYERS):
        p = f"bert.encoder.layer.{i}."
        for name in ("query", "key", "value"):
            linear(p + "attention.self." + name, HIDDEN, HIDDEN)
        linear(p + "attention.output.dense", HIDDEN, HIDDEN)
        linear(p + "intermediate.dense", HIDDEN, 4 * HIDDEN)
        linear(p + "output.dense", 4 * HIDDEN, HIDDEN)
        for norm in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[p + norm + ".gamma"] = 1 + rand(HIDDEN)  # TAPE's older gamma/beta names
            sd[p + norm + ".beta"] = rand(HIDDEN)
    linear("bert.pooler.dense", HIDDEN, HIDDEN)
    for idx, (n_in, n_out) in ((0, (HIDDEN, 512)), (3, (512, 1))):
        name = f"{prefix}.{idx}"
        sd[name + ".weight_v"] = rand(n_out, n_in, scale=1 / math.sqrt(n_in))
        g_shape = () if wn_dim is None else (n_out, 1)
        sd[name + ".weight_g"] = 0.5 + rand(*g_shape).abs()
        sd[name + ".bias"] = rand(n_out)
    return sd


def _tape_forward(sd, ids, prefix="predict.value_prediction.main"):
    """TAPE's forward over its own state dict: post-LN BERT, erf gelu, -10000 masking."""
    def lin(x, name):
        if name + ".weight" in sd:
            w = sd[name + ".weight"]
        else:
            v, g = sd[name + ".weight_v"], sd[name + ".weight_g"]
            norm = v.norm() if g.dim() == 0 else v.norm(dim=1, keepdim=True)
            w = g * v / norm
        return x @ w.T + sd[name + ".bias"]

    def ln(x, name):
        w = sd.get(name + ".weight", sd.get(name + ".gamma"))
        b = sd.get(name + ".bias", sd.get(name + ".beta"))
        return torch.nn.functional.layer_norm(x, (HIDDEN,), w, b, eps=1e-12)

    e = "bert.embeddings."
    length = ids.shape[1]
    x = (sd[e + "word_embeddings.weight"][ids] + sd[e + "position_embeddings.weight"][:length]
         + sd[e + "token_type_embeddings.weight"][0])
    x = ln(x, e + "LayerNorm")
    add_mask = (ids == 0).float()[:, None, None, :] * -10000.0
    for i in range(LAYERS):
        p = f"bert.encoder.layer.{i}."
        q, k, v = (lin(x, p + "attention.self." + n) for n in ("query", "key", "value"))
        scores = (q @ k.transpose(1, 2))[:, None] / math.sqrt(HIDDEN) + add_mask
        attn = torch.softmax(scores, dim=-1)[:, 0] @ v
        x = ln(x + lin(attn, p + "attention.output.dense"), p + "attention.output.LayerNorm")
        h = lin(x, p + "intermediate.dense")
        h = h * 0.5 * (1.0 + torch.erf(h / math.sqrt(2.0)))
        x = ln(x + lin(h, p + "output.dense"), p + "output.LayerNorm")
    pooled = torch.tanh(lin(x[:, 0], "bert.pooler.dense"))
    return lin(torch.relu(lin(pooled, f"{prefix}.0")), f"{prefix}.3").squeeze(-1)


@pytest.mark.parametrize("wn_dim", [None, 0], ids=["weight_norm_dim_None", "weight_norm_dim_0"])
def test_tape_checkpoint_loads_like_jax_and_torch(tmp_path, wn_dim):
    sd = _tape_checkpoint(seed=3, wn_dim=wn_dim)
    torch.save(sd, tmp_path / "pytorch_model.bin")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        port = bert_gfp.BertGFPBrightness(model_path=str(tmp_path), hidden=HIDDEN,
                                          layers=LAYERS, device="cpu")
    jax_land = jax_gfp.BertGFPBrightness(model_path=str(tmp_path), hidden=HIDDEN, layers=LAYERS)
    with torch.no_grad():
        want = _tape_forward(sd, torch.as_tensor(bert_gfp.encode_tape(SEQS, 256)).long())
    got = port.get_fitness(SEQS)
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got, jax_land.get_fitness(SEQS), rtol=0, atol=1e-4)


def test_tape_checkpoint_without_a_head_falls_back_to_the_seeded_oracle(tmp_path):
    sd = _tape_checkpoint(seed=4, wn_dim=None, prefix="predict.other")
    torch.save(sd, tmp_path / "pytorch_model.bin")
    with pytest.warns(UserWarning) as caught:
        land = bert_gfp.BertGFPBrightness(model_path=str(tmp_path), hidden=HIDDEN,
                                          layers=LAYERS, device="cpu")
    messages = " ".join(str(w.message) for w in caught)
    assert "value-prediction head" in messages and "DETERMINISTIC" in messages
    np.testing.assert_array_equal(land.get_fitness(SEQS),
                                  _port(model_path="/nonexistent").get_fitness(SEQS))


def test_fused_run_and_three_start_sweep(carried):
    from flexs_tpu_torch.parallel import run_landscape_robustness_sweep

    starts = list(bert_gfp.BertGFPBrightness.starts.values())
    kw = dict(rounds=1, sequences_batch_size=3, model_queries_per_batch=10, device="cpu")
    df, _ = flexs_tpu_torch.runtime.DeviceAdaleadNAM(
        carried, flexs_tpu_torch.AAS, starting_sequence=starts[0], signal_strength=0.9, seed=0,
        **kw).run(verbose=False)
    assert df["round"].max() == 1 and np.isfinite(df["true_score"]).all()
    np.testing.assert_array_equal(df["true_score"].to_numpy(),
                                  carried.get_fitness(df["sequence"].tolist()))
    sweep = run_landscape_robustness_sweep([carried], flexs_tpu_torch.AAS, starts, [0.9],
                                           seeds=[0], cell_mode="vmap", **kw)
    assert sweep["start"].tolist() == starts
    first = sweep.iloc[0]
    assert first["max_fitness"] == df["true_score"].max()
    assert first["model_cost"] == df["model_cost"].iloc[-1]
