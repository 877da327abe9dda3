"""GFP brightness landscape: a ProteinBERT regression oracle in PyTorch.

Contract (reference flexs/landscapes/bert_gfp.py):
  * name "GFP"; `gfp_wt_sequence` and the three starting sequences at edit
    distance 10/18/31 are class attributes (:36-47, reproduced verbatim:
    benchmark data).
  * The oracle is TAPE's ProteinBert transformer with a value-prediction
    head, fine-tuned on the Sarkisyan et al. fluorescence data (:59-96).

The transformer is the JAX package's Flax BERT rebuilt as `nn.Module`s with
Flax's submodule names (12 layers, hidden 768, 12 heads: TAPE's
`bert-base`).  As there: post-LayerNorm layers with Flax's eps 1e-6, the
exact erf gelu, the query scaled by 1/sqrt(head_dim) before the product,
masked logits filled with the dtype's minimum (not -inf, so the fully
masked rows of padding stay finite), the pooled output `tanh(pooler(x[:,
0]))` and TAPE's two-layer value head.

Scoring runs in chunks of `batch_size` rows, the last chunk padded with
empty rows, so every matrix product has one shape: a sequence's score does
not depend on the batch it came in (fused run, host run and sweep cells
agree bit for bit) and the attention scores of a chunk stay small.

Weights, resolved in the JAX package's order; there is no network here:
  1. the port's own checkpoint, `<model_path>/torch_params.pt`, a state
     dict of `ProteinBertRegressor`;
  2. a TAPE `pytorch_model.bin` in `model_path`, loaded with
     `torch.load(weights_only=True)` and mapped key by key
     (`tape_state_dict`);
  3. otherwise a DETERMINISTIC seeded initialization with a loud warning:
     the landscape is a well-defined, reproducible, synthetic oracle.  Its
     weights are drawn by `torch.Generator(seed)` and differ from the JAX
     package's seeded weights (torch cannot replay `jax.random`).
"""
import math
import os
import warnings
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from flexs_tpu_torch.alphabet import AAS
from flexs_tpu_torch.device import resolve_device
from flexs_tpu_torch.landscape import Landscape
from flexs_tpu_torch.ops.padding import next_bucket
from flexs_tpu_torch.types import SEQUENCES_TYPE

# TAPE iupac vocabulary (tape.tokenizers.IUPAC_VOCAB ordering).
IUPAC_TOKENS = ["<pad>", "<mask>", "<cls>", "<sep>", "<unk>"] + list(
    "ABCDEFGHIKLMNOPQRSTUVWXYZ"
)
VOCAB = {tok: i for i, tok in enumerate(IUPAC_TOKENS)}

_LN_EPS = 1e-6  # Flax LayerNorm's epsilon


class _Attention(nn.Module):
    """Flax `MultiHeadDotProductAttention` (self-attention, no dropout)."""

    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(hidden, hidden)
        self.key = nn.Linear(hidden, hidden)
        self.value = nn.Linear(hidden, hidden)
        self.out = nn.Linear(hidden, hidden)

    def forward(self, x, mask):
        b, length, hidden = x.shape
        depth = hidden // self.heads

        def split(t):  # [B, L, hidden] -> [B, heads, L, depth]
            return t.view(b, length, self.heads, depth).transpose(1, 2)

        q = split(self.query(x)) / math.sqrt(depth)
        logits = q @ split(self.key(x)).transpose(-1, -2)
        logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
        ctx = torch.softmax(logits, dim=-1) @ split(self.value(x))
        return self.out(ctx.transpose(1, 2).reshape(b, length, hidden))


class BertLayer(nn.Module):
    """Post-LayerNorm transformer encoder layer (BERT-base style)."""

    def __init__(self, hidden: int, heads: int, intermediate: int):
        super().__init__()
        self.attention = _Attention(hidden, heads)
        self.attention_norm = nn.LayerNorm(hidden, eps=_LN_EPS)
        self.intermediate = nn.Linear(hidden, intermediate)
        self.output = nn.Linear(intermediate, hidden)
        self.output_norm = nn.LayerNorm(hidden, eps=_LN_EPS)

    def forward(self, x, mask):
        x = self.attention_norm(x + self.attention(x, mask))
        h = self.output(F.gelu(self.intermediate(x)))  # exact erf gelu, as TAPE
        return self.output_norm(x + h)


class ProteinBertRegressor(nn.Module):
    """BERT encoder + pooled value-prediction head (TAPE architecture)."""

    def __init__(
        self,
        vocab_size: int = len(IUPAC_TOKENS),
        hidden: int = 768,
        layers: int = 12,
        heads: int = 12,
        intermediate: int = 3072,
        max_len: int = 512,
    ):
        super().__init__()
        self.hidden, self.layers, self.heads, self.max_len = hidden, layers, heads, max_len
        self.token_embed = nn.Embedding(vocab_size, hidden)
        self.pos_embed = nn.Embedding(max_len, hidden)
        self.embed_norm = nn.LayerNorm(hidden, eps=_LN_EPS)
        for i in range(layers):
            setattr(self, f"layer_{i}", BertLayer(hidden, heads, intermediate))
        self.pooler = nn.Linear(hidden, hidden)
        # TAPE's ValuePredictionHead is SimpleMLP(hidden, 512, 1): two
        # weight-normed Linears with a ReLU between them.
        self.value_hidden = nn.Linear(hidden, 512)
        self.value_out = nn.Linear(512, 1)

    def forward(self, tokens):
        """f32[B] of int64[B, L] vocabulary ids (L <= max_len, 0 = <pad>)."""
        pad = tokens != VOCAB["<pad>"]
        x = self.token_embed(tokens) + self.pos_embed.weight[: tokens.shape[1]][None]
        x = self.embed_norm(x)
        mask = pad[:, None, None, :] & pad[:, None, :, None]
        for i in range(self.layers):
            x = getattr(self, f"layer_{i}")(x, mask)
        pooled = torch.tanh(self.pooler(x[:, 0]))
        return self.value_out(torch.relu(self.value_hidden(pooled))).squeeze(-1)


def _seeded_init(module: ProteinBertRegressor, seed: int) -> None:
    """Fill `module`'s weights from `torch.Generator(seed)`, in Flax's init families.

    Dense kernels: LeCun truncated normal; embeddings: normal with
    variance 1 / hidden; biases 0; LayerNorm scales 1.  Drawn on the CPU,
    so every device gets the same weights.
    """
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Linear):
                # Flax's lecun_normal: truncated at 2 sigma, rescaled to unit variance.
                std = math.sqrt(1.0 / m.in_features) / 0.87962566103423978
                w = torch.empty(m.weight.shape)
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=gen)
                m.weight.copy_(w)
                m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                w = torch.empty(m.weight.shape)
                nn.init.normal_(w, std=math.sqrt(1.0 / m.embedding_dim), generator=gen)
                m.weight.copy_(w)
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()


def encode_tape(sequences, max_len: int) -> np.ndarray:
    """TAPE-style encoding: <cls> + residues + <sep>, padded with <pad>."""
    out = np.full((len(sequences), max_len), VOCAB["<pad>"], np.int32)
    for i, seq in enumerate(sequences):
        ids = (
            [VOCAB["<cls>"]]
            + [VOCAB.get(c, VOCAB["<unk>"]) for c in seq]
            + [VOCAB["<sep>"]]
        )
        out[i, : len(ids)] = ids
    return out


def tape_state_dict(raw: dict, module: ProteinBertRegressor) -> dict:
    """`module`'s state dict from a TAPE ProteinBertForValuePrediction state dict.

    TAPE's layout (the checkpoint the reference loads, bert_gfp.py:75-96):
    HF-style encoder keys under ``bert.``; LayerNorms as weight/bias or
    gamma/beta; token-type embeddings, folded into the position table since
    every token-type id is 0; a tanh pooler; and a value head whose SimpleMLP
    wraps both Linears in torch ``weight_norm`` (``weight_g``/``weight_v``,
    with dim=None or dim=0).  Position rows past the checkpoint's keep
    `module`'s values.  Weight-normed weights are resolved in numpy as the
    JAX package's converter does.
    """
    if "state_dict" in raw:
        raw = raw["state_dict"]
    sd = {}
    for k, v in raw.items():
        k = k.replace("module.", "")
        if k.startswith("bert."):
            k = k[len("bert."):]
        sd[k] = v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)

    def norm_pair(prefix):
        """LayerNorm (weight, bias), accepting weight/bias or gamma/beta."""
        if prefix + ".weight" in sd:
            return sd[prefix + ".weight"], sd[prefix + ".bias"]
        return sd[prefix + ".gamma"], sd[prefix + ".beta"]

    def linear(prefix):
        """(weight [out, in], bias) of a Linear, resolving torch weight_norm."""
        if prefix + ".weight" in sd:
            return sd[prefix + ".weight"], sd[prefix + ".bias"]
        g = sd[prefix + ".weight_g"]
        v = sd[prefix + ".weight_v"]
        if g.size == 1:  # weight_norm(dim=None): scalar magnitude
            w = v * (float(g.reshape(-1)[0]) / np.linalg.norm(v))
        else:  # weight_norm(dim=0): per-output-row magnitude
            w = v * (
                g.reshape(-1, 1)
                / np.linalg.norm(v.reshape(v.shape[0], -1), axis=1, keepdims=True)
            )
        return w, sd[prefix + ".bias"]

    out = {k: v.detach().cpu().numpy().copy() for k, v in module.state_dict().items()}

    def put(name, weight, bias):
        out[name + ".weight"], out[name + ".bias"] = weight, bias

    out["token_embed.weight"] = sd["embeddings.word_embeddings.weight"]
    pos = sd["embeddings.position_embeddings.weight"]
    n_pos = min(module.max_len, pos.shape[0])
    pos = np.array(pos[:n_pos])
    if "embeddings.token_type_embeddings.weight" in sd:
        pos = pos + sd["embeddings.token_type_embeddings.weight"][0][None]
    out["pos_embed.weight"][:n_pos] = pos
    put("embed_norm", *norm_pair("embeddings.LayerNorm"))
    for i in range(module.layers):
        src, dst = f"encoder.layer.{i}.", f"layer_{i}."
        for name in ("query", "key", "value"):
            put(dst + "attention." + name, *linear(src + "attention.self." + name))
        put(dst + "attention.out", *linear(src + "attention.output.dense"))
        put(dst + "attention_norm", *norm_pair(src + "attention.output.LayerNorm"))
        put(dst + "intermediate", *linear(src + "intermediate.dense"))
        put(dst + "output", *linear(src + "output.dense"))
        put(dst + "output_norm", *norm_pair(src + "output.LayerNorm"))
    put("pooler", *linear("pooler.dense"))
    # TAPE's SimpleMLP: Sequential(weight_norm Linear, ReLU, Dropout,
    # weight_norm Linear) under `predict.value_prediction.main.{0,3}`; older
    # exports may lack the `main.` level or weight_norm.
    for prefix, hidden_i, out_i in [
        ("predict.value_prediction.main", 0, 3),
        ("predict.value_prediction", 0, 3),
        ("predict.value_prediction", 0, 2),
    ]:
        if any(f"{prefix}.{hidden_i}{sfx}" in sd and f"{prefix}.{out_i}{sfx}" in sd
               for sfx in (".weight", ".weight_v")):
            break
    else:
        raise KeyError(
            "no value-prediction head found in checkpoint; keys: "
            + ", ".join(k for k in sd if "predict" in k)
        )
    put("value_hidden", *linear(f"{prefix}.{hidden_i}"))
    put("value_out", *linear(f"{prefix}.{out_i}"))
    return {k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in out.items()}


class GFPFitnessParams(NamedTuple):
    """What `_gfp_fitness` reads, on the landscape's device."""

    module: ProteinBertRegressor  # the architecture; its weights come from `weights`
    weights: dict  # name -> tensor, the module's state dict
    aas_to_vocab: torch.Tensor  # int64[20], AAS token -> vocabulary id
    chunk: int  # rows per forward pass


def _score_ids(params: GFPFitnessParams, ids):
    """f32[B] of int64[B, max_len] vocabulary ids, in padded chunks of `params.chunk`."""
    out = torch.empty(ids.shape[0], device=ids.device)
    chunk = params.chunk
    with torch.no_grad():
        for start in range(0, ids.shape[0], chunk):
            part = ids[start:start + chunk]
            n = part.shape[0]
            if n < chunk:
                part = torch.cat([part, part.new_zeros((chunk - n, part.shape[1]))])
            scores = torch.func.functional_call(params.module, params.weights, (part,))
            out[start:start + n] = scores[:n]
    return out


def _gfp_fitness(params: GFPFitnessParams, tokens):
    """Pure fitness f32[B] of int64[B, L] AAS tokens (encoded on the device).

    Module-level, so every GFP landscape shares it.
    """
    b, length = tokens.shape
    max_len = params.module.max_len
    ids = torch.full((b, max_len), VOCAB["<pad>"], dtype=torch.long, device=tokens.device)
    ids[:, 0] = VOCAB["<cls>"]
    ids[:, 1:length + 1] = params.aas_to_vocab[tokens]
    ids[:, length + 1] = VOCAB["<sep>"]
    return _score_ids(params, ids)


class BertGFPBrightness(Landscape):
    """Green fluorescent protein brightness landscape.

    Attributes:
        gfp_wt_sequence: Wild-type jellyfish GFP sequence.
        starts: Starting sequences at edit distance 10/18/31 from wild type.
    """

    gfp_wt_sequence = (
        "MSKGEELFTGVVPILVELDGDVNGHKFSVSGEGEGDATYGKLTLKFICTTGKLPVPWPTLVT"
        "TLSYGVQCFSRYPDHMKQHDFFKSAMPEGYVQERTIFFKDDGNYKTRAEVKFEGDTLVNRIE"
        "LKGIDFKEDGNILGHKLEYNYNSHNVYIMADKQKNGIKVNFKIRHNIEDGSVQLADHYQQNT"
        "PIGDGPVLLPDNHYLSTQSALSKDPNEKRDHMVLLEFVTAAGITHGMDELYK"
    )

    starts = {
        "ed_10_wt": "MSKGEVLFTGVVPILVEMDGDVNGHKFSVSGEGEGDATYGKLTTKFTCTTGKLPVPWPTKVTTLSYRVQCFSRYPDVMKQHDFFKSAMPEGYVQERTIFFKDDGNYKTRAEVQFEGDTLVNRIELKGIDFKEDGNILGHKLEYNYNSHNVYIMADKQKNGIKVNFKIRHNIEDGSVQLADHYQQNTPIGDGPVLLPDNHYLSTQSALSKDPNIKRDCMVLLEFVTAAGITHGMDELYK",  # noqa: E501
        "ed_18_wt": "MSKGEHLFTGVVPILVELDGDVNGKKFSVSGEGQGDATYGKLTLKFICTTAKVHVPWCTLVTTLSYGVQCFSRYPDHMKQHDFFKGAMPEGYVQERTIFFKDIGNYKLRAEVKFEGDTLVNRIELKGIDFKEDGNIHGHKLEYNYNSQNVYIMASKQKNGIKVNFKIRLNIEDGSVQLAEHYQVNTPIGDFPVLLPDNHKLSAQSADSKDPNEKRDHMHLLEFVTAVGITHGMDELYK",  # noqa: E501
        "ed_31_wt": "MSKGEELFSGVQPILVELDGCVNGHKFSVSGEGEIDATYGKLTLKFICTTWKLPMPWPCLVTFGSYGVQCFSRYRDHPKQHDFFKSAVPEGYVQERTIFMKDDLLYKTRAEVKFEGLTLVNRIELKGKDFKEDGNILGHKLEYNYNSHCVYPMADWNKNWIKVNSKIRLPIEDGSVILADHYQQNTPIGDQPVLLPENHYLSTQSALSKDPEEKGDLMVLLEFVTAAGITHGMDELYK",  # noqa: E501
    }

    def __init__(
        self,
        model_path: str = "fluorescence-model",
        allow_download: bool = False,
        batch_size: int = 32,
        seed: int = 0,
        hidden: int = 768,
        layers: int = 12,
        device=None,
    ):
        """Create the GFP landscape.

        Args:
            model_path: Directory holding `torch_params.pt` (the port's own
                checkpoint) or a TAPE `pytorch_model.bin`.
            allow_download: The reference's S3 download; raises
                NotImplementedError, since the port has no network.
            batch_size: Rows per forward pass (reference uses 32).
            seed: Init seed for the synthetic-fallback oracle.
            hidden / layers: Architecture size (defaults = bert-base; tests
                shrink these for speed).
            device: Where the weights live and scoring runs (default
                "cuda"; pass "cpu" for the CPU).
        """
        super().__init__(name="GFP")
        if allow_download:
            raise NotImplementedError(
                "allow_download: the port has no network; put the checkpoint in model_path"
            )
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self.max_len = len(self.gfp_wt_sequence) + 2
        self.module = ProteinBertRegressor(
            hidden=hidden,
            layers=layers,
            heads=max(1, hidden // 64),
            intermediate=4 * hidden,
            max_len=next_bucket(self.max_len, minimum=256),
        )
        self._resolve_weights(model_path, seed)
        self.module.requires_grad_(False).eval().to(self.device)
        self._fitness_params = GFPFitnessParams(
            self.module,
            dict(self.module.state_dict()),
            torch.as_tensor([VOCAB.get(c, VOCAB["<unk>"]) for c in AAS], device=self.device),
            batch_size,
        )

    def _resolve_weights(self, model_path: str, seed: int) -> None:
        own_ckpt = os.path.join(model_path, "torch_params.pt")
        tape_ckpt = os.path.join(model_path, "pytorch_model.bin")
        if os.path.exists(own_ckpt):
            self.module.load_state_dict(torch.load(own_ckpt, map_location="cpu",
                                                   weights_only=True))
            return
        _seeded_init(self.module, seed)
        if os.path.exists(tape_ckpt):
            raw = torch.load(tape_ckpt, map_location="cpu", weights_only=True)
            try:
                self.module.load_state_dict(tape_state_dict(raw, self.module))
                return
            except (KeyError, ValueError, RuntimeError) as e:
                warnings.warn(f"TAPE checkpoint conversion failed: {e!r}")
        warnings.warn(
            "BertGFPBrightness: no pretrained weights found at "
            f"{model_path!r}; using a DETERMINISTIC seeded initialization. "
            "The landscape is a well-defined synthetic oracle but does NOT "
            "reproduce TAPE fluorescence predictions."
        )

    def device_fitness(self):
        """(pure fitness fn, params) pair for the fused runner and the sweeps."""
        return _gfp_fitness, self._fitness_params

    def fitness_from_tokens(self, tokens) -> torch.Tensor:
        """f32[B] fitness of int[B, L] AAS tokens, on the landscape's device."""
        tokens = torch.as_tensor(tokens, device=self.device).long()
        return _gfp_fitness(self._fitness_params, tokens)

    def _fitness_function(self, sequences: SEQUENCES_TYPE) -> np.ndarray:
        ids = torch.as_tensor(encode_tape(list(sequences), self.module.max_len),
                              device=self.device).long()
        return _score_ids(self._fitness_params, ids).cpu().numpy().astype(np.float64)
