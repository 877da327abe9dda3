"""Plain reference of the GFP oracle: TAPE's ProteinBERT with a value head, in plain torch.

A frozen float32 copy of the forward that TAPE publishes (Rao et al. 2019,
arXiv:1906.08230; the FLEXS GFP landscape loads it): token and position
embeddings, post-LayerNorm encoder layers (eps 1e-6), the exact erf gelu,
the query scaled by 1/sqrt(head size) before its product with the keys,
the pooled output tanh(pooler(x[:, 0])) and a two-layer value head with a
ReLU between.  A row is <cls> + residues + <sep> and nothing else, so no
position is padded.  Matrix products run with TF32 off.

The weights are made here from the seed, on the device, in a few large
calls (`make_weights`); the benchmark hands the same tensors to the
program.  This file imports numpy and torch only.
"""
import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# TAPE's IUPAC vocabulary, in its order.
TOKENS = ["<pad>", "<mask>", "<cls>", "<sep>", "<unk>"] + list("ABCDEFGHIKLMNOPQRSTUVWXYZ")
VOCAB = {t: i for i, t in enumerate(TOKENS)}
LN_EPS = 1e-6
VALUE_HIDDEN = 512
ROWS_PER_BLOCK = 64


def leaves(config) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, kind) of every weight; kind is "dense", "embed", "bias" or "scale"."""
    h, i, n = config["hidden"], config["intermediate"], config["layers"]
    out = [("token_embed.weight", (len(TOKENS), h), "embed"),
           ("pos_embed.weight", (config["positions"], h), "embed"),
           ("embed_norm.weight", (h,), "scale"), ("embed_norm.bias", (h,), "bias")]

    def dense(name, fan_out, fan_in):
        out.extend([(name + ".weight", (fan_out, fan_in), "dense"), (name + ".bias", (fan_out,), "bias")])

    for k in range(n):
        p = f"layer_{k}."
        for proj in ("query", "key", "value", "out"):
            dense(p + "attention." + proj, h, h)
        out.extend([(p + "attention_norm.weight", (h,), "scale"), (p + "attention_norm.bias", (h,), "bias")])
        dense(p + "intermediate", i, h)
        dense(p + "output", h, i)
        out.extend([(p + "output_norm.weight", (h,), "scale"), (p + "output_norm.bias", (h,), "bias")])
    dense("pooler", h, h)
    dense("value_hidden", VALUE_HIDDEN, h)
    dense("value_out", 1, VALUE_HIDDEN)
    return out


def make_weights(config, seed: int, device) -> Dict[str, torch.Tensor]:
    """float32 weights from `seed`, drawn on `device` by one generator in one buffer.

    Dense kernels: normal truncated at 2 sigma, rescaled to variance 1 / fan_in
    (Flax's lecun_normal); embeddings: the same at variance 1 / hidden;
    biases 0, LayerNorm scales 1.
    """
    spec = leaves(config)
    drawn = [(n, s, k) for n, s, k in spec if k in ("dense", "embed")]
    total = sum(math.prod(s) for _, s, _ in drawn)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.empty(total, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(flat, std=1.0, a=-2.0, b=2.0, generator=gen)
    flat /= 0.87962566103423978  # a unit normal truncated at 2 sigma has this std
    out, at = {}, 0
    for name, shape, kind in drawn:
        size = math.prod(shape)
        fan_in = shape[1] if kind == "dense" else config["hidden"]
        out[name] = flat[at:at + size].view(shape).mul_(math.sqrt(1.0 / fan_in))
        at += size
    for name, shape, kind in spec:
        if kind == "bias":
            out[name] = torch.zeros(shape, device=device)
        elif kind == "scale":
            out[name] = torch.ones(shape, device=device)
    return {name: out[name] for name, _, _ in spec}


def encode(sequences: List[str]) -> np.ndarray:
    """int64[n, len + 2]: <cls> + residues + <sep> of sequences of one length."""
    return np.array([[VOCAB["<cls>"]] + [VOCAB.get(c, VOCAB["<unk>"]) for c in s] + [VOCAB["<sep>"]]
                     for s in sequences], np.int64)


def forward(w: Dict[str, torch.Tensor], ids: torch.Tensor, config, dtype=torch.float32):
    """f32[n] value predictions of int64[n, T] ids, every position real, computed in `dtype`."""
    h, heads = config["hidden"], config["heads"]
    d = h // heads
    n, t = ids.shape

    def p(name):
        return w[name].to(dtype)

    def linear(x, name):
        return x @ p(name + ".weight").T + p(name + ".bias")

    def norm(x, name):
        return F.layer_norm(x, (h,), p(name + ".weight"), p(name + ".bias"), LN_EPS)

    x = norm(p("token_embed.weight")[ids] + p("pos_embed.weight")[:t][None], "embed_norm")
    for k in range(config["layers"]):
        a = f"layer_{k}.attention."

        def split(v):
            return v.view(n, t, heads, d).transpose(1, 2)

        q = split(linear(x, a + "query")) / math.sqrt(d)
        scores = torch.softmax(q @ split(linear(x, a + "key")).transpose(-1, -2), dim=-1)
        ctx = (scores @ split(linear(x, a + "value"))).transpose(1, 2).reshape(n, t, h)
        x = norm(x + linear(ctx, a + "out"), f"layer_{k}.attention_norm")
        f = linear(F.gelu(linear(x, f"layer_{k}.intermediate")), f"layer_{k}.output")
        x = norm(x + f, f"layer_{k}.output_norm")
    pooled = torch.tanh(linear(x[:, 0], "pooler"))
    return linear(torch.relu(linear(pooled, "value_hidden")), "value_out")[:, 0].float()


class tf32_off:
    """Matrix products in full float32 inside; the previous settings restored after."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


class Reference:
    """The GFP oracle's truth for rows of tokens, from the weights the benchmark made."""

    def __init__(self, config, root: str, inputs, device):
        self.config, self.device = config, torch.device(device)
        self.weights = inputs["weights"]
        self.alphabet = config["alphabet"]

    def truth(self, key, tokens, dtype=torch.float32) -> np.ndarray:
        """float64[n]: the value head's output for int[n, L] tokens of the configuration's alphabet."""
        seqs = ["".join(self.alphabet[int(i)] for i in row) for row in np.asarray(tokens)]
        ids = torch.as_tensor(encode(seqs), device=self.device)
        out = []
        with torch.no_grad(), tf32_off():
            for lo in range(0, len(seqs), ROWS_PER_BLOCK):
                out.append(forward(self.weights, ids[lo:lo + ROWS_PER_BLOCK], self.config, dtype))
        return torch.cat(out).cpu().numpy().astype(np.float64) if out else np.zeros(0)
