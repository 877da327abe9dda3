"""State carried over from the JAX package: Flax nets, runtime surrogates, fitted models, GFP.

The port's surrogate nets keep Flax's layer names and layouts (`Conv_i`
kernels [k, in, out], `Dense_i` kernels [in, out], biases [out]) in one
flat f32[nets, P] tensor, each layer's kernel then bias, layers in order.
So a Flax parameter tree, given as numpy arrays, maps onto the port's flat
weights by reshaping and concatenating, with nothing transposed or flipped.
The GFP oracle is a plain `nn.Module` with Flax's submodule names and
torch's `Linear` layout, so its kernels are transposed
(`bert_params_from_flax`).  The fitted state of the linear, GP, k-NN
and tree models maps array for array (`linear_state_from_jax`,
`gp_state_from_jax`, `knn_state_from_jax`, `trees_from_jax`), so that
both packages' predict paths run on identical state.  The explorers' nets
(the VAE, the DQN's Q network, the PPO actor-critic) keep Flax's layer
names with torch's `Linear` layout: their state dicts come from the Flax
variables with every Dense kernel transposed (`vae_variables_from_flax`,
`qnetwork_variables_from_flax`, `actor_critic_params_from_flax`).
"""
from typing import Mapping

import numpy as np
import torch

from flexs_tpu_torch.baselines.models.torch_gp import GPFit, GPState, KNNState
from flexs_tpu_torch.baselines.models.torch_model import AdamState

# Layer names of each arch's net, in the port's (and Flax's) order.
LAYERS = {
    "cnn": ("Conv_0", "Conv_1", "Conv_2", "Dense_0", "Dense_1", "Dense_2"),
    "mlp": ("Dense_0", "Dense_1", "Dense_2", "Dense_3"),
    "gem": ("Dense_0", "Dense_1", "Dense_2", "Dense_3"),
    "linear": ("Dense_0",),
}


def params_from_flax(arch: str, tree: Mapping) -> torch.Tensor:
    """The port's flat weights f32[nets, P] (on the CPU) of a Flax parameter tree.

    `tree` is `{"params": {layer: {"kernel", "bias"}}}` (or its inner
    mapping) of numpy arrays.  A tree whose biases have a leading axis (an
    ensemble's state from the JAX package's `surrogate.init_state`) gives
    one net per entry of that axis; otherwise one net.
    """
    if arch not in LAYERS:
        raise ValueError(f"no weight layout for arch {arch!r}")
    layers = tree["params"] if "params" in tree else tree
    if sorted(layers) != sorted(LAYERS[arch]):
        raise ValueError(f"{arch} layers are {LAYERS[arch]}, the tree has {sorted(layers)}")
    bias = np.asarray(layers[LAYERS[arch][0]]["bias"])
    nets = bias.shape[0] if bias.ndim == 2 else 1
    parts = [
        np.asarray(layers[name][leaf], np.float32).reshape(nets, -1)
        for name in LAYERS[arch]
        for leaf in ("kernel", "bias")
    ]
    return torch.tensor(np.concatenate(parts, axis=1))


def surrogate_state_from_flax(spec, state):
    """The port's `SurrogateState` (one cell, on the CPU) of a JAX `SurrogateState`.

    Carries the members' weights, Adam's moments and step count
    (`optax.adam`'s `ScaleByAdamState`) and the combine weights, so that
    the two packages can take a training step from the same state; for
    arch "gp", the exact posterior's state (`gp_state_from_jax`).
    """
    from flexs_tpu_torch.runtime.surrogate import SurrogateState

    if spec.arch == "gp":
        gp = gp_state_from_jax(**state.params)
        return SurrogateState(GPState(*(
            t[None] for t in (gp.train_tokens, gp.valid)), GPFit(*(t[None] for t in gp.fit))),
            torch.ones((1, 1)))
    adam = state.opt_state[0]
    count = np.asarray(adam.count, np.int64).reshape(-1)
    weight = np.asarray(state.weight, np.float32).reshape(1, -1)
    return SurrogateState(
        AdamState(
            params_from_flax(spec.arch, state.params),
            params_from_flax(spec.arch, adam.mu),
            params_from_flax(spec.arch, adam.nu),
            torch.tensor(count),
        ),
        torch.tensor(weight),
    )


def bert_params_from_flax(tree: Mapping) -> dict:
    """A `landscapes.bert_gfp.ProteinBertRegressor` state dict (CPU) of Flax params.

    `tree` is the JAX package's `ProteinBertRegressor` parameter tree
    (`{"params": {...}}` or its inner mapping) as numpy arrays.  Flax
    `Dense` kernels are [in, out] and torch `Linear` weights [out, in];
    the attention's `DenseGeneral` kernels are [hidden, heads, head_dim]
    (query, key, value) and [heads, head_dim, hidden] (out); LayerNorm
    scales become weights.
    """
    p = tree["params"] if "params" in tree else tree
    out = {}

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32))

    def dense(name, src, kernel_2d=None):
        kernel = np.asarray(src["kernel"], np.float32)
        kernel = kernel.reshape(kernel.shape[0], -1) if kernel_2d is None else kernel_2d(kernel)
        out[name + ".weight"] = f32(kernel.T).contiguous()
        out[name + ".bias"] = f32(src["bias"]).reshape(-1)

    def norm(name, src):
        out[name + ".weight"], out[name + ".bias"] = f32(src["scale"]), f32(src["bias"])

    out["token_embed.weight"] = f32(p["token_embed"]["embedding"])
    out["pos_embed.weight"] = f32(p["pos_embed"]["embedding"])
    norm("embed_norm", p["embed_norm"])
    layers = sum(1 for name in p if name.startswith("layer_"))
    for i in range(layers):
        src, dst = p[f"layer_{i}"], f"layer_{i}."
        attn = src["attention"]
        for name in ("query", "key", "value"):
            dense(dst + "attention." + name, attn[name])
        dense(dst + "attention.out", attn["out"],
              lambda k: k.reshape(-1, k.shape[-1]))  # [heads, head_dim, hidden]
        norm(dst + "attention_norm", src["attention_norm"])
        dense(dst + "intermediate", src["intermediate"])
        dense(dst + "output", src["output"])
        norm(dst + "output_norm", src["output_norm"])
    for name in ("pooler", "value_hidden", "value_out"):
        dense(name, p[name])
    return out


def _tensor(a, dtype, device):
    return torch.tensor(np.asarray(a), device=device).to(dtype)


def linear_state_from_jax(coef, intercept=None, device="cpu"):
    """(coef f32[P + 1] with the bias last, intercept) of a JAX linear model's fit.

    `JaxRidgeRegression._coef` holds the bias as its last entry;
    `JaxBayesianRidge` and `JaxLasso` keep `_coef` f32[P] and `_intercept`.
    Set the pair as a port model's `_coef` and `_intercept`.
    """
    coef = _tensor(coef, torch.float32, device)
    if intercept is None:
        return coef, 0.0
    return torch.cat([coef, torch.zeros(1, device=coef.device)]), float(np.asarray(intercept))


def gp_state_from_jax(train_tokens, theta, dual, chol, valid, device="cpu") -> GPState:
    """A `TorchGaussianProcessRegressor`'s state of the JAX model's (padded) fit.

    The arguments are `JaxGaussianProcessRegressor._state`'s fields (or the
    GP surrogate's `params`); padded rows stay masked by `valid`.
    """
    return GPState(
        _tensor(train_tokens, torch.long, device), _tensor(valid, torch.bool, device),
        GPFit(*(_tensor(a, torch.float32, device) for a in (theta, dual, chol))),
    )


def knn_state_from_jax(train_tokens, train_labels, valid, k, device="cpu") -> KNNState:
    """A `TorchKNNRegressor`'s state of `JaxKNNRegressor._state`'s fields."""
    return KNNState(_tensor(train_tokens, torch.long, device),
                    _tensor(train_labels, torch.float32, device),
                    _tensor(valid, torch.bool, device), int(k))


def trees_from_jax(feats, leaves, init=None, device="cpu"):
    """A tree model's state of the JAX model's `_state`.

    (feat, leaf) for `JaxRandomForest` ([trees, ...]) and `JaxExtraTree`
    (one tree); (init, feat, leaf) for `JaxGradientBoosting`.
    """
    state = (_tensor(feats, torch.long, device), _tensor(leaves, torch.float32, device))
    if init is None:
        return state
    return (_tensor(init, torch.float32, device),) + state


def _state_dict_from_flax(variables: Mapping) -> dict:
    """A state dict (CPU) of Flax variables `{"params": ..., "batch_stats": ...}`.

    Each layer's "kernel" [in, out] becomes "<layer>.weight" [out, in];
    every other leaf (bias, BatchNorm scale, mean, var) keeps its name.
    """
    params = variables["params"] if "params" in variables else variables
    out = {}
    for group in (params, variables.get("batch_stats", {})):
        for layer, leaves in group.items():
            for leaf, value in leaves.items():
                a = np.asarray(value, np.float32)
                if leaf == "kernel":
                    out[f"{layer}.weight"] = torch.tensor(a.T.copy())
                else:
                    out[f"{layer}.{leaf}"] = torch.tensor(a)
    return out


def vae_variables_from_flax(variables: Mapping) -> dict:
    """A `utils.vae.VAEModule` state dict of the JAX VAE's `variables` (params, batch_stats).

    Load it with `VAE.set_weights`, or pass it as a `calculate_log_probability` snapshot.
    """
    return _state_dict_from_flax(variables)


def qnetwork_variables_from_flax(variables: Mapping) -> dict:
    """A DQN `QNetwork` state dict of the JAX Q network's `variables`.

    The BatchNorm statistics (`batch_stats`) are parameters of the port's
    net, as the JAX package's optimizer treats them.
    """
    return _state_dict_from_flax(variables)


def actor_critic_params_from_flax(params: Mapping) -> dict:
    """A `rl.ppo.ActorCritic` state dict of the JAX agent's `params`."""
    return _state_dict_from_flax(params)
