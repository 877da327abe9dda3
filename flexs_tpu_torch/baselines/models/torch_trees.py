"""Tree-ensemble regressors on the run's device, for the DynaPPO default ensemble.

The port of the JAX package's `jax_trees.py`.  The reference's DynaPPO
ensemble keeps three sklearn tree members (RandomForestRegressor,
GradientBoostingRegressor, ExtraTreeRegressor; reference
dyna_ppo.py:57-85).  Their features are flattened one-hot columns, so
every split threshold is 0.5 and exact greedy split finding is a
histogram per tree level:

    G1[tree, node, feature] = node_onehot[tree]^T @ (w * residual * X)

one batched matrix product for all trees of a forest at once.  Trees are
dense and depth-capped, grown level by level (node k's children are 2k and
2k + 1 of the next level; internal nodes in a heap, `feat`), and predict
by routing every sample down `depth` gathers.  Parity notes, as in the
JAX package: depth caps (forest 10, boosting 3, sklearn's default); on 0/1
features the extra tree's random threshold is equivalent to 0.5, so it is
the greedy tree; the forest bootstraps per tree over the live rows.

Against the JAX package:
  * carried-across trees (`convert.trees_from_jax`) predict bitwise as
    JAX's on the CPU: each tree's prediction is a gather, and the sum over
    trees follows XLA's CPU order (windows of 32 trees, the padding split
    evenly at both ends, each window summed in order, then the window sums
    in order); the boosted model adds init + lr * sum in one rounding, as
    XLA's fused multiply-add does.  Checked for 1-20 and 33-100 trees (the
    defaults are 100); from 21 to 32 trees XLA sums in another order, and
    the two differ in the last bits;
  * fitted trees can differ where two splits' gains tie to the last bit:
    the histograms are f32 sums in another order;
  * the forest's bootstrap draws from a CPU `torch.Generator` seeded from
    `seed`, which cannot replay `jax.random.categorical`.  The JAX package
    draws over a padded bucket and keeps the first n_live draws; the port
    does not pad, and draws n_live rows in proportion to the weights.  The
    draws are made on the CPU whatever the model's device, so a forest
    fitted on the card has the same bootstrap as one fitted on the CPU.
The JAX package grows every level over 2^depth node slots (static shapes
for XLA); the port uses the 2^level live ones, which gives the same trees.
"""
from typing import Optional

import numpy as np
import torch

from flexs_tpu_torch.baselines.models.torch_linear import DeviceModel
from flexs_tpu_torch.types import SEQUENCES_TYPE

_EPS = 1e-12
# XLA's CPU compiler sums a reduction of more than this many terms in
# windows of this many (its tree-reduction rewrite).
_XLA_WINDOW = 32


def grow_trees(x: torch.Tensor, resid: torch.Tensor, w: torch.Tensor, depth: int):
    """Fit T dense depth-`depth` regression trees on weighted residuals.

    Args:
        x: f32[N, F] 0/1 features, shared by every tree.
        resid: f32[T, N] targets per tree.
        w: f32[T, N] sample weights per tree (0 = out of the bag).

    Returns:
        (feat int64[T, 2^depth - 1], leaf f32[T, 2^depth]): the split
        feature of each internal node (heap layout) and the leaf values.
        An empty node takes its deepest non-empty ancestor's mean, as an
        unexpanded sklearn node would.
    """
    trees, n = w.shape
    wy = resid * w
    wyx, wx = wy[:, :, None] * x, w[:, :, None] * x  # the same for every level
    val = (wy.sum(dim=1) / torch.clamp(w.sum(dim=1), min=_EPS))[:, None]
    node = torch.zeros((trees, n), dtype=torch.long, device=x.device)
    rows = torch.arange(n, device=x.device)
    feats = []
    for level in range(depth):
        node_oh = (node[:, :, None] == torch.arange(1 << level, device=x.device)).float()
        node_oh_t = node_oh.transpose(1, 2)
        g1, h1 = node_oh_t @ wyx, node_oh_t @ wx  # [T, nodes, F]
        g, h = node_oh_t @ wy[:, :, None], node_oh_t @ w[:, :, None]  # [T, nodes, 1]
        g0, h0 = g - g1, h - h1
        # Squared-error split gain: the children's S^2/n minus the parent's.
        gain = (torch.square(g1) / (h1 + _EPS) + torch.square(g0) / (h0 + _EPS)
                - torch.square(g) / (h + _EPS))
        gain = torch.where((h1 > 0) & (h0 > 0), gain, -torch.inf)
        best = torch.where(torch.isfinite(gain.amax(dim=2)), gain.argmax(dim=2), 0)
        feats.append(best)

        g1b = g1.gather(2, best[:, :, None])[:, :, 0]
        h1b = h1.gather(2, best[:, :, None])[:, :, 0]
        g, h = g[:, :, 0], h[:, :, 0]
        g0b, h0b = g - g1b, h - h1b
        parent = torch.where(h > 0, g / (h + _EPS), val)
        right = torch.where(h1b > 0, g1b / (h1b + _EPS), parent)
        left = torch.where(h0b > 0, g0b / (h0b + _EPS), parent)
        val = torch.stack([left, right], dim=2).reshape(trees, -1)

        go_right = x[rows, best.gather(1, node)] > 0.5
        node = node * 2 + go_right.long()
    return torch.cat(feats, dim=1), val


def predict_trees(feat: torch.Tensor, leaf: torch.Tensor, x: torch.Tensor, depth: int):
    """Per-tree predictions f32[T, N] of features f32[N, F]."""
    trees, n = feat.shape[0], x.shape[0]
    node = torch.zeros((trees, n), dtype=torch.long, device=x.device)
    rows = torch.arange(n, device=x.device)
    for level in range(depth):
        split = feat.gather(1, (1 << level) - 1 + node)
        node = node * 2 + (x[rows, split] > 0.5).long()
    return leaf.gather(1, node)


def sum_trees(preds: torch.Tensor) -> torch.Tensor:
    """Sum f32[N] of per-tree predictions f32[T, N], in XLA's CPU order (module doc)."""
    trees = preds.shape[0]
    pad = -trees % _XLA_WINDOW
    padded = torch.nn.functional.pad(preds, (0, 0, pad // 2, pad - pad // 2))
    windows = padded.view(-1, _XLA_WINDOW, preds.shape[1])
    partial = windows[:, 0]
    for i in range(1, windows.shape[1]):
        partial = partial + windows[:, i]
    total = partial[0]
    for i in range(1, len(partial)):
        total = total + partial[i]
    return total


def fit_forest(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor, generator: torch.Generator,
               n_trees: int, depth: int):
    """Bootstrap-aggregated trees (sklearn RandomForestRegressor's analog): (feat, leaf).

    Each tree's sample weights are the counts of n_live draws with
    replacement over the live rows (w > 0), in proportion to w, drawn from
    the CPU `generator`.
    """
    w_cpu = w.cpu()
    n_live = int((w_cpu > 0).sum())
    counts = torch.zeros((n_trees, len(w_cpu)))
    if n_live:
        draws = torch.multinomial(w_cpu.expand(n_trees, -1), n_live, replacement=True,
                                  generator=generator)
        counts.scatter_add_(1, draws, torch.ones_like(draws, dtype=counts.dtype))
    return grow_trees(x, y.expand(n_trees, -1), counts.to(x.device), depth)


def predict_forest(feat, leaf, x, depth: int) -> torch.Tensor:
    trees = feat.shape[0]
    scale = torch.tensor(1.0 / trees, dtype=torch.float32, device=x.device)
    return sum_trees(predict_trees(feat, leaf, x, depth)) * scale


def fit_boosted(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor, n_rounds: int, depth: int,
                learning_rate: float):
    """Gradient boosting with squared loss (sklearn GBR's analog): (init, feat, leaf)."""
    init = (y * w).sum() / torch.clamp(w.sum(), min=1e-9)
    pred = torch.zeros_like(y) + init
    feats, leaves = [], []
    for _ in range(n_rounds):
        feat, leaf = grow_trees(x, (y - pred)[None], w[None], depth)
        pred = pred + learning_rate * predict_trees(feat, leaf, x, depth)[0]
        feats.append(feat)
        leaves.append(leaf)
    return init, torch.cat(feats), torch.cat(leaves)


def predict_boosted(init, feat, leaf, x, depth: int, learning_rate: float) -> torch.Tensor:
    """init + learning_rate * sum of the trees, rounded once (in f64) as an FMA is."""
    total = sum_trees(predict_trees(feat, leaf, x, depth))
    lr = float(np.float32(learning_rate))
    return (total.double() * lr + init.double()).float()


class NotFittedError(Exception):
    """Raised when predicting before the first `train` call."""


class _TorchTreeModel(DeviceModel):
    """A tree model fitted on one-hot features; `seed` seeds the forest's bootstrap."""

    def __init__(self, alphabet: str, name: str, seed: int = 0, device=None):
        super().__init__(alphabet, name, device)
        self._generator = torch.Generator().manual_seed(seed)

    @torch.no_grad()
    def train(self, sequences: SEQUENCES_TYPE, labels, **kwargs):
        """Fit on the measured set."""
        x, y = self._features(self.alphabet.encode(list(sequences))), self._labels(labels)
        self._state = self._fit(x, y, torch.ones_like(y))

    @torch.no_grad()
    def fitness_from_tokens(self, tokens) -> np.ndarray:
        """f64[B] predictions of int[B, L] tokens."""
        if self._state is None:
            raise NotFittedError(self.name)
        return self._predict(self._features(tokens)).cpu().numpy().astype(np.float64)


class TorchRandomForest(_TorchTreeModel):
    """Bagged-tree regressor on the device (sklearn RandomForestRegressor's slot)."""

    def __init__(self, alphabet: str, n_trees: int = 100, depth: int = 10,
                 name: Optional[str] = None, seed: int = 0, device=None):
        super().__init__(alphabet, name or "random_forest", seed, device)
        self.n_trees = n_trees
        self.depth = depth

    def _fit(self, x, y, w):
        return fit_forest(x, y, w, self._generator, self.n_trees, self.depth)

    def _predict(self, x):
        return predict_forest(*self._state, x, self.depth)


class TorchGradientBoosting(_TorchTreeModel):
    """Gradient-boosting regressor on the device (sklearn GBR's slot; defaults
    n_estimators=100, learning_rate=0.1, max_depth=3)."""

    def __init__(self, alphabet: str, n_rounds: int = 100, depth: int = 3,
                 learning_rate: float = 0.1, name: Optional[str] = None, seed: int = 0,
                 device=None):
        super().__init__(alphabet, name or "gradient_boosting", seed, device)
        self.n_rounds = n_rounds
        self.depth = depth
        self.learning_rate = learning_rate

    def _fit(self, x, y, w):
        return fit_boosted(x, y, w, self.n_rounds, self.depth, self.learning_rate)

    def _predict(self, x):
        return predict_boosted(*self._state, x, self.depth, self.learning_rate)


class TorchExtraTree(_TorchTreeModel):
    """Single-tree regressor on the device (sklearn ExtraTreeRegressor's slot).

    On 0/1 one-hot features the extra tree's uniform random threshold is
    equivalent to 0.5, so the exact greedy tree is the extra tree.
    """

    def __init__(self, alphabet: str, depth: int = 10, name: Optional[str] = None,
                 seed: int = 0, device=None):
        super().__init__(alphabet, name or "extra_trees", seed, device)
        self.depth = depth

    def _fit(self, x, y, w):
        feat, leaf = grow_trees(x, y[None], w[None], self.depth)
        return feat[0], leaf[0]

    def _predict(self, x):
        feat, leaf = self._state
        return predict_trees(feat[None], leaf[None], x, self.depth)[0]
