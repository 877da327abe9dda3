"""Batched sequence-distance helpers.

`hamming_distance_matrix` is the all-pairs Hamming distance of token rows;
`min_hamming_and_argmin` reduces a [B, N] distance matrix (ties go to the
first index, as `jnp.argmin` does); `edit_distance_matrix` is the exact
Levenshtein DP the host NoisyAbstractModel needs for mixed-length queries,
and `banded_edit_distance_matrix` the radius-limited one.  The fixed-length
fast path is `ops.packed_hamming`.
"""
import numpy as np
import torch
from torch import nn


def hamming_distance_matrix(queries, cache, alphabet_size: int) -> torch.Tensor:
    """All-pairs Hamming distances int32[B, N] of int[B, L] vs int[N, L] tokens.

    A position matches when both tokens are equal and inside
    [0, alphabet_size), as the JAX package's one-hot contraction counts it.
    """
    q = torch.as_tensor(queries).long()
    c = torch.as_tensor(cache).long().to(q.device)
    in_range = (q >= 0) & (q < alphabet_size)
    matches = ((q[:, None, :] == c[None, :, :]) & in_range[:, None, :]).sum(dim=-1)
    return (q.shape[-1] - matches).to(torch.int32)


def min_hamming_and_argmin(dists):
    """Row-wise (min distance, first argmin index) of a [B, N] matrix."""
    return dists.amin(dim=1), dists.argmin(dim=1)


def edit_distance_matrix(queries, cache) -> np.ndarray:
    """Exact Levenshtein distance matrix int32[B, N] of padded token rows.

    queries int[B, L], cache int[N, L]: positions with value < 0 are
    padding at the end of a row (variable true lengths under one width).
    Wagner-Fischer over all pairs at once: O(L^2) steps of [B, N] tensor
    ops, for the rare mixed-length queries only.
    """
    q = torch.as_tensor(queries).long()
    c = torch.as_tensor(cache).long()
    n_q, width = q.shape
    n_c = c.shape[0]
    la = (q >= 0).sum(dim=1)[:, None]  # [B, 1]
    lb = (c >= 0).sum(dim=1)[None, :]  # [1, N]
    # prev[..., k] = distance of a[:k] to the current b-prefix.
    prev = torch.arange(width + 1).expand(n_q, n_c, width + 1)
    for i in range(width):
        sub = (q[:, None, :] != c[None, :, i, None]).long()  # [B, N, L]
        row = [prev[..., 0] + 1]
        for k in range(width):
            left = row[-1]
            val = torch.minimum(
                torch.minimum(left + 1, prev[..., k + 1] + 1), prev[..., k] + sub[..., k]
            )
            row.append(torch.where(k < la, val, left))
        prev = torch.where(i < lb[..., None], torch.stack(row, dim=-1), prev)
    out = prev.gather(-1, la[:, :, None].expand(n_q, n_c, 1))[..., 0]
    return out.to(torch.int32).numpy()


def banded_edit_distance_matrix(queries, cache, band: int = 2) -> torch.Tensor:
    """Levenshtein matrix int32[B, N], exact up to `band`, else band + 1.

    Ukkonen-style banded Wagner-Fischer over all pairs at once: only the
    2 * band + 1 diagonals |i - j| <= band are tracked, so each of the L
    steps is a few [B, N, 2 * band + 1] tensor ops; any true distance >
    band reports exactly band + 1.  Positions with value < 0 are padding at
    the end of a row.  The step follows the JAX package's
    `_banded_edit_distance_pairwise`, with the in-row recurrence
    v[d] = min(cand[d], v[d - 1] + 1) taken as one running minimum:
    v[d] = d + cummin(cand[d'] - d').
    """
    a = torch.as_tensor(queries).long()
    b = torch.as_tensor(cache).long().to(a.device)
    dev = a.device
    L = a.shape[1]
    K = 2 * band + 1
    inf = band + 1
    la = (a >= 0).sum(dim=1)[:, None, None]  # [B, 1, 1]
    lb = (b >= 0).sum(dim=1)[None, :, None]  # [1, N, 1]
    offs = torch.arange(K, device=dev) - band  # column offset j - r
    steps = torch.arange(K, device=dev)

    # Every row's window columns j = r + offs, and what depends on them
    # alone: b's letters there, and the cells left of column 0, at it, and
    # past b's true length.
    cols = torch.arange(1, L + 1, device=dev)[:, None] + offs  # [L, K]
    inside = (cols >= 1) & (cols <= L)
    bj = torch.where(inside[None], b[:, (cols - 1).clamp(0, L - 1)], -2)  # [N, L, K]
    bj = bj.transpose(0, 1).contiguous()  # [L, N, K]
    before_start, at_start = cols < 0, cols == 0
    past_end = cols[None] > lb[0, :, :, None]  # [N, L, K]
    in_a = torch.arange(1, L + 1, device=dev)[:, None, None, None] <= la  # [L, B, 1, 1]

    # Row 0: dp[0][j] = j for j in 0..band; columns off-band are saturated.
    w = torch.where(offs >= 0, offs, inf).clamp(max=inf)
    w = w.expand(a.shape[0], b.shape[0], K)
    for r in range(1, L + 1):
        # w[..., d] = dp[r-1][r-1 + offs[d]]; compute row r (a-prefix r).
        # dp[r-1][j] sits one offset up in the previous window; dp[r-1][j-1]
        # sits at the same offset.
        up = nn.functional.pad(w[..., 1:], (0, 1), value=inf)
        cost = a[:, r - 1, None, None] != bj[r - 1]
        cand = torch.minimum(up + 1, w + cost)
        cand = torch.where(before_start[r - 1], inf, torch.where(at_start[r - 1], r, cand))
        v = torch.cummin(cand - steps, dim=-1).values + steps
        v = torch.where(past_end[:, r - 1], inf, v).clamp(max=inf)
        # Freeze once past a's true length so w holds row `la` at the end.
        w = torch.where(in_a[r - 1], v, w)
    # Answer = dp[la][lb] = window offset lb - la (saturated if off-band).
    off = (lb - la)[..., 0]
    idx = (off + band).clamp(0, K - 1)
    out = w.gather(-1, idx[..., None])[..., 0]
    return torch.where(off.abs() <= band, out, inf).to(torch.int32)
