"""Batched sequence-distance helpers.

`min_hamming_and_argmin` reduces a [B, N] distance matrix (ties go to the
first index, as `jnp.argmin` does); `edit_distance_matrix` is the exact
Levenshtein DP the host NoisyAbstractModel needs for mixed-length queries.
The fixed-length fast path is `ops.packed_hamming`.
"""
import numpy as np
import torch


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
