"""Capacity growth for buffers that are appended to.

PyTorch runs eagerly, so no shape is bucketed for a compiler; the uses left
are amortized O(1) growth of append-only buffers (the host
NoisyAbstractModel's packed cache, the DynaPPO environments' density cache)
and padding a batch with filler rows.
"""
import numpy as np
import torch


def next_bucket(n: int, minimum: int = 64) -> int:
    """Smallest power-of-two multiple of `minimum` that is >= n."""
    b = minimum
    while b < n:
        b *= 2
    return b


def pad_rows(arr, bucket: int, fill=0):
    """Pad the leading axis of `arr` (numpy array or tensor) up to `bucket` rows of `fill`."""
    n = arr.shape[0]
    if n == bucket:
        return arr
    if isinstance(arr, torch.Tensor):
        pad = torch.full((bucket - n,) + tuple(arr.shape[1:]), fill, dtype=arr.dtype,
                         device=arr.device)
        return torch.cat([arr, pad])
    pad = np.full((bucket - n,) + arr.shape[1:], fill, dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)
