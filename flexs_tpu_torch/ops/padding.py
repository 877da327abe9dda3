"""Capacity growth for buffers that are appended to.

PyTorch runs eagerly, so no shape is bucketed for a compiler; the one use
left is amortized O(1) growth of an append-only buffer (the host
NoisyAbstractModel's packed cache).
"""


def next_bucket(n: int, minimum: int = 64) -> int:
    """Smallest power-of-two multiple of `minimum` that is >= n."""
    b = minimum
    while b < n:
        b *= 2
    return b
