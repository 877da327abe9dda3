"""Plain reference of the masked nearest-neighbour lookup: Hamming distances in numpy.

A packed row holds its symbols `per_word` to a word, symbol j in word
j // per_word at bit offset bits x (j % per_word), the tail of the last
word zero.  The distance of a query row to a cache row is the number of
positions whose symbols differ; a cache row at or past the cell's fill
reads length + 1, above any distance.  This file imports numpy only.
"""
import numpy as np


def unpack(words, bits: int, per_word: int, length: int) -> np.ndarray:
    """int64[..., length] symbols of int64[..., K] packed rows."""
    words = np.asarray(words, np.int64)
    offsets = bits * np.arange(per_word, dtype=np.int64)
    symbols = (words[..., :, None] >> offsets) & ((1 << bits) - 1)
    return symbols.reshape(words.shape[:-1] + (-1,))[..., :length]


def masked_distances(queries, cache, fill: int, bits: int, per_word: int,
                     length: int) -> np.ndarray:
    """int64[m, N]: distances of packed queries [m, K] to packed cache rows [N, K], masked at `fill`."""
    q = unpack(queries, bits, per_word, length)
    c = unpack(cache, bits, per_word, length)
    d = (q[:, None, :] != c[None, :, :]).sum(axis=-1)
    d[:, int(fill):] = length + 1
    return d
