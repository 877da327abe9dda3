"""Bit-packed Hamming distance: XOR + popcount instead of one-hot products.

Every sequence packs into ceil(L / (32 // bits)) 32-bit words.  The
distance between two packed rows is:

    x = a XOR b                       # group == 0 iff tokens equal
    fold = (x | x>>1 | ... | x>>(bits-1)) & lsb_mask
    dist = popcount(fold)             # one set bit per differing position

PyTorch has no popcount and limited uint32 support, so the words are held
in int64 (values < 2**32, bit-identical to the JAX package's uint32 words)
and popcount is the SWAR bit trick.  Plain torch ops; the fused min/argmin
kernel is later work.
"""
import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def packing_spec(length: int, alphabet_size: int):
    """(bits per symbol, symbols per word, number of words) for a length."""
    bits = max(1, int(np.ceil(np.log2(max(alphabet_size, 2)))))
    per_word = 32 // bits
    words = int(np.ceil(length / per_word))
    return bits, per_word, words


def pack_tokens(tokens, alphabet_size: int, length: int = None) -> torch.Tensor:
    """Pack int[..., L] tokens into int64[..., K] words (< 2**32 each)."""
    tokens = torch.as_tensor(tokens)
    L = tokens.shape[-1] if length is None else length
    bits, per_word, words = packing_spec(L, alphabet_size)
    pad = words * per_word - L
    if pad:
        tokens = torch.cat(
            [tokens, tokens.new_zeros(tokens.shape[:-1] + (pad,))], dim=-1
        )
    grouped = tokens.reshape(tokens.shape[:-1] + (words, per_word)).long()
    shifts = _shifts(bits, per_word, grouped.device)
    # Groups occupy disjoint bit ranges, so summing the shifted groups is
    # exactly their bitwise OR.
    return (grouped << shifts).sum(dim=-1)


@functools.lru_cache(maxsize=None)
def _shifts(bits: int, per_word: int, device: torch.device) -> torch.Tensor:
    """Bit offset of each symbol in its word (cached: read-only)."""
    return bits * torch.arange(per_word, device=device)


def _lsb_mask(bits: int, per_word: int) -> int:
    mask = 0
    for g in range(per_word):
        mask |= 1 << (g * bits)
    return mask


def _popcount32(v: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 element holding a 32-bit value (SWAR)."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def packed_hamming_matrix(q_packed, c_packed, bits: int, per_word: int):
    """All-pairs Hamming distances of packed rows: int32[..., B, N].

    q_packed: int64[..., B, K]; c_packed: int64[..., N, K], with the same
    leading (cell) dimensions or none.
    """
    x = q_packed.unsqueeze(-2) ^ c_packed.unsqueeze(-3)  # [..., B, N, K]
    fold = x
    for s in range(1, bits):
        fold = fold | (x >> s)
    fold = fold & _lsb_mask(bits, per_word)
    return _popcount32(fold).sum(dim=-1).to(torch.int32)
