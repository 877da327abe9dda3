"""Alphabets and fast string<->token codecs.

Sequences are Python strings only at the I/O edge; all compute runs on
integer token arrays.  Encoding uses a 256-entry lookup table indexed by raw
byte values, so a batch of B length-L strings encodes in one vectorized
numpy gather.  The codec is host-side numpy: callers move the tokens to
their device with `torch.as_tensor`.
"""
from __future__ import annotations

from typing import Iterable, List, Sequence

import numpy as np

AAS = "ILVAGMFYWEDQNHCRKSTP"
"""Amino acid alphabet for proteins (length 20 - no stop codon)."""

RNAA = "UGCA"
"""RNA alphabet (4 base pairs)."""

DNAA = "TGCA"
"""DNA alphabet (4 base pairs)."""

BA = "01"
"""Binary alphabet '01'."""


class Alphabet:
    """A fixed symbol set plus vectorized string<->token codecs.

    Attributes:
        letters: The alphabet string; index in this string == token id.
    """

    def __init__(self, letters: str):
        if len(set(letters)) != len(letters):
            raise ValueError(f"Alphabet has duplicate letters: {letters!r}")
        self.letters = letters
        self._byte_to_token = np.full(256, -1, dtype=np.int32)
        for i, ch in enumerate(letters):
            self._byte_to_token[ord(ch)] = i
        self._token_to_byte = np.frombuffer(
            letters.encode("ascii"), dtype=np.uint8
        ).copy()

    def __len__(self) -> int:
        return len(self.letters)

    def __repr__(self) -> str:
        return f"Alphabet({self.letters!r})"

    def __eq__(self, other) -> bool:
        if isinstance(other, Alphabet):
            return self.letters == other.letters
        if isinstance(other, str):
            return self.letters == other
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self.letters)

    def encode(self, sequences: Iterable[str]) -> np.ndarray:
        """Encode equal-length strings into an int32[batch, L] token array."""
        if isinstance(sequences, str):
            raise TypeError("encode() expects a batch of strings, not one string")
        seqs: Sequence[str] = (
            sequences if isinstance(sequences, (list, tuple)) else list(sequences)
        )
        if len(seqs) == 0:
            return np.zeros((0, 0), dtype=np.int32)
        joined = "".join(seqs).encode("ascii")
        raw = np.frombuffer(joined, dtype=np.uint8)
        length = len(seqs[0])
        if raw.size != length * len(seqs):
            raise ValueError("All sequences in a batch must have equal length")
        tokens = self._byte_to_token[raw].reshape(len(seqs), length)
        if (tokens < 0).any():
            bad = sorted(set(chr(b) for b in raw[self._byte_to_token[raw] < 0]))
            raise ValueError(f"Characters {bad} not in alphabet {self.letters!r}")
        return tokens

    def encode_one(self, sequence: str) -> np.ndarray:
        """Encode a single string into an int32[L] token array."""
        return self.encode([sequence])[0]

    def decode(self, tokens) -> List[str]:
        """Decode an int[batch, L] token array (numpy or tensor) into strings."""
        tokens = np.asarray(tokens.cpu() if hasattr(tokens, "cpu") else tokens)
        if tokens.ndim == 1:
            tokens = tokens[None]
        raw = self._token_to_byte[tokens.astype(np.int64)]
        return [row.tobytes().decode("ascii") for row in raw]

    def decode_one(self, tokens) -> str:
        """Decode an int[L] token array into a string."""
        return self.decode(np.asarray(tokens)[None])[0]


def as_alphabet(alphabet) -> Alphabet:
    """Coerce a string or Alphabet into an Alphabet."""
    if isinstance(alphabet, Alphabet):
        return alphabet
    return Alphabet(alphabet)
