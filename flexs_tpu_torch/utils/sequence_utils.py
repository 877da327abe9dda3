"""Sequence manipulation utilities.

API parity with reference flexs/utils/sequence_utils.py (alphabets :7-17,
construct_mutant_from_sample :20, string_to_one_hot :32, one_hot_to_string
:50, generate_single_mutants :69, generate_random_sequences :80,
generate_random_mutant :87), plus batched token-space primitives:

  * `random_mutants(generator, tokens, mu, alphabet_size)`: per-residue
    mutation of an int[batch, L] tensor (replaces the Python per-char loop
    of generate_random_mutant).
  * `recombine(generator, tokens_a, tokens_b, rate)`: batched crossover.

Randomness: the string-level functions take an optional `rng` (numpy
Generator) and draw exactly as the JAX package's do; the token-level
functions take a `torch.Generator` on the tokens' device (the reference
uses the global `random` module and is unseedable).
"""
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from flexs_tpu_torch.alphabet import AAS, BA, DNAA, RNAA, Alphabet, as_alphabet  # noqa: F401

_default_rng = np.random.default_rng()


def construct_mutant_from_sample(
    pwm_sample: np.ndarray, one_hot_base: np.ndarray
) -> np.ndarray:
    """Apply the nonzero rows of `pwm_sample` onto `one_hot_base`.

    Any position with a nonzero entry in `pwm_sample` is overwritten with a
    one-hot at that entry's column (reference sequence_utils.py:20-29).
    """
    one_hot = np.zeros(one_hot_base.shape)
    one_hot += one_hot_base
    i, j = np.nonzero(pwm_sample)
    one_hot[i, :] = 0
    one_hot[i, j] = 1
    return one_hot


def string_to_one_hot(sequence: str, alphabet: Union[str, Alphabet]) -> np.ndarray:
    """One-hot a sequence string to shape (len(sequence), len(alphabet))."""
    alpha = as_alphabet(alphabet)
    tokens = alpha.encode_one(sequence)
    out = np.zeros((len(sequence), len(alpha)))
    out[np.arange(len(sequence)), tokens] = 1
    return out


def one_hot_to_string(one_hot, alphabet: Union[str, Alphabet]) -> str:
    """Decode a (L, A) one-hot (or PWM: argmax) into a string."""
    alpha = as_alphabet(alphabet)
    residue_idxs = np.argmax(np.asarray(one_hot), axis=1)
    return alpha.decode_one(residue_idxs.astype(np.int32))


def generate_single_mutants(wt: str, alphabet: Union[str, Alphabet]) -> List[str]:
    """Generate all single mutants of `wt` (including `wt` itself first)."""
    alpha = as_alphabet(alphabet)
    sequences = [wt]
    for i in range(len(wt)):
        tmp = list(wt)
        for j in range(len(alpha)):
            tmp[i] = alpha.letters[j]
            sequences.append("".join(tmp))
    return sequences


def generate_random_sequences(
    length: int,
    number: int,
    alphabet: Union[str, Alphabet],
    rng: Optional[np.random.Generator] = None,
) -> List[str]:
    """Generate `number` uniform random sequences of `length`."""
    alpha = as_alphabet(alphabet)
    rng = rng or _default_rng
    tokens = rng.integers(0, len(alpha), size=(number, length), dtype=np.int32)
    return alpha.decode(tokens)


def generate_random_mutant(
    sequence: str,
    mu: float,
    alphabet: Union[str, Alphabet],
    rng: Optional[np.random.Generator] = None,
) -> str:
    """Mutate each residue with probability `mu` to a uniform random letter.

    Matches reference semantics (sequence_utils.py:87-108): a "mutated"
    position is resampled uniformly over the whole alphabet, so it keeps its
    identity with probability 1/|A|.
    """
    alpha = as_alphabet(alphabet)
    rng = rng or _default_rng
    tokens = alpha.encode_one(sequence)
    mask = rng.random(len(tokens)) < mu
    random_tokens = rng.integers(0, len(alpha), size=len(tokens), dtype=np.int32)
    return alpha.decode_one(np.where(mask, random_tokens, tokens))


def random_mutants(
    generator: torch.Generator, tokens, mu: float, alphabet_size: int
) -> torch.Tensor:
    """Batched per-residue mutation of int[batch, L] tokens on their device.

    Each residue independently resamples uniformly over the alphabet with
    probability `mu` (identical distribution to `generate_random_mutant`
    applied row-wise).  `generator` lives on the tokens' device.
    """
    tokens = torch.as_tensor(tokens)
    mask = torch.rand(tokens.shape, generator=generator, device=tokens.device) < mu
    random_tokens = torch.randint(
        0, alphabet_size, tokens.shape, generator=generator, device=tokens.device
    )
    return torch.where(mask, random_tokens.to(tokens.dtype), tokens)


def recombine(
    generator: torch.Generator, tokens_a, tokens_b, rate: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched single-pass crossover of two equal-shape token batches.

    A crossover happens at each position with probability `rate`; a prefix
    parity (cumulative sum mod 2) of the crossover indicators gives the
    "switch" state of reference adalead.py:79-92 for every position at once.
    """
    tokens_a = torch.as_tensor(tokens_a)
    tokens_b = torch.as_tensor(tokens_b)
    crossover = (
        torch.rand(tokens_a.shape, generator=generator, device=tokens_a.device) < rate
    )
    switch = torch.cumsum(crossover.long(), dim=-1) % 2 == 1
    return torch.where(switch, tokens_a, tokens_b), torch.where(switch, tokens_b, tokens_a)
