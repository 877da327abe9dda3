"""TF binding landscape: full 4^8 lookup tables as tensor gathers.

Contract (reference flexs/landscapes/tf_binding.py):
  * Experimental E-scores for every 8-mer DNA sequence, min-max normalized to
    [0, 1] (tf_binding.py:32-41); both strands map to the same score
    (tf_binding.py:40-41).
  * `registry()` exposes one problem per Barrera et al. (2016) data file with
    the same 14 fixed starting sequences (tf_binding.py:47-93).

Each landscape is a dense float32[4^8] score table; a batch of sequences
becomes a base-4 index vector and fitness is one gather.  All 200
landscapes are packed into one [200, 65536] array, read in place from the
JAX package's data directory (`flexs_tpu/landscapes/data/tf_binding.npz`,
built by `scripts/build_tf_binding_data.py` from the raw TSVs), so a sweep
over landscapes gathers from one stacked table (`parallel.sweep`).
"""
import functools
import os
from typing import Dict, Optional

import numpy as np
import torch

from flexs_tpu_torch.alphabet import DNAA, Alphabet
from flexs_tpu_torch.device import resolve_device
from flexs_tpu_torch.landscape import Landscape
from flexs_tpu_torch.types import SEQUENCES_TYPE

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_PACKED_FILE = os.path.join(_REPO, "flexs_tpu", "landscapes", "data", "tf_binding.npz")

_DNA = Alphabet(DNAA)

# 14 fixed starting sequences, identical to reference tf_binding.py:75-90.
STARTS = [
    "GCTCGAGC",
    "GCGCGCGC",
    "TGCGCGCC",
    "ATATAGCC",
    "GTTTGGTA",
    "ATTATGTT",
    "CAGTTTTT",
    "AAAAATTT",
    "AAAAACGC",
    "GTTGTTTT",
    "TGCTTTTT",
    "AAAGATAG",
    "CCTTCTTT",
    "AAAGAGAG",
]


@functools.lru_cache(maxsize=1)
def _packed_tables():
    """(names, float32[N, 65536] score tables) as numpy, loaded once per process."""
    if not os.path.exists(_PACKED_FILE):
        raise FileNotFoundError(
            f"Packed TF-binding tables not found at {_PACKED_FILE}. "
            "Run scripts/build_tf_binding_data.py to generate them from the "
            "raw Barrera et al. (2016) TSV measurements."
        )
    with np.load(_PACKED_FILE) as data:
        names = [str(n) for n in data["names"]]
        tables = data["tables"]
    return names, tables


@functools.lru_cache(maxsize=None)
def _device_tables(device: torch.device):
    """(names, the stacked tables on `device`), uploaded once per device.

    Constructing many TFBinding instances (sweeps, benchmarks) then takes
    row views of one resident table instead of uploading 256 KB each.
    """
    names, tables = _packed_tables()
    return names, torch.as_tensor(tables, device=device)


def tokens_to_index(tokens):
    """Base-4 index int64[...] of int[..., L] DNA tokens (alphabet order TGCA)."""
    tokens = torch.as_tensor(tokens).long()
    powers = 4 ** torch.arange(tokens.shape[-1] - 1, -1, -1, device=tokens.device)
    return (tokens * powers).sum(dim=-1)


def device_fitness_fn(table, tokens) -> torch.Tensor:
    """Pure fitness f32[B]: the score table gathered at int[B, 8] tokens.

    Module-level, so the fused runner sees one stable function for every
    TF-binding landscape; `table` is the landscape's float32[4^8] tensor.
    """
    return table[tokens_to_index(tokens)]


def table_from_tsv(landscape_file: str) -> np.ndarray:
    """Build a dense float32[4^8] score table from a reference-format TSV.

    Mirrors the normalization of reference tf_binding.py:32-41: min-max
    normalize the E-score column, map both strands ("8-mer", "8-mer.1") to
    the same normalized score.
    """
    import pandas as pd

    data = pd.read_csv(landscape_file, sep="\t")
    score = data["E-score"].to_numpy(dtype=np.float64)
    norm_score = (score - score.min()) / (score.max() - score.min())

    table = np.zeros(4**8, dtype=np.float32)
    for col in ("8-mer", "8-mer.1"):
        idx = tokens_to_index(_DNA.encode(data[col].to_list())).numpy()
        table[idx] = norm_score
    return table


class TFBinding(Landscape):
    """Binding affinity of 8-mer DNA sequences to a transcription factor.

    Construct from a packed table entry (`name="SIX6_REF_R1"`), from a
    reference-format TSV (`landscape_file=...`), or from an explicit
    `table` array.  A JAX package landscape carries over as
    `TFBinding(table=np.asarray(jax_landscape.table))`.
    """

    def __init__(
        self,
        landscape_file: Optional[str] = None,
        name: Optional[str] = None,
        table: Optional[np.ndarray] = None,
        device=None,
    ):
        """Create a TFBinding landscape from one of the three sources.

        `device` is where the table lives and scoring runs (default "cuda";
        pass "cpu" to run on the CPU).
        """
        super().__init__(name="TF_Binding")
        self.device = resolve_device(device)

        if table is not None:
            self.table = torch.tensor(np.asarray(table, np.float32), device=self.device)
        elif landscape_file is not None:
            self.table = torch.as_tensor(table_from_tsv(landscape_file), device=self.device)
        elif name is not None:
            names, tables = _device_tables(self.device)
            try:
                i = names.index(name)
            except ValueError:
                raise ValueError(
                    f"Unknown TF-binding landscape {name!r}; "
                    f"known: {names[:5]}... ({len(names)} total)"
                ) from None
            self.table = tables[i]  # a row view of the resident table
        else:
            raise ValueError("Provide one of `landscape_file`, `name`, `table`")

    def fitness_from_tokens(self, tokens) -> torch.Tensor:
        """f32[B] scores of int[B, 8] DNA tokens, on the landscape's device."""
        return device_fitness_fn(self.table, torch.as_tensor(tokens, device=self.device))

    def device_fitness(self):
        """(pure fitness fn, params) pair for the fused runner; params = the table."""
        return device_fitness_fn, self.table

    def _fitness_function(self, sequences: SEQUENCES_TYPE) -> np.ndarray:
        seqs = list(sequences)
        if not seqs:
            return np.zeros(0, np.float64)
        scores = self.fitness_from_tokens(_DNA.encode(seqs))
        return scores.cpu().numpy().astype(np.float64)


def registry() -> Dict[str, Dict]:
    """Return problems {name: {"params": ..., "starts": [...]}}.

    One problem per packed landscape, with the reference's fixed starting
    sequences (tf_binding.py:47-93).
    """
    names, _ = _packed_tables()
    return {
        problem_name: {"params": {"name": problem_name}, "starts": list(STARTS)}
        for problem_name in names
    }
