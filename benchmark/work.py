"""The work the inputs need, and the least time the chip could take for it.

Counted from shapes and host-side counts, whatever implementation does the
work; the peaks are `peaks.json`'s.
"""
import json
import os
from dataclasses import dataclass, field

PEAKS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")


def peaks() -> dict:
    with open(PEAKS_FILE) as f:
        return json.load(f)


@dataclass
class Lookup:
    """Operations and bytes of masked nearest-neighbour lookups over packed rows.

    For each cell, its queries x its filled rows x the 32-bit words of a
    packed row: one XOR, the fold of each symbol's bits ((bits - 1) shifts
    and ORs, one AND), one popcount and one add a word, and one compare a row
    for the min.  Bytes: the packed queries and the filled rows, each read
    once, and each query's minimum and argmin (4 bytes each) written once.
    """

    ops: dict = field(default_factory=lambda: dict.fromkeys(
        ("int_add", "logic", "shift", "compare", "popc"), 0))
    bytes: int = 0
    calls: int = 0

    def add(self, queries: int, fills, words: int, bits: int) -> None:
        """One call: `queries` rows a cell against each cell's `fills` filled rows."""
        pairs = queries * sum(fills)
        self.ops["logic"] += pairs * words * (1 + (bits - 1) + 1)
        self.ops["shift"] += pairs * words * (bits - 1)
        self.ops["popc"] += pairs * words
        self.ops["int_add"] += pairs * words
        self.ops["compare"] += pairs
        self.bytes += sum(queries * words * 4 + n * words * 4 + queries * 8 for n in fills)
        self.calls += 1

    def copy(self) -> "Lookup":
        return Lookup(dict(self.ops), self.bytes, self.calls)

    def minus(self, other: "Lookup") -> "Lookup":
        return Lookup({k: v - other.ops[k] for k, v in self.ops.items()},
                      self.bytes - other.bytes, self.calls - other.calls)


def lookup_ops_s(work: Lookup, pk: dict, sm_clock_mhz: float) -> float:
    """Least seconds for the operations: the slowest class at its own per-SM rate."""
    per_s = pk["sms"] * sm_clock_mhz * 1e6
    return max(n / (pk["per_sm_per_clock"][k] * per_s) for k, n in work.ops.items())


def lookup_bound_s(work: Lookup, pk: dict, sm_clock_mhz: float) -> float:
    """The roofline's time: the larger of the operations' and the bytes' least times."""
    return max(lookup_ops_s(work, pk, sm_clock_mhz), work.bytes / pk["hbm_bytes_per_s"])


def bert_flops(config) -> float:
    """Matrix-product FLOPs of one forward at the sequence's real tokens (no padding)."""
    t, h, i = config["tokens"], config["hidden"], config["intermediate"]
    layer = 8 * t * h * h + 4 * t * h * i + 4 * t * t * h
    head = 2 * h * h + 2 * h * config["value_hidden"] + 2 * config["value_hidden"]
    return config["layers"] * layer + head


def distinct_rows(landscape_cost_final: int, measured: int) -> int:
    """Distinct rows a NAM run scored: the start and every row inserted in the model's cache.

    A NAM run charges 1 for the start, 2 for each inserted row (its signal and
    its nearest neighbour, whose truth the cache already holds) and 1 for each
    measured proposal, a row already inserted.
    """
    return 1 + (landscape_cost_final - 1 - measured) // 2
