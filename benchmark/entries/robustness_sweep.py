"""Units that are lockstep sweeps of a robustness grid (landscapes x signal strengths).

Traffic keys: `landscapes_per_unit` (drawn without replacement from the
family's landscapes), `chunk_size` (cells a lockstep batch).  Each unit
draws its landscapes and one seed for its cells from the run's seed.
Every cell starts from the configuration's `start`.  The warm-up is one
unit of its own draw at `WARMUP_ROUNDS` rounds: every shape of a round,
a cache no wider than the second round's.
"""
import numpy as np

from benchmark.outcome import Cell, split_cells

WARMUP_ROUNDS = 2


class Entry:
    def __init__(self, config, traffic, family, inputs, device, rng, capture):
        self.config, self.traffic, self.family = config, traffic, family
        self.device, self.rng, self.capture = device, rng, capture
        self.start = config["start"]
        self.start_tokens = np.array([config["alphabet"].index(c) for c in self.start], np.int64)
        self.keys = family.landscape_keys(config)

    def next_unit(self):
        picks = self.rng.choice(len(self.keys), self.traffic["landscapes_per_unit"], replace=False)
        return [self.keys[i] for i in picks], int(self.rng.integers(2**31))

    def run(self, unit, config=None):
        """The unit's cells, each with its captured result (still on the device)."""
        keys, seed = unit
        config = config or self.config
        self.capture.take()
        df = self.family.run_sweep(config, keys, [self.start], config["signal_strengths"], seed,
                                   self.traffic["chunk_size"], self.device)
        results = split_cells(self.capture.take(), len(df))
        return [
            Cell(row.landscape, self.start_tokens, float(row.signal_strength), int(row.seed),
                 float(row.max_fitness), res)
            for row, res in zip(df.itertuples(), results)
        ]

    def warm_up(self):
        """One unit of the cell's own shapes at `WARMUP_ROUNDS` rounds."""
        self.run(self.next_unit(), {**self.config,
                                    "rounds": min(WARMUP_ROUNDS, self.config["rounds"])})

    def lockstep_runs(self, n_cells: int) -> int:
        """Lockstep runs a unit of `n_cells` cells makes: one a chunk."""
        return -(-n_cells // self.traffic["chunk_size"])
