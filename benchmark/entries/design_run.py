"""Units of fused design runs, `runtime.DeviceAdaleadNAM.run`, one after another.

Traffic keys: `starts` (keys of the configuration's `starts`),
`runs_per_unit` and `warmup_queries` (the warm-up run's model queries a
round).  Each run of a unit draws its start from `starts` and its seed
from the run's seed, and runs at the configuration's first signal
strength on the family's landscape.  The warm-up is one run of its own
draw at the configuration's rounds and `warmup_queries`.
"""
import numpy as np

from benchmark.outcome import Cell, split_cells


class Entry:
    def __init__(self, config, traffic, family, inputs, device, rng, capture):
        from flexs_tpu_torch.runtime import DeviceAdaleadNAM

        self.runner_cls = DeviceAdaleadNAM
        self.config, self.traffic, self.family = config, traffic, family
        self.inputs, self.device, self.rng, self.capture = inputs, device, rng, capture
        self.starts = config["starts"]
        self._landscape = None

    def landscape(self):
        """The family's landscape, built on first use (in the warm-up)."""
        if self._landscape is None:
            self._landscape = self.family.landscape(self.config, self.inputs, self.device)
        return self._landscape

    def next_unit(self):
        starts = self.traffic["starts"]
        ss = float(self.config["signal_strengths"][0])
        return [(starts[int(self.rng.integers(len(starts)))], ss, int(self.rng.integers(2**31)))
                for _ in range(self.traffic["runs_per_unit"])]

    def run(self, unit, config=None):
        config = config or self.config
        alphabet = config["alphabet"]
        cells = []
        for start, ss, seed in unit:
            seq = self.starts[start]
            self.capture.take()
            runner = self.runner_cls(
                self.landscape(), alphabet, rounds=config["rounds"],
                sequences_batch_size=config["sequences_batch_size"],
                model_queries_per_batch=config["model_queries_per_batch"],
                starting_sequence=seq, signal_strength=ss, seed=seed, device=self.device,
            )
            df, _ = runner.run(verbose=False)
            (result,) = split_cells(self.capture.take(), 1)
            tokens = np.array([alphabet.index(c) for c in seq], np.int64)
            cells.append(Cell(self.landscape().name, tokens, ss, seed, float(df["true_score"].max()),
                              result))
        return cells

    def warm_up(self):
        """One short run of the cell's shapes, and so one oracle pass or more."""
        self.run(self.next_unit()[:1],
                 {**self.config, "model_queries_per_batch": self.traffic["warmup_queries"]})

    def lockstep_runs(self, n_cells: int) -> int:
        """Runs a unit of `n_cells` cells makes: one a cell."""
        return n_cells
