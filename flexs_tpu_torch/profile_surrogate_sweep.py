"""A/B profile of the trained-surrogate sweep's cost a cell, hypothesis by hypothesis.

    python -m flexs_tpu_torch.profile_surrogate_sweep h0 h2 ...   [--cpu]

Counterpart of scripts/profile_surrogate_sweep.py, with its hypotheses,
lines and helpers (`_median3`, `_single`, `_sweep`).  Each is measured on
Rosetta 3msi with the trained CNN surrogate at 10 rounds x 100 x 2000, the
single run through `DeviceAdaleadNAM(model="surrogate")` and the sweep
through `run_landscape_robustness_sweep`:

  h0  single-run steady state (median of 3 after a warm-up)
  h1  20 serial single runs (the "don't sweep" floor)
  h2  the 20-cell sweep with its cells in lockstep (cell_mode "vmap")
  h3  arch=mlp single vs swept (is the convolution the cost?)
  h4  the 20-cell lockstep sweep at epochs=1 (is training the cost?)
  h5  a single run with a 3-CNN ensemble (does the member axis cost?)
  h6  20 IDENTICAL cells (same start and seed, so equal trip counts) in
      lockstep: near single-run cost convicts lockstep
  h7  the 20-cell grid with its cells one after another (cell_mode "map")

`_sweep` passes its cell mode explicitly, "vmap" unless told "map" (the
sweep's own default "auto" is "map" for a surrogate).  The 20 cells are
the registry's 5 starts x seeds 0-3.  Each hypothesis prints the script's
line, then a JSON line with the card's name and power limit.  Run one
hypothesis a process on the card, as the script asks; `--cpu` runs on the
CPU, otherwise it needs a card.
"""
import json
import sys
from typing import NamedTuple

import numpy as np

from flexs_tpu_torch.bench import card_string, timed
from flexs_tpu_torch.device import resolve_device


class Sizes(NamedTuple):
    """The script's run and grid sizes (keywords, so tests and the smoke run go small)."""

    rounds: int = 10
    sequences_batch_size: int = 100
    model_queries_per_batch: int = 2000
    cells: int = 20


SIZES = Sizes()


def _problem():
    from flexs_tpu_torch.landscapes import rosetta

    return rosetta.registry()["3msi"]


def _starts():
    return list(_problem()["starts"].values())


def _landscape(device):
    from flexs_tpu_torch.landscapes import rosetta

    return rosetta.RosettaFolding(**_problem()["params"], device=device)


def _timed(fn, device):
    return timed(fn, resolve_device(device))


def _median3(fn, device):
    """(median, walls) of 3 calls of `fn` after a warm-up, each ended by a synchronize."""
    _timed(fn, device)  # warm: the first call's builds, handles and allocator growth
    walls = [_timed(fn, device)[1] for _ in range(3)]
    return float(np.median(walls)), walls


def _single(spec, start: int = 0, sizes: Sizes = SIZES, device=None):
    """The fused single run from the `start`-th registry start, seed 0."""
    import flexs_tpu_torch as flexs
    from flexs_tpu_torch.runtime.jit_runner import DeviceAdaleadNAM

    return DeviceAdaleadNAM(
        _landscape(device), flexs.AAS, rounds=sizes.rounds,
        sequences_batch_size=sizes.sequences_batch_size,
        model_queries_per_batch=sizes.model_queries_per_batch,
        starting_sequence=_starts()[start], model="surrogate", surrogate_spec=spec,
        device=device,
    )


def sweep_grid(cells: int, starts=None, seeds=None):
    """(starts, seeds) of `_sweep`: the first min(cells, 5) starts x enough seeds from 0."""
    all_starts = _starts()
    if starts is None:
        starts = all_starts[: min(cells, len(all_starts))]
    if seeds is None:
        seeds = list(range(-(-cells // len(starts))))
    return starts, seeds


def _sweep(spec, starts=None, seeds=None, cell_mode: str = "vmap", sizes: Sizes = SIZES,
           device=None):
    """A callable that runs the sweep of `sizes.cells` cells and returns its frame."""
    import flexs_tpu_torch as flexs
    from flexs_tpu_torch.parallel import run_landscape_robustness_sweep

    land = _landscape(device)
    starts, seeds = sweep_grid(sizes.cells, starts, seeds)

    def run():
        return run_landscape_robustness_sweep(
            [land], flexs.AAS, starts=starts, signal_strengths=[1.0], seeds=seeds,
            rounds=sizes.rounds, sequences_batch_size=sizes.sequences_batch_size,
            model_queries_per_batch=sizes.model_queries_per_batch, model="surrogate",
            surrogate_spec=spec, cell_mode=cell_mode, device=device,
        )

    return run


def _reading(name, median_s, walls, cells, cell_mode, single_median_s=None, frame=None):
    return {"hypothesis": name, "median_s": median_s, "walls_s": walls,
            "s_per_cell": median_s / cells, "cells": cells, "cell_mode": cell_mode,
            "single_median_s": single_median_s}, frame


def _swept(spec, sizes, device, cell_mode="vmap", **grid):
    """(median, walls, cells, last frame) of a sweep's median of 3."""
    run = _sweep(spec, cell_mode=cell_mode, sizes=sizes, device=device, **grid)
    frames = []
    med, walls = _median3(lambda: frames.append(run()), device)
    return med, walls, len(frames[-1]), frames[-1]


def h0(sizes: Sizes = SIZES, device=None):
    from flexs_tpu_torch.runtime.surrogate import SurrogateSpec

    ex = _single(SurrogateSpec(), sizes=sizes, device=device)
    med, walls = _median3(lambda: ex.run(verbose=False), device)
    print(f"h0 single cnn run:        {med:.3f}s  {['%.2f' % w for w in walls]}")
    return _reading("h0", med, walls, 1, "single")


def h1(sizes: Sizes = SIZES, device=None):
    from flexs_tpu_torch.runtime.surrogate import SurrogateSpec

    ex = _single(SurrogateSpec(), sizes=sizes, device=device)
    ex.run(verbose=False)
    n = sizes.cells
    _, dt = _timed(lambda: [ex.run(verbose=False) for _ in range(n)], device)
    print(f"h1 {n} serial cnn runs:    {dt:.2f}s = {dt / n:.3f}s/cell")
    return _reading("h1", dt, [dt], n, "serial")


def h2(sizes: Sizes = SIZES, device=None):
    from flexs_tpu_torch.runtime.surrogate import SurrogateSpec

    med, walls, cells, frame = _swept(SurrogateSpec(), sizes, device)
    print(f"h2 {cells}-cell cnn sweep:     {med:.2f}s = {med / cells:.3f}s/cell  "
          f"{['%.2f' % w for w in walls]}")
    return _reading("h2", med, walls, cells, "vmap", frame=frame)


def h3(sizes: Sizes = SIZES, device=None):
    from flexs_tpu_torch.runtime.surrogate import SurrogateSpec

    spec = SurrogateSpec(arch="mlp")
    ex = _single(spec, sizes=sizes, device=device)
    med_s, _ = _median3(lambda: ex.run(verbose=False), device)
    med_w, walls, cells, frame = _swept(spec, sizes, device)
    print(f"h3 mlp single {med_s:.3f}s vs sweep {med_w:.2f}s = {med_w / cells:.3f}s/cell "
          f"(ratio {med_w / (cells * med_s):.2f}x; cnn ratio from h0/h2 for comparison)")
    return _reading("h3", med_w, walls, cells, "vmap", single_median_s=med_s, frame=frame)


def h4(sizes: Sizes = SIZES, device=None):
    from flexs_tpu_torch.runtime.surrogate import SurrogateSpec

    med, walls, cells, frame = _swept(SurrogateSpec(epochs=1), sizes, device)
    print(f"h4 {cells}-cell sweep epochs=1: {med:.2f}s = {med / cells:.3f}s/cell")
    return _reading("h4", med, walls, cells, "vmap", frame=frame)


def h5(sizes: Sizes = SIZES, device=None):
    from flexs_tpu_torch.runtime.surrogate import SurrogateSpec

    ex = _single(SurrogateSpec(ensemble_size=3), sizes=sizes, device=device)
    med, walls = _median3(lambda: ex.run(verbose=False), device)
    print(f"h5 single 3xCNN run:      {med:.3f}s  {['%.2f' % w for w in walls]}")
    return _reading("h5", med, walls, 1, "single")


def h6(sizes: Sizes = SIZES, device=None):
    from flexs_tpu_torch.runtime.surrogate import SurrogateSpec

    # IDENTICAL cells: same start, same seed -> identical trip counts ->
    # lockstep costs nothing.  ~single-run cost here convicts lockstep.
    med, walls, cells, frame = _swept(SurrogateSpec(), sizes, device,
                                      starts=[_starts()[0]], seeds=[0] * sizes.cells)
    print(f"h6 {cells} IDENTICAL cells (vmap): {med:.2f}s = {med / cells:.3f}s/cell  "
          f"{['%.2f' % w for w in walls]}")
    return _reading("h6", med, walls, cells, "vmap", frame=frame)


def h7(sizes: Sizes = SIZES, device=None):
    from flexs_tpu_torch.runtime.surrogate import SurrogateSpec

    med, walls, cells, frame = _swept(SurrogateSpec(), sizes, device, cell_mode="map")
    print(f"h7 shipped grid, cells one by one: {med:.2f}s = {med / cells:.3f}s/cell  "
          f"{['%.2f' % w for w in walls]}")
    return _reading("h7", med, walls, cells, "map", frame=frame)


STEPS = {
    "h0": h0, "h1": h1, "h2": h2, "h3": h3, "h4": h4, "h5": h5,
    "h6": h6, "h7": h7,
}


def run_hypotheses(names, device, sizes: Sizes = SIZES) -> list:
    """Run each named hypothesis on `device` (a `torch.device`), printing its lines.

    Returns each hypothesis's last sweep frame (None for the single runs).
    """
    from flexs_tpu_torch.ops import cuda_duplex

    card = card_string(device)
    cuda_duplex.reset_launch_counts()
    frames = []
    for name in names:
        reading, frame = STEPS[name](sizes, device)
        print(json.dumps({**reading, "duplex_launches": sum(cuda_duplex.launch_counts().values()),
                          "card": card}), flush=True)
        frames.append(frame)
    return frames


def main(argv=None, device=None, sizes: Sizes = SIZES) -> int:
    """Run the named hypotheses (all by default); `device` and `sizes` for tests."""
    argv = list(sys.argv[1:] if argv is None else argv)
    cpu = "--cpu" in argv
    names = [a for a in argv if a != "--cpu"] or list(STEPS)
    unknown = [n for n in names if n not in STEPS]
    if unknown:
        raise SystemExit(f"unknown hypotheses {unknown}; one of {list(STEPS)} (and --cpu)")
    device = resolve_device("cpu" if cpu else device)
    print(f"backend: {device} {card_string(device)}")
    run_hypotheses(names, device, sizes)
    return 0


if __name__ == "__main__":
    sys.exit(main())
