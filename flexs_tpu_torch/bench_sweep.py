"""Sweep benchmark: many full Adalead+NAM experiments as lockstep cells on the card.

    python -m flexs_tpu_torch.bench_sweep --landscapes 40 --ss 5

Counterpart of scripts/bench_sweep.py, with its flags.  Measures the
robustness-evaluator grid (landscapes x starts x signal strengths, 10
rounds x batch 100 x 2000 queries each) through the sweep engine after a
warm-up on one landscape, and prints one JSON line: sequences scored per
second per card, and the ratio to the measured single-run reference
baseline (BASELINE_MEASURED.json, the reference FLEXS on one CPU core).

One process runs every cell on its card (no mesh).  Under `torchrun
--nproc-per-node N` the ranks split the cells over the mesh of
`parallel.multihost.multihost_sweep_mesh()`, each on card LOCAL_RANK
modulo the cards it sees, the value is divided by N, and the first rank
prints the line.  Without a card it raises.
"""
import argparse
import json
import os
import sys

import torch

from flexs_tpu_torch.bench import SIGNAL_STRENGTHS, baseline, card_string, timed
from flexs_tpu_torch.device import resolve_device


def sweep_mesh_and_device(device=None):
    """(mesh, device): None and `device` in one process; torchrun's ranks' mesh under it."""
    if "WORLD_SIZE" not in os.environ:
        return None, resolve_device(device)
    from flexs_tpu_torch.parallel import multihost

    cards = torch.cuda.device_count()
    if device is None and cards > 1:
        device = f"cuda:{int(os.environ['LOCAL_RANK']) % cards}"
    return multihost.multihost_sweep_mesh(), resolve_device(device)


def main(argv=None, device=None, **sweep_kw) -> int:
    """The benchmark; `device` and `sweep_kw` (over `run_robustness_sweep`'s defaults) for tests."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--landscapes", type=int, default=40)
    parser.add_argument("--starts", type=int, default=1)
    parser.add_argument("--ss", type=int, default=5)
    parser.add_argument("--chunk", type=int, default=40)
    args = parser.parse_args(argv)

    from flexs_tpu_torch.landscapes import tf_binding
    from flexs_tpu_torch.parallel import multihost, run_robustness_sweep

    mesh, device = sweep_mesh_and_device(device)
    rank, n_ranks = multihost.mesh_share(mesh)
    names, _ = tf_binding._packed_tables()
    names = names[: args.landscapes]
    starts = tf_binding.STARTS[: args.starts]
    ss = list(SIGNAL_STRENGTHS[: args.ss])
    kw = dict(signal_strengths=ss, chunk_size=args.chunk, mesh=mesh, device=device, **sweep_kw)

    # Warmup on one chunk.
    run_robustness_sweep(landscape_names=names[:1], starts=starts[:1], **kw)

    df, wall = timed(lambda: run_robustness_sweep(landscape_names=names, starts=starts, **kw),
                     device)
    seqs = int(df["model_cost"].sum() + df["landscape_cost"].sum())
    base_sps, hardware = baseline()
    vs = (seqs / wall) / base_sps if base_sps else None
    if rank == 0:
        print(
            json.dumps(
                {
                    "metric": "robustness_sweep_seqs_per_sec_per_chip",
                    "cells": len(df),
                    "value": round(seqs / wall / n_ranks, 1),
                    "unit": "seqs/sec/chip",
                    "vs_baseline": round(vs, 2) if vs else None,
                    "wall_clock_s": round(wall, 1),
                    "mean_max_fitness": round(float(df["max_fitness"].mean()), 4),
                    "baseline_hardware": hardware,
                    "card": card_string(device),
                }
            ),
            flush=True,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
