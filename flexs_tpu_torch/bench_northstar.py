"""North-star benchmark: every fused explorer family x all TF-Bind-8 landscapes on the card.

    python -m flexs_tpu_torch.bench_northstar                      # all 12 families
    python -m flexs_tpu_torch.bench_northstar --families adalead random --cpu
    python -m flexs_tpu_torch.bench_northstar --full-robustness    # adalead x 5 ss

Counterpart of scripts/bench_northstar.py, with its flags and lines.  The
grid is every fused family over the 200 TF-Bind-8 landscapes from the
first start, one sweep per family through `parallel.run_robustness_sweep`'s
`algorithm=`.  Per family it prints, as the family ends, one JSON line: the
warm wall (after a warm-up sweep of the exact chunk shape the timed sweep
runs), sequences scored per second and the quality distribution over the
grid; then a summary line against the measured single-core reference
baseline (BASELINE_MEASURED.json, the Adalead headline config).  Every
line carries the card's name and power limit.

The port compiles nothing ahead of a run: the warm-up pays the kernels'
builds, the allocator's first growth and cuDNN's autotuning instead.
Every wall ends in a device synchronize.  One process runs every cell on
its card (no mesh); under `torchrun --nproc-per-node N` the ranks split
each chunk over the mesh of `parallel.multihost.multihost_sweep_mesh()`
and the first rank prints.  `--cpu` runs on the CPU; otherwise it needs a
card.
"""
import argparse
import json
import sys

from flexs_tpu_torch.bench import baseline, card_string, timed
from flexs_tpu_torch.bench_sweep import sweep_mesh_and_device

FAMILIES = [
    "random",
    "adalead",
    "ga",
    "cmaes",
    "bo",
    "gpr_bo",
    "dqn",
    "ppo",
    "dynappo",
    "dynappo_mutative",
    "cbas",
    "dbas",
]
FULL_ROBUSTNESS_SS = [0.0, 0.5, 0.75, 0.9, 1.0]  # the reference's evaluate.py:11


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--families", nargs="+", default=FAMILIES, choices=FAMILIES)
    p.add_argument("--landscapes", type=int, default=0,
                   help="0 = all shipped TF-Bind-8 landscapes")
    p.add_argument("--ss", type=float, nargs="+", default=[0.9],
                   help="NoisyAbstractModel signal strengths per cell")
    p.add_argument("--rounds", type=int, default=10)
    p.add_argument("--batch", type=int, default=100)
    p.add_argument("--queries", type=int, default=2000)
    p.add_argument("--chunk", type=int, default=40)
    p.add_argument(
        "--cell-mode", default="auto", choices=["auto", "vmap", "map"],
        help="per-chunk cell schedule (parallel/sweep.py): 'vmap' runs a "
        "chunk's cells in lockstep, 'map' one after another; scores are "
        "identical",
    )
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    p.add_argument(
        "--full-robustness", action="store_true",
        help="also run the flagship full robustness grid: adalead x all "
        "landscapes x the reference's 5 signal strengths (evaluate.py:11)",
    )
    return p


def warm_names(names, n_ss: int, chunk: int, mesh_size: int):
    """The landscapes of the warm-up sweep: the exact chunk shape the timed sweep dispatches.

    The sweep engine rounds the chunk up to a multiple of the mesh's size
    and pads every tail chunk to it, so a grid larger than one chunk only
    ever dispatches C-cell chunks, and a grid of n <= C cells is one exact
    n-cell batch.
    """
    c = -(-chunk // mesh_size) * mesh_size
    if len(names) * n_ss <= c:
        return list(names)  # the identical single batch
    k, rem = divmod(c, n_ss)
    # k+1 names overflow one chunk, so the tail pads back to exactly c cells.
    return list(names[: k + (1 if rem else 0)])


def sweep(args, family: str, land_names, ss, mesh=None, device=None):
    """One family's robustness sweep over `land_names` at the flags' sizes, from STARTS[0]."""
    from flexs_tpu_torch.landscapes import tf_binding
    from flexs_tpu_torch.parallel import run_robustness_sweep

    return run_robustness_sweep(
        landscape_names=land_names, starts=tf_binding.STARTS[:1], signal_strengths=ss,
        rounds=args.rounds, sequences_batch_size=args.batch,
        model_queries_per_batch=args.queries, chunk_size=args.chunk, mesh=mesh,
        algorithm=family, cell_mode=args.cell_mode, device=device,
    )


def warm(args, family: str, names, ss, mesh=None, device=None) -> None:
    """The warm-up sweep of the chunk shape that the timed sweep of `names` dispatches."""
    from flexs_tpu_torch.parallel import multihost

    mesh_size = multihost.mesh_share(mesh)[1]
    timed(lambda: sweep(args, family, warm_names(names, len(ss), args.chunk, mesh_size), ss,
                        mesh, device), device)


def main(argv=None, device=None) -> int:
    """The grid; `device` for tests."""
    args = parser().parse_args(argv)

    from flexs_tpu_torch.landscapes import tf_binding
    from flexs_tpu_torch.parallel import multihost

    mesh, device = sweep_mesh_and_device("cpu" if args.cpu else device)
    rank, mesh_size = multihost.mesh_share(mesh)
    card = card_string(device)
    names, _ = tf_binding._packed_tables()
    if args.landscapes:
        names = names[: args.landscapes]
    base_sps, _ = baseline()

    grids = [(f, args.ss) for f in args.families]
    if args.full_robustness:
        grids.append(("adalead", FULL_ROBUSTNESS_SS))

    total_seqs, total_wall, lines = 0, 0.0, []
    for family, ss in grids:
        warm(args, family, names, ss, mesh, device)
        df, wall = timed(lambda: sweep(args, family, names, ss, mesh, device), device)
        seqs = int(df["model_cost"].sum() + df["landscape_cost"].sum())
        total_seqs += seqs
        total_wall += wall
        line = {
            "family": family,
            "signal_strengths": ss,
            "cells": len(df),
            "wall_s": round(wall, 2),
            "seqs": seqs,
            "seqs_per_sec": round(seqs / wall, 1),
            "mean_max_fitness": round(float(df["max_fitness"].mean()), 4),
            "min_max_fitness": round(float(df["max_fitness"].min()), 4),
            "card": card,
        }
        lines.append(line)
        if rank == 0:
            print(json.dumps(line), flush=True)

    summary = {
        "metric": "northstar_all_explorers_all_landscapes",
        "landscapes": len(names),
        "families": len(args.families),
        "total_cells": int(sum(l["cells"] for l in lines)),
        "total_seqs": total_seqs,
        "total_wall_s": round(total_wall, 2),
        "seqs_per_sec": round(total_seqs / total_wall, 1),
        "n_devices": mesh_size,
        "vs_baseline": (
            round(total_seqs / total_wall / base_sps, 2) if base_sps else None
        ),
        "card": card,
    }
    if rank == 0:
        print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
