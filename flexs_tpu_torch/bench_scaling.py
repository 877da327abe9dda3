"""Sweep scaling: cells/s against grid width and ranks.

    python -m flexs_tpu_torch.bench_scaling --cpu-mesh     # CPU, 1/2/4/8 gloo ranks
    python -m flexs_tpu_torch.bench_scaling                # the card
    torchrun --nproc-per-node N -m flexs_tpu_torch.bench_scaling

Counterpart of scripts/bench_scaling.py, with its flag and lines.  The
sweep's multi-card claim is that cells split over the ranks with no
collective while they run, so N ranks give about N times one rank's cells/s.

  1. `--cpu-mesh` (the counterpart of `cpu_mesh_checks`): the script's
     8-cell grid (packed table 0 in every cell, start all zeros, signal
     strength 1, seeds 0-7, 2 rounds x 5 x 20) on the CPU under 1, 2, 4 and
     8 gloo ranks, each a process of its own over
     `parallel.multihost.multihost_sweep_mesh()`.  Each rank counts the
     `torch.distributed` calls it makes during the sweep, by wrapping them
     for that run only: none may come while its cells run, and outside the
     cells only `gather_to_host`'s gathers, one a chunk.  The cells must
     divide evenly over the ranks, and every rank count's frame must equal
     the 1-rank frame bitwise.  The JAX script reads the compiled
     program's HLO instead; the port compiles nothing, so it counts calls.
  2. default (the counterpart of `tpu_grid_scaling`): cells/s of the
     robustness sweep at 8/16/32/64 TF-Bind landscapes x `STARTS[:1]` x 5
     signal strengths, 10 rounds x 100 x 2000, chunks of 40, after a
     warm-up on 8 landscapes.  One process runs every cell on its card;
     under `torchrun --nproc-per-node N` the ranks split each chunk
     (`bench_sweep.sweep_mesh_and_device`) and the first rank prints.
     A line per width, then a JSON line with the card's name and power
     limit.  `--cpu` runs on the CPU; otherwise it needs a card.
"""
import argparse
import contextlib
import functools
import json
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np

from flexs_tpu_torch.bench import SIGNAL_STRENGTHS, card_string, timed
from flexs_tpu_torch.bench_sweep import sweep_mesh_and_device

CPU_MESH_SIZES = (1, 2, 4, 8)
CPU_MESH_CELLS = 8
CPU_MESH_RUN = dict(rounds=2, sequences_batch_size=5, model_queries_per_batch=20)
CPU_MESH_TABLES = 2  # the script's `packed[:2]`; every cell reads table 0
RANK_TIMEOUT_S = 300
WIDTHS = (8, 16, 32, 64)
WARM_LANDSCAPES = 8
GRID_RUN = dict(rounds=10, sequences_batch_size=100, model_queries_per_batch=2000)
CHUNK = 40
# Every torch.distributed function that moves data between ranks.
DIST_CALLS = (
    "all_gather", "all_gather_into_tensor", "all_gather_object", "all_reduce", "all_to_all",
    "all_to_all_single", "barrier", "batch_isend_irecv", "broadcast", "broadcast_object_list",
    "gather", "gather_object", "irecv", "isend", "monitored_barrier", "recv", "reduce",
    "reduce_scatter", "reduce_scatter_tensor", "scatter", "scatter_object_list", "send",
)


@contextlib.contextmanager
def counted_dist_calls():
    """Count each torch.distributed call by where it came from while inside.

    Yields {"cells": [...], "gathers": [...], "other": [...]}: the names of
    the calls made while a chunk's cells ran (`sweep._run_chunk`), inside
    `multihost.gather_to_host`, and elsewhere.  The attributes are
    replaced for the block only; callers look them up at call time.
    """
    import torch.distributed as dist

    from flexs_tpu_torch.parallel import multihost, sweep

    calls = {"cells": [], "gathers": [], "other": []}
    where = ["other"]

    def counting(name, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            calls[where[-1]].append(name)
            return fn(*args, **kwargs)
        return wrapper

    def inside(label, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            where.append(label)
            try:
                return fn(*args, **kwargs)
            finally:
                where.pop()
        return wrapper

    swaps = [(dist, name, counting(name, getattr(dist, name)))
             for name in DIST_CALLS if hasattr(dist, name)]
    swaps += [(sweep, "_run_chunk", inside("cells", sweep._run_chunk)),
              (multihost, "gather_to_host", inside("gathers", multihost.gather_to_host))]
    originals = [(owner, name, getattr(owner, name)) for owner, name, _ in swaps]
    for owner, name, fn in swaps:
        setattr(owner, name, fn)
    try:
        yield calls
    finally:
        for owner, name, fn in originals:
            setattr(owner, name, fn)


def cpu_mesh_grid():
    """(tables, table_idx, start_tokens, signal_strengths, seeds, cfg) of the script's grid."""
    from flexs_tpu_torch.landscapes import tf_binding
    from flexs_tpu_torch.runtime.jit_runner import AdaleadConfig

    _, packed = tf_binding._packed_tables()
    cells = CPU_MESH_CELLS
    return (
        np.asarray(packed[:CPU_MESH_TABLES], np.float32),
        np.zeros(cells, np.int64),
        np.zeros((cells, 8), np.int64),
        np.ones(cells, np.float32),
        np.arange(cells, dtype=np.int64),
        AdaleadConfig(alphabet_size=4, **CPU_MESH_RUN),
    )


def cpu_mesh_rank(port: int, world: int, rank: int, out_dir: str) -> None:
    """One rank of `--cpu-mesh`: the grid over the mesh, its frame and calls to `out_dir`."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from flexs_tpu_torch.parallel import multihost
    from flexs_tpu_torch.parallel.sweep import sweep_adalead_nam

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank, timeout=timedelta(seconds=RANK_TIMEOUT_S - 60))
    try:
        mesh = multihost.multihost_sweep_mesh()
        with counted_dist_calls() as calls:
            result = sweep_adalead_nam(*cpu_mesh_grid(), mesh=mesh, device="cpu")
        np.savez(os.path.join(out_dir, f"frame_{rank}.npz"), **result._asdict())
        with open(os.path.join(out_dir, f"calls_{rank}.json"), "w") as f:
            json.dump(calls, f)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(world: int, out_dir: str, timeout: float = RANK_TIMEOUT_S) -> None:
    """Start `world` processes of `cpu_mesh_rank` and wait for all; raise if one fails."""
    port = _free_port()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    code = ("import sys; from flexs_tpu_torch.bench_scaling import cpu_mesh_rank; "
            "cpu_mesh_rank(*map(int, sys.argv[1:4]), sys.argv[4])")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(port), str(world), str(rank),
                               out_dir], cwd=root, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for rank in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [(r, p.returncode, logs[r][-2000:]) for r, p in enumerate(procs) if p.returncode]
    if failed:
        raise RuntimeError(f"ranks failed at world size {world}: {failed}")


def cpu_mesh_checks(sizes=CPU_MESH_SIZES) -> dict:
    """`--cpu-mesh`: the grid under each rank count; {ranks: calls of rank 0} if all pass."""
    cells = CPU_MESH_CELLS
    frames, readings = {}, {}
    for world in sizes:
        assert cells % world == 0, f"{cells} cells do not divide over {world} ranks"
        with tempfile.TemporaryDirectory() as tmp:
            run_ranks(world, tmp)
            calls = []
            for rank in range(world):
                with np.load(os.path.join(tmp, f"frame_{rank}.npz")) as data:
                    frames[world, rank] = {k: data[k] for k in data.files}
                with open(os.path.join(tmp, f"calls_{rank}.json")) as f:
                    calls.append(json.load(f))
        first = frames[sizes[0], 0]
        for rank in range(world):
            frame = frames[world, rank]
            same = frame.keys() == first.keys() and all(
                np.array_equal(frame[k], first[k]) for k in first)
            assert same, f"rank {rank} of {world}: frame differs from the {sizes[0]}-rank frame"
        during = sorted({name for c in calls for name in c["cells"]})
        other = sorted({name for c in calls for name in c["other"]})
        gathers = [len(c["gathers"]) for c in calls]
        # One chunk: one all_gather_object a rank over several ranks, none alone.
        want = [] if world == 1 else ["all_gather_object"]
        assert not other, f"{world} ranks: calls outside the cells and gathers: {other}"
        assert all(c["gathers"] == want for c in calls), (world, calls)
        print(f"ranks={world}: collectives while cells run={during or 'NONE'}; "
              f"gathers={gathers[0]}; cells/rank={cells // world} "
              f"(even={cells % world == 0}); frame == {sizes[0]}-rank frame bitwise",
              flush=True)
        assert not during, f"collectives while the cells ran at {world} ranks: {during}"
        readings[world] = calls[0]
    print("cpu-mesh check PASSED: the sweep's cells run collective-free at every rank "
          "count, one gather a chunk; total throughput = N_cards x per-card rate", flush=True)
    return readings


def grid_sweep(n_landscapes: int, mesh=None, device=None, chunk: int = CHUNK, **run):
    """The robustness sweep of the first `n_landscapes` TF-Bind landscapes at a width."""
    from flexs_tpu_torch.landscapes import tf_binding
    from flexs_tpu_torch.parallel import run_robustness_sweep

    names, _ = tf_binding._packed_tables()
    return run_robustness_sweep(
        landscape_names=names[:n_landscapes], starts=tf_binding.STARTS[:1],
        signal_strengths=list(SIGNAL_STRENGTHS), chunk_size=chunk, mesh=mesh, device=device,
        **{**GRID_RUN, **run})


def grid_scaling(widths=WIDTHS, warm_landscapes: int = WARM_LANDSCAPES, chunk: int = CHUNK,
                 device=None, **run) -> list:
    """The default mode: cells/s at each grid width; a JSON reading per width."""
    from flexs_tpu_torch.ops import cuda_duplex
    from flexs_tpu_torch.parallel import multihost

    mesh, device = sweep_mesh_and_device(device)
    rank, n_ranks = multihost.mesh_share(mesh)
    card = card_string(device)
    kw = dict(mesh=mesh, device=device, chunk=chunk, **run)
    cuda_duplex.reset_launch_counts()
    timed(lambda: grid_sweep(warm_landscapes, **kw), device)  # warm-up
    if rank == 0:
        print(f"grid-width scaling on {n_ranks} rank(s) of {card} (per-cell cost should be "
              "~constant):", flush=True)
    readings = []
    for n_land in widths:
        df, wall = timed(lambda: grid_sweep(n_land, **kw), device)
        cells = len(df)
        seqs = int(df["model_cost"].sum() + df["landscape_cost"].sum())
        reading = {"cells": cells, "wall_s": wall, "cells_per_s": cells / wall,
                   "seqs_per_s": seqs / wall, "n_ranks": n_ranks,
                   "duplex_launches": sum(cuda_duplex.launch_counts().values()), "card": card}
        readings.append(reading)
        if rank == 0:
            print(f"  {cells:4d} cells: {wall:6.1f}s  {cells / wall:6.2f} cells/s  "
                  f"{seqs / wall:9.0f} seqs/s", flush=True)
            print(json.dumps(reading), flush=True)
    return readings


def main(argv=None, device=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--cpu-mesh", action="store_true")
    parser.add_argument("--cpu", action="store_true", help="run the default mode on the CPU")
    args = parser.parse_args(argv)
    if args.cpu_mesh:
        cpu_mesh_checks()
    else:
        grid_scaling(device="cpu" if args.cpu else device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
