"""Warm walls of the fused RNABinding run in several checkouts, interleaved, on one CUDA card.

    python -m flexs_tpu_torch.compare_fused_walls TREE [TREE ...] [--runs 7]

Each TREE is a directory that holds a `flexs_tpu_torch` package: the root
of this checkout, or another commit unpacked with `git archive`.  The
script starts one worker process per tree.  A worker imports that tree's
package, builds its kernel and runs DeviceAdaleadNAM on L100_RNA1 (10
rounds x 100 proposals x 2000 model queries, NAM at signal strength 0.9,
seed 0, start 1: the fused run of `chip_smoke.py` and `profile_main_path`)
twice to warm up.  Then the script asks the workers for one timed run
each, in turn, `--runs` times, reversing the order every time (A B C,
C B A, A B C, ...), so that a drift of the card or the host falls on every
tree alike.  Only one worker runs at a time.

Prints one JSON line: the card's name and power limit, and per tree its
walls in order, their median, quartiles, min and max, and the top true score and
duplex kernel launches of every timed run (these must agree between trees
whose runs are meant to be the same).
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

WARM_UP_RUNS = 2


def worker(tree: str) -> None:
    """Serve timed runs of `tree`'s package: one per "run" line on stdin."""
    sys.path[0] = tree
    import torch

    import flexs_tpu_torch as flexs
    from flexs_tpu_torch.landscapes import rna
    from flexs_tpu_torch.ops import cuda_duplex

    problem = rna.registry()["L100_RNA1"]
    landscape = rna.RNABinding(**problem["params"])
    runner = flexs.runtime.DeviceAdaleadNAM(
        landscape, flexs.RNAA, rounds=10, sequences_batch_size=100,
        model_queries_per_batch=2000, starting_sequence=problem["starts"][1],
        signal_strength=0.9, seed=0,
    )

    def timed() -> dict:
        cuda_duplex.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        df, _ = runner.run(verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return {
            "wall_s": wall,
            "top": float(df["true_score"].max()),
            "duplex_launches": cuda_duplex.launches,
        }

    for _ in range(WARM_UP_RUNS):
        timed()
    print(json.dumps({"ready": True}), flush=True)
    for line in sys.stdin:
        if line.strip() != "run":
            break
        print(json.dumps(timed()), flush=True)


def _reply(proc) -> dict:
    """The worker's next JSON line (a build may print other lines first)."""
    for line in proc.stdout:
        if line.startswith("{"):
            return json.loads(line)
    raise RuntimeError(f"worker exited with code {proc.wait()} before replying")


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def compare(trees, runs: int) -> dict:
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", os.path.abspath(tree)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, cwd=tree,
        )
        for tree in trees
    ]
    try:
        for proc in procs:
            _reply(proc)
        readings = [[] for _ in trees]
        order = list(range(len(trees)))
        for i in range(runs):
            for k in (order if i % 2 == 0 else order[::-1]):
                procs[k].stdin.write("run\n")
                procs[k].stdin.flush()
                readings[k].append(_reply(procs[k]))
    finally:
        for proc in procs:
            if proc.stdin:
                proc.stdin.close()
        for proc in procs:
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    out = {"card": _card(), "runs": runs, "trees": {}}
    for tree, rs in zip(trees, readings):
        walls = [r["wall_s"] for r in rs]
        q1, median, q3 = statistics.quantiles(walls, n=4)
        out["trees"][tree] = {
            "walls_s": walls,
            "median_s": median,
            "q1_s": q1,
            "q3_s": q3,
            "min_s": min(walls),
            "max_s": max(walls),
            "tops": sorted({r["top"] for r in rs}),
            "duplex_launches": sorted({r["duplex_launches"] for r in rs}),
        }
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("trees", nargs="+")
    parser.add_argument("--runs", type=int, default=7)
    parser.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.worker:
        worker(args.trees[0])
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("compare_fused_walls needs a CUDA card")
    print(json.dumps(compare(args.trees, args.runs)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
