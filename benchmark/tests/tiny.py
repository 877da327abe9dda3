"""Small sizes of each cell, for rehearsals of the harness on the CPU.

A cell staged under `benchmark/staged/` (built, not declared) is rehearsed
in a tree of its own whose `BENCHMARK.json` adds its entries, as a later
change would.
"""
import atexit
import functools
import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile

from benchmark import run

ROOT = run.HERE.rsplit("/", 1)[0]

TINY = {
    "tfbind8-adalead-nam.chunk40": {
        "config": {"rounds": 2, "sequences_batch_size": 10, "model_queries_per_batch": 40,
                   "signal_strengths": [0.0, 0.5, 1.0]},
        "traffic": {"landscapes_per_unit": 2, "chunk_size": 4},
    },
    "gfp-adalead-nam.run1": {
        "config": {"hidden": 64, "layers": 2, "heads": 1, "intermediate": 256,
                   "oracle_rows_per_pass": 8, "sequences_batch_size": 10,
                   "model_queries_per_batch": 40},
        "traffic": {"warmup_queries": 40},
    },
}
SEED = 2**31 + 977


def bench(staged=False) -> dict:
    """BENCHMARK.json, with the staged cells' entries added where `staged`."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    if staged:
        for path in sorted(glob.glob(os.path.join(ROOT, "benchmark", "staged", "*.json"))):
            with open(path) as f:
                extra = json.load(f)
            for key in ("configs", "workloads", "end_to_end", "per_layer"):
                b[key] += extra[key]
    return b


DECLARED = sorted(w["name"] for w in bench()["workloads"])


@functools.lru_cache(maxsize=None)
def staged_root() -> str:
    """A tree whose BENCHMARK.json declares the staged cells too; the rest linked to this one."""
    root = tempfile.mkdtemp(prefix="bench_staged_")
    atexit.register(shutil.rmtree, root, True)
    for name in ("benchmark", "flexs_tpu"):
        os.symlink(os.path.join(ROOT, name), os.path.join(root, name))
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench(staged=True), f)
    return root


def root_of(workload) -> str:
    return ROOT if workload in DECLARED else staged_root()


def spec(workload, root=None):
    return run.load_cell(root or root_of(workload), workload, TINY[workload])


def rehearse(workload, trace=False, root=None, **kwargs):
    """One run of the cell at its tiny size on the CPU: the result dict."""
    return run.run_cell(spec(workload, root), SEED, 0.01, trace, "cpu", **kwargs)


def in_subprocess(code: str) -> dict:
    """Run `code` in a fresh interpreter at the repo's root; the JSON of its last line."""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])
