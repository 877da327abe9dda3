"""Benchmark: the standard FLEXS paper config, fused on one CUDA card.

    python -m flexs_tpu_torch.bench

Counterpart of the repository's `bench.py`, with its stages, in its
order:

  single_run       TF-Bind-8 SIX6_REF_R1 + DeviceAdaleadNAM (NAM 0.9),
                   10 rounds x 100 x 2000 (the paper's headline config);
  sweep            the robustness sweep, 40 landscapes x 5 signal
                   strengths in chunks of 40 (the headline metric);
  eval_sweeps      the efficiency and adaptivity grids on 8 landscapes;
  surrogate_sweep  Rosetta 3msi x 5 starts x 4 seeds with the paper's CNN
                   retrained every round;
  rna_oracle       the CUDA duplex kernel at B=512, L1=L2=100, checked
                   bitwise against its plain version on a fresh batch.

Every wall is `time.perf_counter()` around a call that ends in
`torch.cuda.synchronize()`, and every median is of 3 timed repetitions
after one warm-up.  Each stage prints its own JSON line as soon as it
ends, `{"stage": ..., <its keys>, "stage_wall_s": ..., "card": "<name>,
<power limit>"}` (the stage's whole wall, warm-up included), so a run
cut by a time limit keeps what it measured.  The last line has
`bench.py`'s keys (its `pallas_bitexact_vs_xla` is
`duplex_kernel_bitexact_vs_plain` here) plus `card` and
`baseline_hardware`: `vs_baseline` divides by BASELINE_MEASURED.json's
`seqs_per_sec`, the reference FLEXS's single run on the CPU core its
`hardware` field names.  The script exits nonzero when the kernel
disagrees with its plain version, and raises without a card.

Each stage function takes `device` (default the card) and, as keyword
arguments, the sizes `bench.py` hard-codes, with its values as defaults;
each returns (its final-line keys, what it computed).
"""
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from flexs_tpu_torch.device import resolve_device

BASELINE_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "BASELINE_MEASURED.json"
)
SIGNAL_STRENGTHS = (0.0, 0.5, 0.75, 0.9, 1.0)
EFFICIENCY_BUDGETS = ((100, 500), (100, 5000), (1000, 5000), (1000, 10000))
ADAPTIVITY_ROUNDS = (1, 10, 100)
# The keys of each stage's line, between "stage" and "card".
STAGE_KEYS = {
    "single_run": ("single_run_wall_clock_s", "single_run_wall_clock_spread_s",
                   "single_run_seqs_per_sec", "single_run_vs_baseline", "top_fitness"),
    "sweep": ("metric", "value", "unit", "vs_baseline", "sweep_cells", "sweep_wall_clock_s",
              "sweep_wall_clock_spread_s", "sweep_mean_max_fitness"),
    "eval_sweeps": tuple(f"{label}_sweep_{key}" for label in ("efficiency", "adaptivity")
                         for key in ("seqs_per_sec", "wall_clock_s", "wall_clock_spread_s")),
    "surrogate_sweep": ("surrogate_sweep_s_per_cell", "surrogate_sweep_s_per_cell_spread",
                        "surrogate_sweep_cells", "surrogate_sweep_mean_max_fitness",
                        "surrogate_sweep_cell_mode"),
    "rna_oracle": ("rna_oracle_L100_seqs_per_sec", "rna_oracle_L100_seqs_per_sec_spread",
                   "duplex_kernel_bitexact_vs_plain"),
}
# Keys a stage line reports that the last line leaves out, as bench.py's does.
STAGE_ONLY_KEYS = ("surrogate_sweep_cell_mode",)


def med_spread(values):
    """(median, [min, max]) rounded for the JSON line.

    Rates are divided by the unrounded median: a kernel call of 0.17 ms
    would round to 0.0002 s.
    """
    return (
        round(statistics.median(values), 4),
        [round(min(values), 4), round(max(values), 4)],
    )


def card_string(device) -> str:
    """nvidia-smi's "name, power limit" of the card, or "cpu"."""
    if torch.device(device).type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def stage_line(stage: str, keys: dict, device, start: float) -> dict:
    """Print a stage's JSON line at once and return it.

    `stage_wall_s` is the stage's whole wall since `start` (a
    `time.perf_counter()` reading), warm-up included.
    """
    line = {"stage": stage, **keys, "stage_wall_s": time.perf_counter() - start,
            "card": card_string(device)}
    print(json.dumps(line), flush=True)
    return line


def timed(fn, device):
    """(fn(), seconds) by time.perf_counter, ended by a synchronize on a card."""
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def baseline():
    """BASELINE_MEASURED.json's (seqs_per_sec, hardware), or (None, None) without it."""
    if not os.path.exists(BASELINE_PATH):
        return None, None
    with open(BASELINE_PATH) as f:
        record = json.load(f)
    return record["seqs_per_sec"], record["hardware"]


def run_once(seed: int, device=None, rounds: int = 10, sequences_batch_size: int = 100,
             model_queries_per_batch: int = 2000):
    """(wall, sequences scored, top true_score) of one fused paper-config run."""
    import flexs_tpu_torch as flexs
    from flexs_tpu_torch.landscapes import tf_binding
    from flexs_tpu_torch.runtime import DeviceAdaleadNAM

    device = resolve_device(device)
    problem = tf_binding.registry()["SIX6_REF_R1"]
    landscape = tf_binding.TFBinding(**problem["params"], device=device)
    runner = DeviceAdaleadNAM(
        landscape,
        flexs.DNAA,
        rounds=rounds,
        sequences_batch_size=sequences_batch_size,
        model_queries_per_batch=model_queries_per_batch,
        starting_sequence=problem["starts"][0],
        signal_strength=0.9,
        seed=seed,
        device=device,
    )
    (df, _), wall = timed(lambda: runner.run(verbose=False), device)
    # Match the baseline's accounting: model queries + landscape queries.
    model_cost = int(df["model_cost"].iloc[-1])
    seqs_scored = model_cost + landscape.cost
    return wall, seqs_scored, float(df["true_score"].max())


def run_single(seeds=(1, 2, 3), warmup_seed=0, device=None, **run_kw):
    """The single-run stage: run_once(warmup_seed), then one timed run per seed.

    `warmup_seed=None` skips the warm-up.  Returns (keys, tops).
    """
    device = resolve_device(device)
    start = time.perf_counter()
    if warmup_seed is not None:
        run_once(warmup_seed, device, **run_kw)
    walls, tops, seqs = [], [], 0
    for seed in seeds:
        wall, seqs, top = run_once(seed, device, **run_kw)
        walls.append(wall)
        tops.append(top)
    wall, spread = med_spread(walls)
    base_sps, _ = baseline()
    sps = seqs / statistics.median(walls)
    keys = {
        "single_run_wall_clock_s": round(wall, 4),
        "single_run_wall_clock_spread_s": spread,
        "single_run_seqs_per_sec": round(sps, 1),
        "single_run_vs_baseline": round(sps / base_sps, 2) if base_sps else None,
        "top_fitness": round(max(tops), 4),
    }
    stage_line("single_run", keys, device, start)
    return keys, tops


def run_sweep(n_landscapes: int = 40, warmup_landscapes: int = 8, reps: int = 3, device=None,
              **sweep_kw):
    """Robustness sweep: n_landscapes x 5 signal strengths, chunked.

    `sweep_kw` overrides bench.py's arguments of `run_robustness_sweep`.
    Returns (keys, the last timed run's summary frame).
    """
    from flexs_tpu_torch.landscapes import tf_binding
    from flexs_tpu_torch.parallel import run_robustness_sweep

    device = resolve_device(device)
    start = time.perf_counter()
    names, _ = tf_binding._packed_tables()
    kwargs = dict(
        starts=tf_binding.STARTS[:1],
        signal_strengths=list(SIGNAL_STRENGTHS),
        rounds=10,
        sequences_batch_size=100,
        model_queries_per_batch=2000,
        chunk_size=40,
        device=device,
    )
    kwargs.update(sweep_kw)
    # Warm on the first chunk's shape: 8 landscapes x 5 strengths = 40 cells.
    run_robustness_sweep(landscape_names=names[:warmup_landscapes], **kwargs)
    walls = []
    for _ in range(reps):
        df, wall = timed(
            lambda: run_robustness_sweep(landscape_names=names[:n_landscapes], **kwargs), device)
        walls.append(wall)
    seqs = int(df["model_cost"].sum() + df["landscape_cost"].sum())
    wall, spread = med_spread(walls)
    sps = seqs / statistics.median(walls)
    base_sps, _ = baseline()
    keys = {
        "metric": "robustness_sweep_seqs_per_sec_per_chip",
        "value": round(sps, 1),
        "unit": "seqs/sec",
        "vs_baseline": round(sps / base_sps, 2) if base_sps else None,
        "sweep_cells": len(df),
        "sweep_wall_clock_s": round(wall, 1),
        "sweep_wall_clock_spread_s": spread,
        "sweep_mean_max_fitness": round(float(df["max_fitness"].mean()), 4),
    }
    stage_line("sweep", keys, device, start)
    return keys, df


def run_surrogate_sweep(n_starts: int = 5, seeds=(0, 1, 2, 3), reps: int = 3, device=None,
                        **sweep_kw):
    """Trained-surrogate sweep per-cell latency.

    Rosetta 3msi x `n_starts` starts x `seeds`, full paper-config runs
    with the paper's CNN retrained every round, in the sweep's default
    cell mode ("auto": cell by cell for a surrogate), warmed with the same
    cells.  `sweep_kw` overrides bench.py's arguments of
    `run_landscape_robustness_sweep`.  Returns (keys, the last frame).
    """
    import flexs_tpu_torch as flexs
    from flexs_tpu_torch.landscapes import rosetta
    from flexs_tpu_torch.parallel import run_landscape_robustness_sweep
    from flexs_tpu_torch.runtime import jit_runner
    from flexs_tpu_torch.runtime.surrogate import SurrogateSpec

    device = resolve_device(device)
    start = time.perf_counter()
    problem = rosetta.registry()["3msi"]
    landscape = rosetta.RosettaFolding(**problem["params"], device=device)
    kw = dict(
        starts=list(problem["starts"].values())[:n_starts],
        signal_strengths=[1.0],
        seeds=list(seeds),
        rounds=10,
        sequences_batch_size=100,
        model_queries_per_batch=2000,
        model="surrogate",
        surrogate_spec=SurrogateSpec(),
        device=device,
    )
    kw.update(sweep_kw)
    run_landscape_robustness_sweep([landscape], flexs.AAS, **kw)
    walls = []
    for _ in range(reps):
        jit_runner.reset_run_counts()
        df, wall = timed(lambda: run_landscape_robustness_sweep([landscape], flexs.AAS, **kw),
                         device)
        walls.append(wall)
    cells = len(df)
    # One runner call a cell is the map mode; one for the lot, lockstep.
    mode = "map" if jit_runner.run_counts["runs"] == cells else "vmap"
    keys = {
        "surrogate_sweep_s_per_cell": round(statistics.median(walls) / cells, 4),
        "surrogate_sweep_s_per_cell_spread": [
            round(min(walls) / cells, 4), round(max(walls) / cells, 4)
        ],
        "surrogate_sweep_cells": cells,
        "surrogate_sweep_mean_max_fitness": round(float(df["max_fitness"].mean()), 4),
        "surrogate_sweep_cell_mode": mode,
    }
    stage_line("surrogate_sweep", keys, device, start)
    return keys, df


def run_eval_sweeps(n_landscapes: int = 8, budgets=EFFICIENCY_BUDGETS, rounds: int = 10,
                    num_rounds=ADAPTIVITY_ROUNDS, reps: int = 3, device=None, **adaptivity_kw):
    """Efficiency/adaptivity evaluator throughput over the full reference grids.

    The budget pairs of reference evaluate.py:43-48 and its 1/10/100
    rounds (evaluate.py:81), on the first `n_landscapes` TF-Bind-8
    landscapes.  `adaptivity_kw` overrides `run_adaptivity_sweep`'s
    totals.  Returns (keys, {label: the last frame}).
    """
    from flexs_tpu_torch.landscapes import tf_binding
    from flexs_tpu_torch.parallel import run_adaptivity_sweep, run_efficiency_sweep

    device = resolve_device(device)
    start = time.perf_counter()
    names, _ = tf_binding._packed_tables()
    kw = dict(
        landscape_names=names[:n_landscapes],
        starts=tf_binding.STARTS[:1],
        seeds=(0,),
        device=device,
    )
    out, frames = {}, {}
    for label, fn, extra in (
        ("efficiency", run_efficiency_sweep, {"budgets": tuple(budgets), "rounds": rounds}),
        ("adaptivity", run_adaptivity_sweep, {"num_rounds": tuple(num_rounds), **adaptivity_kw}),
    ):
        fn(**kw, **extra)  # warm
        walls = []
        for _ in range(reps):
            df, wall = timed(lambda: fn(**kw, **extra), device)
            walls.append(wall)
        seqs = int(df["model_cost"].sum() + df["landscape_cost"].sum())
        med, spread = med_spread(walls)
        out[f"{label}_sweep_seqs_per_sec"] = round(seqs / statistics.median(walls), 1)
        out[f"{label}_sweep_wall_clock_s"] = med
        out[f"{label}_sweep_wall_clock_spread_s"] = spread
        frames[label] = df
    stage_line("eval_sweeps", out, device, start)
    return out, frames


def oracle_inputs(batch: int, l1: int, device):
    """bench.py's seeded draws: (tokens [batch, l1], reversed target [1, 100], check [64, l1]).

    numpy's default_rng(0), int32, in bench.py's order: the timed batch,
    the target, then the check batch.
    """
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 4, size=(batch, l1), dtype=np.int32)
    target_rev = rng.integers(0, 4, size=100, dtype=np.int32)[::-1].copy()
    check = rng.integers(0, 4, size=(64, l1), dtype=np.int32)
    return (torch.as_tensor(tokens, device=device),
            torch.as_tensor(target_rev, device=device)[None],
            torch.as_tensor(check, device=device))


def run_rna_oracle(batch: int = 512, l1: int = 100, reps: int = 20, device=None):
    """RNA duplex oracle: kernel throughput (median of 3) and bit-exactness.

    The target, the energy model and the kernel's plan live on the device
    outside the timed calls.  On a card each timed call is one launch of
    the kernel through `cuda_duplex.launcher` on that plan, timed by CUDA
    events (`amortized_seconds_per_call`); on the CPU the wrapper runs the
    plain version.  Returns (keys, the check batch's energies f32[64, 1]).
    """
    from flexs_tpu_torch.ops import cuda_duplex
    from flexs_tpu_torch.ops import rna_duplex as rd
    from flexs_tpu_torch.utils.profiling import amortized_seconds_per_call

    device = resolve_device(device)
    start = time.perf_counter()
    params = rd.DuplexParams.calibrated()
    em = params.energy_model(device)
    tokens, target_rev, check = oracle_inputs(batch, l1, device)
    plan = cuda_duplex.make_plan(target_rev, em, params.maxloop)

    # Bit-exactness gate: the kernel vs its plain version on a fresh batch.
    energies = cuda_duplex.duplex_energies(check, target_rev, em, params.maxloop, plan=plan)
    plain = cuda_duplex.duplex_energies_plain(check, target_rev, em, params.maxloop)
    bitexact = bool(torch.equal(energies, plain))

    if device.type == "cuda":
        out, launch = cuda_duplex.launcher(plan, tokens)

        def call():
            launch()
            return out
    else:
        def call():
            return cuda_duplex.duplex_energies(tokens, target_rev, em, params.maxloop, plan=plan)

    secs = [amortized_seconds_per_call(call, reps=reps) for _ in range(3)]
    keys = {
        "rna_oracle_L100_seqs_per_sec": round(batch / statistics.median(secs), 1),
        "rna_oracle_L100_seqs_per_sec_spread": [round(batch / s, 1)
                                                for s in (max(secs), min(secs))],
        "duplex_kernel_bitexact_vs_plain": bitexact,
    }
    stage_line("rna_oracle", keys, device, start)
    return keys, energies


def final_line(stages: dict, device) -> dict:
    """bench.py's last line from the stages' keys, plus card and baseline_hardware."""
    sweep = stages["sweep"]
    _, hardware = baseline()
    line = {key: sweep[key] for key in ("metric", "value", "unit", "vs_baseline")}
    line["baseline_hardware"] = hardware
    line.update({key: sweep[key] for key in STAGE_KEYS["sweep"] if key.startswith("sweep_")})
    line.update(stages["single_run"])
    line.update(stages["rna_oracle"])
    line.update(stages["eval_sweeps"])
    line.update({k: v for k, v in stages["surrogate_sweep"].items()
                 if k not in STAGE_ONLY_KEYS})
    line["card"] = card_string(device)
    return line


def run_all(device=None, sizes=None):
    """Every stage in bench.py's order: (the last line, {stage: what it computed}).

    `sizes` maps a stage's name to keyword arguments of its function.
    """
    device = resolve_device(device)
    sizes = sizes or {}
    stages, data = {}, {}
    for name, fn in (
        ("single_run", run_single),
        ("sweep", run_sweep),
        ("eval_sweeps", run_eval_sweeps),
        ("surrogate_sweep", run_surrogate_sweep),
        ("rna_oracle", run_rna_oracle),
    ):
        stages[name], data[name] = fn(device=device, **sizes.get(name, {}))
    return final_line(stages, device), data


def main() -> int:
    line, _ = run_all()
    print(json.dumps(line), flush=True)
    return 0 if line["duplex_kernel_bitexact_vs_plain"] else 1


if __name__ == "__main__":
    sys.exit(main())
