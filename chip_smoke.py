#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failed check raises, and the script exits nonzero):
  1. build, from this checkout, the main path's CUDA duplex kernel
     (flexs_tpu_torch/csrc/duplex_dp.cu) and the four row-cost builds of
     the first kernel (csrc/duplex_rowcost.cu): five nvcc runs, all started
     together in threads;
  2. hold the kernel against its plain PyTorch version on the card, on
     numpy-seeded inputs at the main path's shapes (B = 100, 512, 4096),
     maxloop 7 and a few edge cases, requiring bitwise
     equality; time the kernel on a per-landscape plan at B = 100, 512 and
     4096, its wrapper at B = 100 and 512 and the plain version, with CUDA
     events, and print the card's SM clock and power draw;
  3. run the fused main path: DeviceAdaleadNAM on RNABinding L100_RNA1
     (10 rounds x 100 proposals x 2000 model queries, NAM at signal
     strength 0.9), check the run's invariants, 439 launches of the main
     path's kernel and top true_score 0.667402;
  4. run the host path: Adalead + NoisyAbstractModel on the same landscape
     for 3 rounds: 112 launches, top true_score 0.619458;
  5. TF-Bind-8, whose oracle is a table gather and launches no kernel of
     this port (each of a-e requires 0 launches of every duplex build):
     a. the oracle on the card equals the CPU's bitwise, on 4,096 seeded
        tokens for each of the 200 landscapes and on all 65,536 8-mers of
        SIX6_REF_R1;
     b. the fused run: DeviceAdaleadNAM on SIX6_REF_R1, 10 x 100 x 2000,
        NAM at 0.9, seed 0, STARTS[0]: run invariants, top true_score
        > 0.95; printed twice (cold, warm) with queries/s;
     c. the host run: Adalead + NoisyAbstractModel, 3 rounds;
     d. the robustness sweep at bench.py's chunk shape: 16 of its 40
        landscapes x 5 signal strengths, 10 x 100 x 2000, two chunks of 40
        cells: every cell's max >= its start and model cost > 0; the first
        and last cells equal a standalone DeviceAdaleadNAM exactly; warm
        wall, sequences scored/s, peak memory, host syncs and draw calls
        per chunk;
     e. the efficiency and adaptivity sweeps at bench.py's grid on 4
        landscapes: wall, peak memory and chunk size of each;
  6. the trained-surrogate path and the generic landscape sweep (a-d
     launch no duplex build; e launches the main path's kernel):
     a. the Rosetta 3msi oracle on 4,096 seeded tokens and the 6 AAV
        phenotypes' oracles on the card against the CPU, max |diff| <= 1e-5;
     b. the fused run: DeviceAdaleadNAM on RosettaFolding 3msi (10 x 100 x
        2000, start ed_3_wt, seed 0) with model="surrogate" and the default
        SurrogateSpec (the paper's CNN, retrained every round): cold and
        warm wall, queries/s, top true_score, the warm wall split between
        surrogate.train and the rest by CUDA events, and, from a third run
        under torch.profiler, the kernel launches and device time per run;
        every run's frame must be identical, the landscape charged exactly
        the measurements, model cost > 0;
     c. the host run: Adalead + CNN(66, 32, 100), 3 rounds: wall and top;
     d. bench.py:98-144's surrogate sweep, cut to 3msi x 5 starts x seed
        0, cell_mode "auto" (5 cells): wall, s per cell, mean
        max_fitness >= 0.85 (printed beside the reference's 0.905 and the
        JAX package's 0.9444, quality readings); the first and last cells
        equal standalone runs;
     e. a generic NAM sweep, L100_RNA1..2 x starts 1-5 x ss 0.9 x seed 0
        (10 cells, "vmap"): the duplex kernel must launch, no row-cost
        build may, and the first and last cells equal standalone runs;
  7. row-cost knockouts: the path of `python -m
     flexs_tpu_torch.profile_duplex_rowcost`.  `profile_duplex_rowcost.
     measure` runs every build on the profiler's seeded inputs at B=4096
     and B=100, requires baseline and unrolled (and the redesigned kernel,
     timed beside them) to equal the plain version bitwise and const-rec
     and carry-windows (wrong by design) to give finite f32[B], and times
     each;
  8. the fold (RNAFolding; no kernel of this port, no duplex build may
     launch):
     a. `zuker_mfe_batch` on the card against the CPU on seeded rows (B=64
        at L = 14, 50, 100) and the structured rows of
        tests/test_rna_fold.py: bitwise expected, max |diff| <= 1e-5
        required;
     b. the readings of `python -m flexs_tpu_torch.profile_fold`;
     c. the fused run: DeviceAdaleadNAM on RNAFolding from L100_RNA1's start
        1 (L=100), NAM 0.9, seed 0, 10 x 100 x 2000, then again under
        torch.profiler (CUDA activity only): identical frames, run
        invariants, true_score == get_fitness exactly; wall, queries/s,
        launches, device time, top true_score;
     d. the host run: Adalead + NoisyAbstractModel, 3 rounds;
     e. a generic sweep over starts 1-5 at ss 0.9 in lockstep, cut to 2
        rounds: cells 1 and 5 equal standalone runs;
  9. GFP at full width (12 layers, hidden 768, 12 heads, 256 tokens; the
     seeded-init oracle, as no checkpoint is in the checkout; 100 rows a
     forward pass), TF32 off for the whole phase, no duplex build may
     launch:
     a. the oracle on the card against the CPU on the wild type and the
        three starts, rtol and atol 1e-4;
     b. the fused run from ed_10_wt, NAM 0.9, 10 x 100 x 2000, under
        torch.profiler (CUDA activity only): wall, queries/s, peak memory,
        device idle share and the oracle's share of the wall (CUDA events);
     c. the host run, 3 rounds, on a landscape scoring 32 rows a pass;
     d. a generic sweep over the 3 starts, cut to 1 round, one cell after
        another ("map");
  10. the rest of the models and the exact-GP surrogate on RNABinding
     L100_RNA1 (b-d launch the main path's kernel through the oracle, and
     no row-cost build may launch):
     a. each of the eight regressors (ridge, Lasso, Bayesian ridge, GP,
        k-NN, forest, boosting, extra tree) on the card against the CPU, on
        301 numpy-seeded rows at L = 100 and 2,000 queries: k-NN and trees
        carried across bitwise, linear models and a carried GP within 1e-4,
        GPs fitted on each device within 2e-3, fitted trees by correlation;
     b. the fused run: DeviceAdaleadNAM with model="surrogate" and
        SurrogateSpec(arch="gp") (150 LML steps per round on the 1002-row
        buffer), 10 x 100 x 2000 from start 1, seed 0, three times (cold;
        warm with surrogate.train timed by CUDA events; under
        torch.profiler, CUDA activity only): identical frames, run
        invariants, true_score == get_fitness, 11 duplex launches and top
        true_score 0.717676;
     c. the host run: Adalead over an AdaptiveEnsemble of the port's 11
        DynaPPO default members, 3 rounds: wall, top, the ensemble's
        weights and each member's train seconds in the last round;
     d. the GP sweep over starts 1-3 ("map"): wall, s per cell, mean max
        fitness (a reading); its first cell equals the fused run of b and
        its last a standalone run; a 2-cell "vmap" chunk equals the map
        sweep's cells;
  11. print the wall of each phase, one JSON line describing each kernel,
     the card's name and power limit, and last the device JSON line.

Each path's phase sets the launch counters of every build to 0 just before
it and reads them just after; a phase in which one of its kernels never
launched fails, and so does a main-path run that launched a row-cost
build.  The script needs one CUDA card and imports nothing of JAX.
"""
import contextlib
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

SEED = 0
# Published peaks of one H100 SXM (NVIDIA data sheet): device memory rate
# and float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# The main path's seeded runs: kernel launches and top true_score, as the
# first kernel gave them; bitwise-equal energies must reproduce them.
FUSED_LAUNCHES, FUSED_TOP = 439, 0.667402
HOST_LAUNCHES, HOST_TOP = 112, 0.619458
# TF-Bind-8 (phase 5): the sweep at bench.py:72-95's chunk shape, cut from
# its 40 landscapes to 16 (two chunks of 40 cells, not five), and the
# evaluator grids of bench.py:147-182 on 4 of their landscapes, to keep the
# script near 700 s (PERF.md, Cells).  Chunks of 40 and of 8 evaluator
# cells peak under 10 GB of device memory (PERF.md).
SWEEP_LANDSCAPES, SWEEP_CHUNK = 16, 40
SWEEP_SIGNAL_STRENGTHS = (0.0, 0.5, 0.75, 0.9, 1.0)
EVAL_LANDSCAPES, EVAL_CHUNK = 4, 8
EFFICIENCY_BUDGETS = ((100, 500), (100, 5000), (1000, 5000), (1000, 10000))
# Phase 6: the card's oracles against the CPU's, and the surrogate sweep's
# quality floor, beside the reference's mean max fitness over its
# rosetta_cnn runs (BASELINE.md:27) and the JAX package's over the same
# sweep (BENCH_r04.json:50).  Quality readings, not times.
ORACLE_TOLERANCE = 1e-5
SURROGATE_SWEEP_FLOOR = 0.85
REFERENCE_MEAN_MAX, JAX_PACKAGE_MEAN_MAX = 0.905, 0.9444
# Phase 6's per-cell configuration (bench.py:98-144's) and its host run's rounds.
PHASE6_RUN = dict(rounds=10, sequences_batch_size=100, model_queries_per_batch=2000)
PHASE6_HOST_ROUNDS = 3
# Phase 6's sweeps, cut in depth to keep the script near 700 s with phases 8
# and 9 (PERF.md, Cells): the surrogate sweep to bench.py's 5 starts x 1 of
# its 4 seeds, the RNABinding generic sweep to 2 of its 4 landscapes.
SURROGATE_SWEEP_SEEDS = (0,)
RNA_SWEEP_LANDSCAPES = ("L100_RNA1", "L100_RNA2")
# Phase 8: the fold on the card against the CPU (bitwise expected: gathers,
# mins and f32 adds in one order), on seeded rows and on the structured rows
# of tests/test_rna_fold.py; and the fused RNAFolding run's top true_score.
FOLD_TOLERANCE = 1e-5
FOLD_STRUCTURED = (
    "GGGGGGAAAACCCCCC", "GGGGGG" + "A" * 8 + "CCCCCC", "GGGGGG" + "A" * 16 + "CCCCCC",
    "GGGGGG" + "A" * 30 + "CCCCCC", "GGGGGAAAACCCCC", "GGGAGGAAAACCCCC",
    "CCCCAAAAGGGGAAGGGGAAAACCCC", "GGGGGACCCCAAAAGGGGAAGGGGAAAACCCCACCCCC",
    "GGGGAAAACCCCAAGGGGAAAACCCC", "GGGGGAGGGGAAAACCCCAAGGGGAAAACCCCACCCCC",
    "GGGAAAACCC", "GGGGGAAAACCCCC", "GGGGGGGAAAACCCCCCC", "A" * 20, "GCAAGC",
    "GGGAAACCC", "GGGAACCC", "GGGCUUCGGCCC", "GGGCAUCGGCCC", "GGGGCAACGCCCC",
    "AGGGGGAAAACCCCCA",
)
FOLD_TOP = 95.396645
# The fold sweep's rounds: a 10-round lockstep sweep of the launch-bound fold
# took 85 s on an H100 (PERF.md), so its depth is cut; cells are held to
# standalone runs of the same depth.
FOLD_SWEEP_ROUNDS = 2
# Phase 9: GFP at full width; card vs CPU, and the depth of its host run and sweep.
GFP_TOLERANCE = 1e-4  # rtol and atol
GFP_WIDTH = dict(layers=12, hidden=768)  # TAPE's bert-base; 12 heads, 256 tokens
# Rows per GFP forward pass: the runner's proposal batch, so that no chunk of
# a 100-row oracle call is padded.  The host run keeps the reference's 32:
# its model queries come in small batches, each padded to a whole chunk.
GFP_BATCH = 100
GFP_HOST_ROUNDS, GFP_SWEEP_ROUNDS = 3, 1
# Phase 10: the rest of the models and the exact-GP surrogate on RNABinding
# L100_RNA1.  (a) Each regressor on the card against the CPU, on numpy-seeded
# training rows at the landscape's width (labels from its oracle) and as many
# queries again, half random, half mutants of training rows: k-NN and trees
# carried across bitwise, the linear models and a GP carried across within
# 1e-4.  A GP fitted on each device picks its best point among f32 values
# flat to their last bits, so the two fits are held to the JAX package's
# band between its own two GP paths (tests/test_surrogate_runner.py:143-148);
# fitted trees differ where split gains tie to the last bit, so they are
# held by agreement (the extra tree to tests/test_jax_trees.py's band).
MODELS_ROWS, MODELS_QUERIES = 301, 2000
MODELS_TOLERANCE = 1e-4
GP_FIT_TOLERANCE = 2e-3
TREES_MIN_CORR = {"random_forest": 0.99, "gradient_boosting": 0.99, "extra_trees": 0.9}
# The fused GP run's duplex launches (the start and the 10 rounds'
# measurements) and top true_score, as its first run on an H100 gave them.
GP_FUSED_LAUNCHES, GP_FUSED_TOP = 11, 0.717676
GP_SWEEP_STARTS = (1, 2, 3)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def dp_operations(b: int, n_t: int, l1: int, l2: int, maxloop: int) -> int:
    """f32 adds and mins the duplex DP does over B x T x L1 x L2 cells."""
    interior = sum(
        1 for r in range(1, maxloop + 1) for dj in range(2, maxloop + 2)
        if r + dj - 1 <= maxloop and not (r == 1 and dj == 2)
    )
    bulges = (maxloop - 1) + (maxloop - 1)
    per_cell = (
        2 * 4  # open vs stack, two 1-bulges, 1x1 interior: add + min each
        + 2 * interior + 2  # interior candidates, then + mB and min
        + 2 * bulges + 2  # bulge candidates, then + AU and min
        + 1  # unpairable mask
        + 2  # + CLOSE and running best
        + 2  # the two pushed window channels
    )
    return b * n_t * l1 * l2 * per_cell


def timed_build(cuda_duplex, variant):
    """(seconds, library path, compiler log) of one variant's build."""
    t0 = time.perf_counter()
    path, log = cuda_duplex.build(variant)
    return time.perf_counter() - t0, path, log


def print_build(variant, seconds, path, log):
    print(f"build {variant}: {seconds} s -> {path}")
    for line in log.splitlines():
        if "ptxas" in line:
            print(f"build {variant}: {line.strip()}")


def bound_entry(n_bytes: int, dims) -> dict:
    """The least time the card could take for one DP launch of `dims`.

    The larger of moving `n_bytes` once at the memory rate and doing the
    DP's operations at the f32 rate.
    """
    ops = dp_operations(*dims)
    bound = {"bytes": n_bytes / HBM_BYTES_PER_S * 1e3, "operations": ops / FP32_OPS_PER_S * 1e3}
    bound_by = max(bound, key=bound.get)
    return {"bound_ms": bound[bound_by], "bound_by": bound_by, "n_bytes": n_bytes,
            "operations": ops}


def main_path_counts(cuda_duplex, path: str, expected: int) -> dict:
    """Launch counts of a main path's run: `expected` of the main kernel, no row-cost build."""
    counts = cuda_duplex.launch_counts()
    assert counts[cuda_duplex.MAIN] == expected, (
        f"the {path} run launched the duplex kernel {counts[cuda_duplex.MAIN]} times, "
        f"expected {expected}")
    stray = {v: n for v, n in counts.items() if v != cuda_duplex.MAIN and n}
    assert not stray, f"the {path} run launched row-cost builds: {stray}"
    return counts


def kernel_vs_plain(cuda_duplex, tokens, targets_rev, em, maxloop):
    """(kernel out, plain out, max |diff|) on CUDA tensors; requires equality.

    The kernel is reached through `duplex_energies`, the wrapper the main
    path calls, which must launch it exactly once.
    """
    before = cuda_duplex.launches
    kern = cuda_duplex.duplex_energies(tokens, targets_rev, em, maxloop)
    if cuda_duplex.launches != before + 1:
        raise AssertionError("duplex_energies did not launch the kernel once")
    plain = cuda_duplex.duplex_energies_plain(tokens, targets_rev, em, maxloop)
    torch.cuda.synchronize()
    return kern, plain, check_equal(kern, plain, f"B={tokens.shape[0]} L1={tokens.shape[1]} "
                                                 f"T={targets_rev.shape[0]} maxloop={maxloop}")


def check_equal(kern, plain, case: str) -> float:
    """max |kern - plain|; raises unless the two are equal, finite and of one shape."""
    if kern.shape != plain.shape or not torch.isfinite(kern).all():
        raise AssertionError(f"kernel output {tuple(kern.shape)} is not finite/shaped ({case})")
    diff = float((kern - plain).abs().max())
    if not torch.equal(kern, plain):
        raise AssertionError(f"kernel != plain at {case}: max |diff| {diff}")
    return diff


def check_run_frame(df, rounds: int, batch: int, budget: int, start: str, per_round: int):
    """The invariants of a run's measured-data frame."""
    cols = ["sequence", "model_score", "true_score", "round", "model_cost",
            "measurement_cost"]
    assert list(df.columns) == cols, list(df.columns)
    assert df["round"].max() == rounds
    r0 = df[df["round"] == 0]
    assert len(r0) == 1 and r0["sequence"].iloc[0] == start
    assert np.isnan(r0["model_score"].iloc[0])
    for r in range(1, rounds + 1):
        assert 0 < len(df[df["round"] == r]) <= per_round, r
    assert df["sequence"].is_unique, "a sequence was measured twice"
    costs = df.groupby("round")["model_cost"].first()
    assert costs.is_monotonic_increasing
    assert (np.diff(costs.to_numpy()) <= budget + batch).all()
    assert np.isfinite(df["true_score"]).all()


def path_launches(cuda_duplex, path: str) -> int:
    """Launches of the main kernel since the last reset: at least one, and no row-cost build."""
    counts = cuda_duplex.launch_counts()
    assert counts[cuda_duplex.MAIN] > 0, f"the {path} run never launched the duplex kernel"
    stray = {v: n for v, n in counts.items() if v != cuda_duplex.MAIN and n}
    assert not stray, f"the {path} run launched row-cost builds: {stray}"
    return counts[cuda_duplex.MAIN]


def no_duplex_launches(cuda_duplex, phase: str) -> None:
    counts = cuda_duplex.launch_counts()
    assert not any(counts.values()), f"phase {phase} launched duplex builds: {counts}"


def timed(fn):
    """(result, seconds) of `fn()`, ended by a device synchronize."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def tf_binding_phases(flexs, cuda_duplex, card: str) -> dict:
    """Phase 5 (a-e): TF-Bind-8's oracle, fused and host runs, and sweeps."""
    from flexs_tpu_torch.landscapes import tf_binding
    from flexs_tpu_torch.parallel import (
        run_adaptivity_sweep, run_efficiency_sweep, run_robustness_sweep,
    )
    from flexs_tpu_torch.runtime import jit_runner

    names = list(tf_binding.registry())
    start = tf_binding.STARTS[0]
    rng = np.random.default_rng(SEED)
    cuda_duplex.reset_launch_counts()

    # a. The oracle, card vs CPU.
    tokens = rng.integers(0, 4, (4096, 8))
    for name in names:
        on_card = tf_binding.TFBinding(name=name).fitness_from_tokens(tokens).cpu()
        on_cpu = tf_binding.TFBinding(name=name, device="cpu").fitness_from_tokens(tokens)
        assert torch.equal(on_card, on_cpu), name
    every = (np.arange(4 ** 8)[:, None] >> (2 * np.arange(7, -1, -1))) & 3
    six6 = tf_binding.TFBinding(name="SIX6_REF_R1")
    on_card = six6.fitness_from_tokens(every).cpu()
    on_cpu = tf_binding.TFBinding(name="SIX6_REF_R1", device="cpu").fitness_from_tokens(every)
    assert torch.equal(on_card, on_cpu) and torch.equal(on_card, six6.table.cpu())
    no_duplex_launches(cuda_duplex, "a")
    print(f"tf-bind oracle: card == CPU (bitwise) on 4096 seeded tokens x {len(names)} "
          f"landscapes and all 65536 8-mers of SIX6_REF_R1 [{card}]")

    # b. The fused run, cold then warm.
    def fused():
        land = tf_binding.TFBinding(name="SIX6_REF_R1")
        runner = flexs.runtime.DeviceAdaleadNAM(
            land, flexs.DNAA, rounds=10, sequences_batch_size=100,
            model_queries_per_batch=2000, starting_sequence=start, signal_strength=0.9,
            seed=0,
        )
        (df, _), wall = timed(lambda: runner.run(verbose=False))
        return df, wall, int(df["model_cost"].max()) + land.cost

    fused_walls = []
    for _ in range(2):
        df, wall, queries = fused()
        fused_walls.append(wall)
    check_run_frame(df, 10, 100, 2000, start, per_round=100)
    truth = six6.get_fitness(df["sequence"].tolist())
    assert np.array_equal(df["true_score"].to_numpy(), truth)
    fused_top = float(df["true_score"].max())
    assert fused_top > 0.95, fused_top
    no_duplex_launches(cuda_duplex, "b")
    print(f"tf-bind fused: wall {fused_walls[0]} s cold, {fused_walls[1]} s warm, "
          f"{queries / fused_walls[1]} queries/s warm (model + landscape), top true_score "
          f"{fused_top}, rows {len(df)}, duplex launches 0 [{card}]")

    # c. The host run.
    host_land = tf_binding.TFBinding(name="SIX6_REF_R1")
    explorer = flexs.baselines.explorers.Adalead(
        flexs.baselines.models.NoisyAbstractModel(host_land, 0.9, seed=0),
        rounds=3, sequences_batch_size=100, model_queries_per_batch=2000,
        starting_sequence=start, alphabet=flexs.DNAA, seed=0,
    )
    (df_host, _), host_wall = timed(lambda: explorer.run(host_land, verbose=False))
    check_run_frame(df_host, 3, 100, 2000, start, per_round=99)
    assert np.array_equal(df_host["true_score"].to_numpy(),
                          host_land.get_fitness(df_host["sequence"].tolist()))
    host_top = float(df_host["true_score"].max())
    no_duplex_launches(cuda_duplex, "c")
    print(f"tf-bind host: wall {host_wall} s, top true_score {host_top}, rows {len(df_host)} "
          f"[{card}]")

    # d. The robustness sweep, warmed by one round of its first chunk.
    grid = dict(landscape_names=names[:SWEEP_LANDSCAPES], starts=[start],
                signal_strengths=SWEEP_SIGNAL_STRENGTHS, seeds=[0],
                sequences_batch_size=100, model_queries_per_batch=2000)
    run_robustness_sweep(**{**grid, "landscape_names": names[:SWEEP_CHUNK // 5]}, rounds=1)
    torch.cuda.reset_peak_memory_stats()
    jit_runner.reset_run_counts()
    sweep, sweep_wall = timed(lambda: run_robustness_sweep(
        **grid, rounds=10, chunk_size=SWEEP_CHUNK))
    counts = dict(jit_runner.run_counts)
    sweep_peak = torch.cuda.max_memory_allocated()
    assert len(sweep) == SWEEP_LANDSCAPES * len(SWEEP_SIGNAL_STRENGTHS)
    assert (sweep["max_fitness"] >= sweep["start_fitness"]).all()
    assert (sweep["model_cost"] > 0).all()
    singles = []
    for row in (sweep.iloc[0], sweep.iloc[-1]):
        land = tf_binding.TFBinding(name=row["landscape"])
        runner = flexs.runtime.DeviceAdaleadNAM(
            land, flexs.DNAA, rounds=10, sequences_batch_size=100,
            model_queries_per_batch=2000, starting_sequence=row["start"],
            signal_strength=row["signal_strength"], seed=int(row["seed"]),
        )
        jit_runner.reset_run_counts()
        (single, _), wall = timed(lambda: runner.run(verbose=False))
        assert row["max_fitness"] == single["true_score"].max(), row
        assert row["model_cost"] == single["model_cost"].iloc[-1], row
        assert row["landscape_cost"] == land.cost, row
        singles.append({"wall_s": wall, "signal_strength": float(row["signal_strength"]),
                        "syncs": jit_runner.run_counts["syncs"],
                        "draw_calls": jit_runner.run_counts["draw_calls"]})
    no_duplex_launches(cuda_duplex, "d")
    chunks = counts["runs"]
    scored = int(sweep["model_cost"].sum() + sweep["landscape_cost"].sum())
    sweep_reading = {
        "cells": len(sweep), "chunk_size": SWEEP_CHUNK, "chunks": chunks,
        "wall_s": sweep_wall, "chunk_wall_s": sweep_wall / chunks,
        "sequences_scored_per_s": scored / sweep_wall,
        "mean_max_fitness": float(sweep["max_fitness"].mean()),
        "peak_memory_bytes": sweep_peak,
        "syncs_per_chunk": counts["syncs"] / chunks,
        "draw_calls_per_chunk": counts["draw_calls"] / chunks,
        "first_and_last_cell_alone": singles,
        "chunk_wall_over_fused_warm_wall": sweep_wall / chunks / fused_walls[1],
    }
    print(f"tf-bind robustness sweep: {sweep_reading['cells']} cells in {chunks} chunks of "
          f"{SWEEP_CHUNK}: warm wall {sweep_wall} s ({sweep_reading['chunk_wall_s']} s per "
          f"chunk, {sweep_reading['chunk_wall_over_fused_warm_wall']} x the warm fused run), "
          f"{sweep_reading['sequences_scored_per_s']} sequences scored/s (model + landscape "
          f"cost over wall), mean max_fitness {sweep_reading['mean_max_fitness']}, peak memory "
          f"{sweep_peak} bytes, per chunk {sweep_reading['syncs_per_chunk']} host syncs and "
          f"{sweep_reading['draw_calls_per_chunk']} draw calls; first and last cells alone "
          f"{singles}; both equal to the standalone runner [{card}]")

    # e. The evaluator sweeps at bench.py's grid.
    evals = {}
    for label, fn, kw in (
        ("efficiency", run_efficiency_sweep,
         dict(budgets=EFFICIENCY_BUDGETS, chunk_size=EVAL_CHUNK)),
        ("adaptivity", run_adaptivity_sweep,
         dict(num_rounds=(1, 10, 100), chunk_size=EVAL_CHUNK)),
    ):
        torch.cuda.reset_peak_memory_stats()
        df_eval, wall = timed(lambda: fn(names[:EVAL_LANDSCAPES], [start], **kw))
        assert (df_eval["max_fitness"] >= df_eval["start_fitness"]).all()
        assert (df_eval["model_cost"] > 0).all()
        evals[label] = {"cells": len(df_eval), "chunk_size": kw["chunk_size"], "wall_s": wall,
                        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                        "mean_max_fitness": float(df_eval["max_fitness"].mean())}
        print(f"tf-bind {label} sweep: {evals[label]} [{card}]")
    no_duplex_launches(cuda_duplex, "e")
    return {"fused_walls_s": fused_walls, "fused_top": fused_top, "host_wall_s": host_wall,
            "host_top": host_top, "robustness_sweep": sweep_reading, **evals}


@contextlib.contextmanager
def call_events(module, name: str):
    """CUDA events around every call of `module.<name>` while inside: [(start, end)]."""
    events = []
    original = getattr(module, name)

    def timed_call(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = original(*args, **kwargs)
        end.record()
        events.append((start, end))
        return out

    setattr(module, name, timed_call)
    try:
        yield events
    finally:
        setattr(module, name, original)


def step_walls(steps) -> dict:
    """Seconds between consecutive (name, perf_counter) stamps, by the earlier name."""
    return {name: b - a for (name, a), (_, b) in zip(steps, steps[1:])}


def events_s(events) -> float:
    """Seconds between each (start, end) pair of CUDA events, summed."""
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / 1e3


def same_as_standalone(flexs, row, land, alphabet, runner_kw):
    """Hold a sweep summary row to the standalone fused run of its cell, exactly."""
    cost = land.cost
    single, _ = flexs.runtime.DeviceAdaleadNAM(
        land, alphabet, starting_sequence=row["start"], seed=int(row["seed"]), **runner_kw,
    ).run(verbose=False)
    assert row["max_fitness"] == single["true_score"].max(), row
    assert row["model_cost"] == single["model_cost"].iloc[-1], row
    assert row["landscape_cost"] == land.cost - cost, row


def surrogate_phases(flexs, cuda_duplex, card: str) -> dict:
    """Phase 6 (a-e): the trained-surrogate path on Rosetta 3msi and the generic sweep."""
    import pandas as pd
    from torch.profiler import ProfilerActivity, profile

    from flexs_tpu_torch.landscapes import additive_aav_packaging as aav
    from flexs_tpu_torch.landscapes import rna, rosetta
    from flexs_tpu_torch.parallel import run_landscape_robustness_sweep
    from flexs_tpu_torch.profile_main_path import device_kernels
    from flexs_tpu_torch.runtime import SurrogateSpec, jit_runner, surrogate

    rng = np.random.default_rng(SEED)
    problem = rosetta.registry()["3msi"]
    start = problem["starts"]["ed_3_wt"]
    cuda_duplex.reset_launch_counts()
    steps = [("a oracles", time.perf_counter())]

    # a. The oracles, card vs CPU.
    land = rosetta.RosettaFolding(**problem["params"])
    tokens = rng.integers(0, 20, (4096, 66))
    oracle_diff = {"rosetta_3msi": float((
        land.fitness_from_tokens(tokens).cpu()
        - rosetta.RosettaFolding(**problem["params"], device="cpu").fitness_from_tokens(tokens)
    ).abs().max())}
    tokens = rng.integers(0, 20, (4096, 90))
    for phenotype, p in aav.registry().items():
        oracle_diff[f"aav_{phenotype}"] = float((
            aav.AdditiveAAVPackaging(**p["params"]).fitness_from_tokens(tokens).cpu()
            - aav.AdditiveAAVPackaging(**p["params"], device="cpu").fitness_from_tokens(tokens)
        ).abs().max())
    assert max(oracle_diff.values()) <= ORACLE_TOLERANCE, oracle_diff
    no_duplex_launches(cuda_duplex, "6a")
    print(f"rosetta/aav oracles: card vs CPU max |diff| {oracle_diff} [{card}]")

    # b. The fused surrogate run: cold, warm (train split by CUDA events),
    # then profiled for launches and device time.
    steps.append(("b cold", time.perf_counter()))
    runner_kw = dict(**PHASE6_RUN, model="surrogate", surrogate_spec=SurrogateSpec())
    rounds, batch, budget = (
        PHASE6_RUN[k] for k in ("rounds", "sequences_batch_size", "model_queries_per_batch"))

    def fused():
        cost = land.cost
        runner = flexs.runtime.DeviceAdaleadNAM(land, flexs.AAS, starting_sequence=start, seed=0,
                                                **runner_kw)
        (df, meta), wall = timed(lambda: runner.run(verbose=False))
        assert meta["model_name"] == "CNN_hidden_size_100_num_filters_32"
        return df, wall, land.cost - cost

    df_cold, cold_wall, _ = fused()
    steps.append(("b warm", time.perf_counter()))
    with call_events(surrogate, "train") as events:
        df, warm_wall, landscape_cost = fused()
    train_s = events_s(events)
    steps.append(("b profiled run and trace", time.perf_counter()))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        df_profiled, profiled_wall, _ = fused()
    steps.append(("b device totals", time.perf_counter()))
    kernels = device_kernels(prof)
    steps.append(("b checks", time.perf_counter()))
    device_s = sum(e.self_device_time_total for e in kernels) / 1e6
    pd.testing.assert_frame_equal(df_cold, df)
    pd.testing.assert_frame_equal(df, df_profiled)
    check_run_frame(df, rounds, batch, budget, start, per_round=batch)
    assert df["measurement_cost"].max() == len(df) == landscape_cost
    assert (df[df["round"] > 0]["model_cost"] > 0).all()
    truth_diff = float(np.abs(df["true_score"].to_numpy()
                              - land.get_fitness(df["sequence"].tolist())).max())
    assert truth_diff <= 1e-6, truth_diff
    no_duplex_launches(cuda_duplex, "6b")
    queries = int(df["model_cost"].max()) + landscape_cost
    fused_reading = {
        "cold_wall_s": cold_wall, "warm_wall_s": warm_wall,
        "queries_per_s": queries / warm_wall, "top": float(df["true_score"].max()),
        "train_s": train_s, "train_calls": len(events), "rest_s": warm_wall - train_s,
        "profiled_wall_s": profiled_wall, "kernel_launches": sum(e.count for e in kernels),
        "device_kernel_s": device_s,
        "device_idle_share_vs_warm_wall": 1 - device_s / warm_wall if device_s else None,
        "top_kernels": [{"name": e.key[:80], "count": e.count,
                         "device_s": e.self_device_time_total / 1e6} for e in kernels[:8]],
    }
    print(f"rosetta surrogate fused run: {json.dumps(fused_reading)}; the three runs' frames "
          f"are identical [{card}]")

    steps.append(("c host", time.perf_counter()))
    # c. The host run: Adalead asking a CNN that is retrained every round.
    host_land = rosetta.RosettaFolding(**problem["params"])
    explorer = flexs.baselines.explorers.Adalead(
        flexs.baselines.models.CNN(66, 32, 100, flexs.AAS),
        rounds=PHASE6_HOST_ROUNDS, sequences_batch_size=batch, model_queries_per_batch=budget,
        starting_sequence=start, alphabet=flexs.AAS, seed=0,
    )
    (df_host, _), host_wall = timed(lambda: explorer.run(host_land, verbose=False))
    check_run_frame(df_host, PHASE6_HOST_ROUNDS, batch, budget, start, per_round=batch - 1)
    host_top = float(df_host["true_score"].max())
    no_duplex_launches(cuda_duplex, "6c")
    print(f"rosetta host run (Adalead + CNN): wall {host_wall} s, top true_score {host_top}, "
          f"rows {len(df_host)} [{card}]")

    steps.append(("d surrogate sweep", time.perf_counter()))
    # d. bench.py's surrogate sweep (5 starts, SURROGATE_SWEEP_SEEDS), cell_mode "auto".
    sweep_kw = dict(signal_strengths=[1.0], **runner_kw, cell_mode="auto")
    starts = list(problem["starts"].values())
    sweep, sweep_wall = timed(lambda: run_landscape_robustness_sweep(
        [land], flexs.AAS, starts, seeds=list(SURROGATE_SWEEP_SEEDS), **sweep_kw))
    assert len(sweep) == len(starts) * len(SURROGATE_SWEEP_SEEDS)
    assert (sweep["model_cost"] > 0).all()
    mean_max = float(sweep["max_fitness"].mean())
    assert mean_max >= SURROGATE_SWEEP_FLOOR, mean_max
    for i in (0, len(sweep) - 1):
        same_as_standalone(flexs, sweep.iloc[i], land, flexs.AAS, runner_kw)
    no_duplex_launches(cuda_duplex, "6d")
    sweep_reading = {"cells": len(sweep), "wall_s": sweep_wall,
                     "s_per_cell": sweep_wall / len(sweep), "mean_max_fitness": mean_max,
                     "reference_mean_max_fitness": REFERENCE_MEAN_MAX,
                     "jax_package_mean_max_fitness": JAX_PACKAGE_MEAN_MAX}
    print(f"rosetta surrogate sweep: {json.dumps(sweep_reading)}; the first and last cells "
          f"equal their standalone runs [{card}]")

    steps.append(("e rna sweep", time.perf_counter()))
    # e. A generic NAM sweep over RNABinding landscapes, in lockstep.
    reg = rna.registry()
    lands = [rna.RNABinding(**reg[name]["params"]) for name in RNA_SWEEP_LANDSCAPES]
    rna_starts = [reg["L100_RNA1"]["starts"][k] for k in (1, 2, 3, 4, 5)]
    cuda_duplex.reset_launch_counts()
    jit_runner.reset_run_counts()
    torch.cuda.reset_peak_memory_stats()
    rna_sweep, rna_wall = timed(lambda: run_landscape_robustness_sweep(
        lands, flexs.RNAA, rna_starts, [0.9], seeds=[0], **PHASE6_RUN, cell_mode="vmap"))
    rna_counts = cuda_duplex.launch_counts()
    syncs = jit_runner.run_counts["syncs"]
    assert rna_counts[cuda_duplex.MAIN] > 0, "the RNABinding sweep never launched the kernel"
    stray = {v: n for v, n in rna_counts.items() if v != cuda_duplex.MAIN and n}
    assert not stray, f"the RNABinding sweep launched row-cost builds: {stray}"
    assert len(rna_sweep) == 5 * len(lands)
    assert (rna_sweep["max_fitness"] >= rna_sweep["start_fitness"]).all()
    nam_kw = dict(**PHASE6_RUN, signal_strength=0.9)
    for i, land_i in ((0, lands[0]), (len(rna_sweep) - 1, lands[-1])):
        same_as_standalone(flexs, rna_sweep.iloc[i], land_i, flexs.RNAA, nam_kw)
    rna_reading = {"cells": len(rna_sweep), "wall_s": rna_wall,
                   "duplex_launches": rna_counts[cuda_duplex.MAIN], "host_syncs": syncs,
                   "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                   "mean_max_fitness": float(rna_sweep["max_fitness"].mean()),
                   "sequences_scored_per_s": int(rna_sweep["model_cost"].sum()
                                                 + rna_sweep["landscape_cost"].sum()) / rna_wall}
    print(f"rna generic sweep (vmap): {json.dumps(rna_reading)}; the first and last cells "
          f"equal their standalone runs [{card}]")
    steps.append(("end", time.perf_counter()))
    walls = step_walls(steps)
    print(f"phase 6 step walls (s): {json.dumps(walls)}")
    return {"oracle_max_abs_diff": oracle_diff, "fused": fused_reading,
            "host_wall_s": host_wall, "host_top": host_top, "surrogate_sweep": sweep_reading,
            "rna_generic_sweep": rna_reading, "step_walls_s": walls}


def fold_phases(flexs, cuda_duplex, card: str) -> dict:
    """Phase 8 (a-e): the Zuker fold DP and RNAFolding through the three entry points."""
    import pandas as pd
    from torch.profiler import ProfilerActivity, profile

    from flexs_tpu_torch import profile_fold
    from flexs_tpu_torch.landscapes import rna
    from flexs_tpu_torch.ops import rna_fold
    from flexs_tpu_torch.parallel import run_landscape_robustness_sweep
    from flexs_tpu_torch.profile_main_path import device_kernels

    cuda_duplex.reset_launch_counts()
    rng = np.random.default_rng(SEED)
    steps = [("a card vs CPU", time.perf_counter())]

    # a. The fold on the card against the CPU.
    em_card, em_cpu = (rna_fold.fold_energy_model(device=d) for d in ("cuda", "cpu"))
    batches = [rng.integers(0, 4, (64, n)) for n in (14, 50, 100)]
    by_len = {}
    for seq in FOLD_STRUCTURED:
        by_len.setdefault(len(seq), []).append(seq)
    batches += [flexs.Alphabet(flexs.RNAA).encode(seqs) for seqs in by_len.values()]
    fold_diff, bitwise = 0.0, True
    dev = em_card["consts"].device
    for tok in batches:
        on_card = rna_fold.zuker_mfe_batch(torch.as_tensor(tok, device=dev), em_card).cpu()
        on_cpu = rna_fold.zuker_mfe_batch(torch.as_tensor(tok), em_cpu)
        assert on_card.shape == (len(tok),) and torch.isfinite(on_card).all()
        fold_diff = max(fold_diff, float((on_card - on_cpu).abs().max()))
        bitwise = bitwise and torch.equal(on_card, on_cpu)
    assert fold_diff <= FOLD_TOLERANCE, fold_diff
    print(f"fold: card vs CPU on {sum(map(len, batches))} rows (B=64 at L=14/50/100 and "
          f"{len(FOLD_STRUCTURED)} structured rows): max |diff| {fold_diff}, bitwise {bitwise} "
          f"[{card}]")

    # b. profile_fold's readings.
    steps.append(("b profile_fold", time.perf_counter()))
    fold_profile = profile_fold.measure(dev)
    print(f"fold profile (python -m flexs_tpu_torch.profile_fold): {json.dumps(fold_profile)} "
          f"[{card}]")

    # c. The fused run, then again under torch.profiler (CUDA activity only).
    reg = rna.registry()
    starts = [reg["L100_RNA1"]["starts"][k] for k in (1, 2, 3, 4, 5)]
    land = rna.RNAFolding()
    nam_kw = dict(**PHASE6_RUN, signal_strength=0.9)

    def fused():
        cost = land.cost
        runner = flexs.runtime.DeviceAdaleadNAM(land, flexs.RNAA, starting_sequence=starts[0],
                                                seed=0, **nam_kw)
        (df, _), wall = timed(lambda: runner.run(verbose=False))
        return df, wall, land.cost - cost

    steps.append(("c fused", time.perf_counter()))
    df, wall, landscape_cost = fused()
    steps.append(("c profiled run and trace", time.perf_counter()))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        df_again, profiled_wall, _ = fused()
    steps.append(("c device totals", time.perf_counter()))
    kernels = device_kernels(prof)
    steps.append(("c checks", time.perf_counter()))
    device_s = sum(e.self_device_time_total for e in kernels) / 1e6
    pd.testing.assert_frame_equal(df, df_again)
    rounds, batch, budget = (
        PHASE6_RUN[k] for k in ("rounds", "sequences_batch_size", "model_queries_per_batch"))
    check_run_frame(df, rounds, batch, budget, starts[0], per_round=batch)
    assert np.array_equal(df["true_score"].to_numpy(),
                          land.get_fitness(df["sequence"].tolist()))
    top = float(df["true_score"].max())
    if FOLD_TOP is not None:
        assert round(top, 6) == FOLD_TOP, top
    queries = int(df["model_cost"].max()) + landscape_cost
    fused_reading = {
        "wall_s": wall, "queries_per_s": queries / wall, "top": top, "rows": len(df),
        "profiled_wall_s": profiled_wall, "kernel_launches": sum(e.count for e in kernels),
        "device_kernel_s": device_s, "device_idle_share_vs_profiled_wall": 1 - device_s
        / profiled_wall, "top_kernels": [{"name": e.key[:80], "count": e.count,
                                          "device_s": e.self_device_time_total / 1e6}
                                         for e in kernels[:6]],
    }
    print(f"rnafolding fused run (L100_RNA1 start 1, NAM 0.9, 10 x 100 x 2000): "
          f"{json.dumps(fused_reading)}; the two runs' frames are identical and true_score == "
          f"get_fitness [{card}]")

    # d. The host run.
    steps.append(("d host", time.perf_counter()))
    explorer = flexs.baselines.explorers.Adalead(
        flexs.baselines.models.NoisyAbstractModel(land, 0.9, seed=0), rounds=PHASE6_HOST_ROUNDS,
        sequences_batch_size=batch, model_queries_per_batch=budget, starting_sequence=starts[0],
        alphabet=flexs.RNAA, seed=0,
    )
    (df_host, _), host_wall = timed(lambda: explorer.run(land, verbose=False))
    check_run_frame(df_host, PHASE6_HOST_ROUNDS, batch, budget, starts[0], per_round=batch - 1)
    assert np.array_equal(df_host["true_score"].to_numpy(),
                          land.get_fitness(df_host["sequence"].tolist()))
    host_top = float(df_host["true_score"].max())
    print(f"rnafolding host run: wall {host_wall} s, top true_score {host_top}, rows "
          f"{len(df_host)} [{card}]")

    # e. A generic sweep over starts 1-5 in lockstep, FOLD_SWEEP_ROUNDS deep.
    steps.append(("e sweep", time.perf_counter()))
    sweep_kw = dict(nam_kw, rounds=FOLD_SWEEP_ROUNDS)
    ss = sweep_kw.pop("signal_strength")
    torch.cuda.reset_peak_memory_stats()
    sweep, sweep_wall = timed(lambda: run_landscape_robustness_sweep(
        [land], flexs.RNAA, starts, [ss], seeds=[0], **sweep_kw, cell_mode="vmap"))
    assert len(sweep) == 5 and (sweep["max_fitness"] >= sweep["start_fitness"]).all()
    steps.append(("e standalone cells", time.perf_counter()))
    for i in (0, len(sweep) - 1):
        same_as_standalone(flexs, sweep.iloc[i], land, flexs.RNAA,
                           dict(nam_kw, rounds=FOLD_SWEEP_ROUNDS))
    sweep_reading = {
        "cells": len(sweep), "rounds": FOLD_SWEEP_ROUNDS, "wall_s": sweep_wall,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "mean_max_fitness": float(sweep["max_fitness"].mean()),
        "sequences_scored_per_s": int(sweep["model_cost"].sum()
                                      + sweep["landscape_cost"].sum()) / sweep_wall,
    }
    print(f"rnafolding generic sweep (vmap, 5 starts): {json.dumps(sweep_reading)}; cells 1 "
          f"and 5 equal their standalone runs [{card}]")
    no_duplex_launches(cuda_duplex, "8")
    steps.append(("end", time.perf_counter()))
    walls = step_walls(steps)
    print(f"phase 8 step walls (s): {json.dumps(walls)}")
    return {"card_vs_cpu_max_abs_diff": fold_diff, "card_vs_cpu_bitwise": bitwise,
            "profile": fold_profile, "fused": fused_reading, "host_wall_s": host_wall,
            "host_top": host_top, "sweep": sweep_reading, "step_walls_s": walls}


def tf32_state() -> dict:
    return {"cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
            "float32_matmul_precision": torch.get_float32_matmul_precision()}


def gfp_phases(flexs, cuda_duplex, card: str) -> dict:
    """Phase 9 (a-d): the GFP oracle at full width through the three entry points.

    TF32 is off for the whole phase (cuDNN's flag is switched off here and
    restored after; matmuls run at PyTorch's default, full f32).
    """
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        tf32 = tf32_state()
        assert not tf32["cuda.matmul.allow_tf32"] and not tf32["cudnn.allow_tf32"], tf32
        assert tf32["float32_matmul_precision"] == "highest", tf32
        print(f"gfp: TF32 off for the phase: {tf32}")
        return _gfp_phases(flexs, cuda_duplex, card)
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32


def _gfp_phases(flexs, cuda_duplex, card: str) -> dict:
    import warnings

    from torch.profiler import ProfilerActivity, profile

    from flexs_tpu_torch.landscapes import bert_gfp
    from flexs_tpu_torch.parallel import run_landscape_robustness_sweep
    from flexs_tpu_torch.profile_main_path import device_kernels

    cuda_duplex.reset_launch_counts()
    steps = [("a landscapes and card vs CPU", time.perf_counter())]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        land = bert_gfp.BertGFPBrightness(**GFP_WIDTH, batch_size=GFP_BATCH)
        cpu_land = bert_gfp.BertGFPBrightness(**GFP_WIDTH, device="cpu", batch_size=4)
    assert any("DETERMINISTIC" in str(w.message) for w in caught), "expected the seeded oracle"
    m = land.module
    shape = {"layers": m.layers, "hidden": m.hidden, "heads": m.heads, "tokens": m.max_len,
             "parameters": sum(p.numel() for p in m.parameters())}
    assert (m.layers, m.hidden, m.heads, m.max_len) == (
        GFP_WIDTH["layers"], GFP_WIDTH["hidden"], GFP_WIDTH["hidden"] // 64, 256), shape
    rounds, batch, budget = (
        PHASE6_RUN[k] for k in ("rounds", "sequences_batch_size", "model_queries_per_batch"))

    # a. The oracle on the card against the CPU.
    starts = list(land.starts.values())
    seqs = [land.gfp_wt_sequence] + starts
    on_card, on_cpu = land.get_fitness(seqs), cpu_land.get_fitness(seqs)
    assert np.isfinite(on_card).all()
    np.testing.assert_allclose(on_card, on_cpu, rtol=GFP_TOLERANCE, atol=GFP_TOLERANCE)
    oracle_diff = float(np.abs(on_card - on_cpu).max())
    print(f"gfp oracle {shape} (seeded init; no checkpoint in the checkout): card vs CPU on the "
          f"wild type and 3 starts, max |diff| {oracle_diff}, scores {on_card.tolist()} [{card}]")

    # b. The fused run under torch.profiler (CUDA activity only), the oracle
    # timed by CUDA events.
    steps.append(("b fused run and trace", time.perf_counter()))
    with call_events(bert_gfp, "_gfp_fitness") as events:
        runner = flexs.runtime.DeviceAdaleadNAM(
            land, flexs.AAS, starting_sequence=starts[0], signal_strength=0.9, seed=0,
            **PHASE6_RUN)
        cost = land.cost
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            (df, _), wall = timed(lambda: runner.run(verbose=False))
        oracle_s = events_s(events)
    peak = torch.cuda.max_memory_allocated()
    landscape_cost = land.cost - cost
    steps.append(("b device totals", time.perf_counter()))
    kernels = device_kernels(prof)
    steps.append(("b checks", time.perf_counter()))
    device_s = sum(e.self_device_time_total for e in kernels) / 1e6
    check_run_frame(df, rounds, batch, budget, starts[0], per_round=batch)
    truth = land.get_fitness(df["sequence"].tolist())
    truth_diff = float(np.abs(df["true_score"].to_numpy() - truth).max())
    assert truth_diff <= GFP_TOLERANCE, truth_diff
    queries = int(df["model_cost"].max()) + landscape_cost
    fused_reading = {
        "wall_s": wall, "queries_per_s": queries / wall, "top": float(df["true_score"].max()),
        "rows": len(df), "oracle_calls": len(events), "oracle_s": oracle_s,
        "oracle_share_of_wall": oracle_s / wall, "peak_memory_bytes": peak,
        "kernel_launches": sum(e.count for e in kernels), "device_kernel_s": device_s,
        "device_idle_share": 1 - device_s / wall, "true_score_vs_get_fitness_max_diff":
        truth_diff,
        "top_kernels": [{"name": e.key[:80], "count": e.count,
                         "device_s": e.self_device_time_total / 1e6} for e in kernels[:6]],
    }
    print(f"gfp fused run (ed_10_wt, NAM 0.9, 10 x 100 x 2000, under the profiler): "
          f"{json.dumps(fused_reading)} [{card}]")

    # c. The host run, on the reference's 32 rows a forward pass.
    steps.append(("c host", time.perf_counter()))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        host_land = bert_gfp.BertGFPBrightness(**GFP_WIDTH)
    explorer = flexs.baselines.explorers.Adalead(
        flexs.baselines.models.NoisyAbstractModel(host_land, 0.9, seed=0),
        rounds=GFP_HOST_ROUNDS, sequences_batch_size=batch, model_queries_per_batch=budget,
        starting_sequence=starts[0], alphabet=flexs.AAS, seed=0,
    )
    (df_host, _), host_wall = timed(lambda: explorer.run(host_land, verbose=False))
    check_run_frame(df_host, GFP_HOST_ROUNDS, batch, budget, starts[0], per_round=batch - 1)
    host_top = float(df_host["true_score"].max())
    print(f"gfp host run: wall {host_wall} s, top true_score {host_top}, rows {len(df_host)} "
          f"[{card}]")

    steps.append(("d sweep", time.perf_counter()))
    # d. A generic sweep over the 3 starts, one cell after another: in lockstep
    # every step scores all cells' rows, which costs the oracle-bound GFP
    # run about 3x (194 s for these 3 cells at 2 rounds on an H100, PERF.md).
    torch.cuda.reset_peak_memory_stats()
    sweep, sweep_wall = timed(lambda: run_landscape_robustness_sweep(
        [land], flexs.AAS, starts, [0.9], seeds=[0], rounds=GFP_SWEEP_ROUNDS,
        sequences_batch_size=batch, model_queries_per_batch=budget, cell_mode="map"))
    assert len(sweep) == 3 and (sweep["max_fitness"] >= sweep["start_fitness"]).all()
    scored = int(sweep["model_cost"].sum() + sweep["landscape_cost"].sum())
    sweep_reading = {"cells": len(sweep), "rounds": GFP_SWEEP_ROUNDS, "wall_s": sweep_wall,
                     "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                     "sequences_scored_per_s": scored / sweep_wall,
                     "max_fitness": sweep["max_fitness"].tolist()}
    print(f"gfp generic sweep (map, 3 starts): {json.dumps(sweep_reading)} [{card}]")
    no_duplex_launches(cuda_duplex, "9")
    steps.append(("end", time.perf_counter()))
    walls = step_walls(steps)
    print(f"phase 9 step walls (s): {json.dumps(walls)}")
    return {"shape": shape, "card_vs_cpu_max_abs_diff": oracle_diff, "fused": fused_reading,
            "host_wall_s": host_wall, "host_top": host_top, "sweep": sweep_reading,
            "step_walls_s": walls}


def _mutants(rng, tokens, n: int) -> np.ndarray:
    """n copies of random rows of `tokens`, each with 1-3 random positions redrawn."""
    out = tokens[rng.integers(0, len(tokens), n)].copy()
    for row in out:
        pos = rng.choice(out.shape[1], rng.integers(1, 4), replace=False)
        row[pos] = rng.integers(0, 4, len(pos))
    return out


def default_members(flexs, seq_len: int, alphabet: str, device=None) -> list:
    """The port's counterparts of the JAX package's 11 DynaPPO default members.

    `tpu_native_default_models` (flexs_tpu/baselines/explorers/dyna_ppo.py:55-82),
    at its widths and defaults.
    """
    m = flexs.baselines.models
    dev = {} if device is None else {"device": device}
    return [
        m.GlobalEpistasisModel(seq_len, 100, alphabet, **dev),
        m.MLP(seq_len, 200, alphabet, **dev),
        m.CNN(seq_len, 32, 100, alphabet, **dev),
        m.TorchRidgeRegression(alphabet, alpha=0.0, name="linear_regression", **dev),
        m.TorchRandomForest(alphabet, **dev),
        m.TorchKNNRegressor(alphabet, **dev),
        m.TorchLasso(alphabet, **dev),
        m.TorchBayesianRidge(alphabet, **dev),
        m.TorchGaussianProcessRegressor(alphabet, **dev),
        m.TorchGradientBoosting(alphabet, **dev),
        m.TorchExtraTree(alphabet, **dev),
    ]


def regressors_card_vs_cpu(flexs, land, card: str) -> dict:
    """Phase 10a: each regressor fitted and queried on the card and on the CPU."""
    rng = np.random.default_rng(SEED)
    alphabet = flexs.Alphabet(flexs.RNAA)
    length = land.seq_length
    tokens = rng.integers(0, 4, (MODELS_ROWS, length))
    queries = np.concatenate([rng.integers(0, 4, (MODELS_QUERIES // 2, length)),
                              _mutants(rng, tokens, MODELS_QUERIES - MODELS_QUERIES // 2)])
    seqs = alphabet.decode(tokens)
    labels = np.asarray(land.get_fitness(seqs))
    names = ("linear_regression", "lasso", "bayesian_ridge", "gaussian_process",
             "nearest_neighbors", "random_forest", "gradient_boosting", "extra_trees")
    members = {}
    for dev in ("cuda", "cpu"):
        built = [m for m in default_members(flexs, length, flexs.RNAA, dev)
                 if m.name in names]
        members[dev] = {m.name: m for m in built}
    readings = {}
    for name in names:
        on_card, on_cpu = members["cuda"][name], members["cpu"][name]
        _, fit_s = timed(lambda: on_card.train(seqs, labels))
        on_cpu.train(seqs, labels)
        (p_card, _), predict_s = timed(lambda: (on_card.fitness_from_tokens(queries), None))
        p_cpu = on_cpu.fitness_from_tokens(queries)
        assert p_card.shape == (len(queries),) and np.isfinite(p_card).all(), name
        reading = {"fit_s": fit_s, "predict_s": predict_s,
                   "fitted_max_abs_diff": float(np.abs(p_card - p_cpu).max())}
        if name == "nearest_neighbors":
            assert np.array_equal(p_card, p_cpu), reading
        elif name in ("linear_regression", "lasso", "bayesian_ridge"):
            assert reading["fitted_max_abs_diff"] <= MODELS_TOLERANCE, (name, reading)
        elif name == "gaussian_process":
            assert reading["fitted_max_abs_diff"] <= GP_FIT_TOLERANCE, reading
            # The CPU's fit carried to the card: the posterior on both.
            state = on_cpu._state
            on_card._state = type(state)(
                state.train_tokens.cuda(), state.valid.cuda(),
                type(state.fit)(*(t.cuda() for t in state.fit)))
            diffs = [float(np.abs(on_card.fitness_from_tokens(queries)
                                  - on_cpu.fitness_from_tokens(queries)).max()),
                     float(np.abs(on_card.fitness_std_from_tokens(queries)
                                  - on_cpu.fitness_std_from_tokens(queries)).max())]
            reading["carried_mean_std_max_abs_diff"] = diffs
            assert max(diffs) <= MODELS_TOLERANCE, reading
        else:
            reading["fitted_corr"] = float(np.corrcoef(p_card, p_cpu)[0, 1])
            assert reading["fitted_corr"] >= TREES_MIN_CORR[name], (name, reading)
            on_card._state = tuple(t.cuda() for t in on_cpu._state)
            carried = on_card.fitness_from_tokens(queries)
            reading["carried_max_abs_diff"] = float(np.abs(carried - p_cpu).max())
            assert np.array_equal(carried, p_cpu), (name, reading)
        readings[name] = reading
    print(f"regressors card vs CPU ({MODELS_ROWS} rows at L={length}, {len(queries)} queries): "
          f"{json.dumps(readings)} [{card}]")
    return readings


def model_phases(flexs, cuda_duplex, card: str) -> dict:
    """Phase 10 (a-d): the rest of the models and the exact-GP surrogate on L100_RNA1."""
    import pandas as pd
    from torch.profiler import ProfilerActivity, profile

    from flexs_tpu_torch.landscapes import rna
    from flexs_tpu_torch.parallel import run_landscape_robustness_sweep
    from flexs_tpu_torch.profile_main_path import device_kernels
    from flexs_tpu_torch.runtime import SurrogateSpec, surrogate

    reg = rna.registry()
    land = rna.RNABinding(**reg["L100_RNA1"]["params"])
    starts = [reg["L100_RNA1"]["starts"][k] for k in GP_SWEEP_STARTS]
    steps = [("a regressors", time.perf_counter())]
    regressors = regressors_card_vs_cpu(flexs, land, card)

    # b. The fused GP run: cold (launches counted), warm (surrogate.train
    # timed by CUDA events), then under torch.profiler.
    spec = SurrogateSpec(arch="gp")
    runner_kw = dict(**PHASE6_RUN, model="surrogate", surrogate_spec=spec)
    rounds, batch, budget = (
        PHASE6_RUN[k] for k in ("rounds", "sequences_batch_size", "model_queries_per_batch"))

    def fused():
        cost = land.cost
        runner = flexs.runtime.DeviceAdaleadNAM(land, flexs.RNAA, starting_sequence=starts[0],
                                                seed=0, **runner_kw)
        (df, meta), wall = timed(lambda: runner.run(verbose=False))
        assert meta["model_name"] == "gaussian_process"
        return df, wall, land.cost - cost

    steps.append(("b cold", time.perf_counter()))
    cuda_duplex.reset_launch_counts()
    df, cold_wall, landscape_cost = fused()
    launches = path_launches(cuda_duplex, "fused GP")
    steps.append(("b warm", time.perf_counter()))
    with call_events(surrogate, "train") as events:
        df_warm, warm_wall, _ = fused()
    train_s = events_s(events)
    steps.append(("b profiled run and trace", time.perf_counter()))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        df_profiled, profiled_wall, _ = fused()
    steps.append(("b device totals", time.perf_counter()))
    kernels = device_kernels(prof)
    steps.append(("b checks", time.perf_counter()))
    device_s = sum(e.self_device_time_total for e in kernels) / 1e6
    pd.testing.assert_frame_equal(df, df_warm)
    pd.testing.assert_frame_equal(df, df_profiled)
    check_run_frame(df, rounds, batch, budget, starts[0], per_round=batch)
    assert df["measurement_cost"].max() == len(df) == landscape_cost
    assert (df[df["round"] > 0]["model_cost"] > 0).all()
    truth_diff = float(np.abs(df["true_score"].to_numpy()
                              - land.get_fitness(df["sequence"].tolist())).max())
    assert truth_diff <= 1e-6, truth_diff
    top = float(df["true_score"].max())
    assert launches == GP_FUSED_LAUNCHES, launches
    assert round(top, 6) == GP_FUSED_TOP, top
    queries = int(df["model_cost"].max()) + landscape_cost
    fused_reading = {
        "cold_wall_s": cold_wall, "warm_wall_s": warm_wall,
        "queries_per_s": queries / warm_wall, "top": top, "rows": len(df),
        "duplex_launches": launches, "train_s": train_s, "train_calls": len(events),
        "train_share_of_warm_wall": train_s / warm_wall, "profiled_wall_s": profiled_wall,
        "kernel_launches": sum(e.count for e in kernels), "device_kernel_s": device_s,
        "device_idle_share_vs_profiled_wall": 1 - device_s / profiled_wall,
        "top_kernels": [{"name": e.key[:80], "count": e.count,
                         "device_s": e.self_device_time_total / 1e6} for e in kernels[:8]],
    }
    print(f"gp surrogate fused run (L100_RNA1 start 1, 150 LML steps, 10 x 100 x 2000): "
          f"{json.dumps(fused_reading)}; the three runs' frames are identical and true_score == "
          f"get_fitness [{card}]")

    # c. The host run: Adalead over an AdaptiveEnsemble of the 11 default members.
    steps.append(("c host", time.perf_counter()))
    host_land = rna.RNABinding(**reg["L100_RNA1"]["params"])
    members = default_members(flexs, len(starts[0]), flexs.RNAA)
    train_s = {}

    def timed_train(member):
        original = member.train

        def train(*args, **kwargs):
            _, train_s[member.name] = timed(lambda: original(*args, **kwargs))
        return train

    for member in members:
        member.train = timed_train(member)
    ensemble = flexs.baselines.models.AdaptiveEnsemble(members)
    explorer = flexs.baselines.explorers.Adalead(
        ensemble, rounds=PHASE6_HOST_ROUNDS, sequences_batch_size=batch,
        model_queries_per_batch=budget, starting_sequence=starts[0], alphabet=flexs.RNAA,
        seed=0,
    )
    cuda_duplex.reset_launch_counts()
    (df_host, meta_host), host_wall = timed(lambda: explorer.run(host_land, verbose=False))
    host_launches = path_launches(cuda_duplex, "host ensemble")
    check_run_frame(df_host, PHASE6_HOST_ROUNDS, batch, budget, starts[0], per_round=batch - 1)
    assert meta_host["model_name"] == ensemble.name and len(members) == 11
    weights = ensemble.weights
    assert np.isfinite(weights).all() and abs(weights.sum() - 1) < 1e-9, weights
    host_reading = {
        "wall_s": host_wall, "top": float(df_host["true_score"].max()), "rows": len(df_host),
        "duplex_launches": host_launches,
        "weights": dict(zip([m.name for m in members], weights.tolist())),
        "last_round_train_s": train_s,
    }
    print(f"host run (Adalead + AdaptiveEnsemble of 11 members, 3 rounds): "
          f"{json.dumps(host_reading)} [{card}]")

    # d. The GP sweep over starts 1-3, one cell after another, and a 2-cell
    # lockstep chunk.
    steps.append(("d sweep", time.perf_counter()))
    sweep_kw = dict(signal_strengths=[1.0], seeds=[0], **runner_kw)
    cuda_duplex.reset_launch_counts()
    sweep, sweep_wall = timed(lambda: run_landscape_robustness_sweep(
        [land], flexs.RNAA, starts, **sweep_kw, cell_mode="map"))
    sweep_launches = path_launches(cuda_duplex, "GP sweep")
    assert len(sweep) == len(starts) and (sweep["model_cost"] > 0).all()
    first = sweep.iloc[0]
    assert first["max_fitness"] == df["true_score"].max(), first
    assert first["model_cost"] == df["model_cost"].iloc[-1], first
    assert first["landscape_cost"] == landscape_cost, first
    steps.append(("d standalone last cell", time.perf_counter()))
    same_as_standalone(flexs, sweep.iloc[-1], land, flexs.RNAA, runner_kw)
    steps.append(("d vmap chunk", time.perf_counter()))
    lockstep, lockstep_wall = timed(lambda: run_landscape_robustness_sweep(
        [land], flexs.RNAA, starts[:2], **sweep_kw, cell_mode="vmap"))
    pd.testing.assert_frame_equal(lockstep, sweep.iloc[:2], check_exact=True)
    sweep_reading = {"cells": len(sweep), "wall_s": sweep_wall, "duplex_launches": sweep_launches,
                     "s_per_cell": sweep_wall / len(sweep),
                     "mean_max_fitness": float(sweep["max_fitness"].mean()),
                     "vmap_chunk_cells": len(lockstep), "vmap_chunk_wall_s": lockstep_wall}
    print(f"gp surrogate sweep (map, starts {list(GP_SWEEP_STARTS)}): {json.dumps(sweep_reading)}; "
          f"its first cell equals the fused run, its last a standalone run, and a 2-cell vmap "
          f"chunk equals its map cells [{card}]")
    steps.append(("end", time.perf_counter()))
    walls = step_walls(steps)
    print(f"phase 10 step walls (s): {json.dumps(walls)}")
    return {"regressors": regressors, "fused": fused_reading, "host": host_reading,
            "sweep": sweep_reading, "step_walls_s": walls}


def clock_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing was run",
              file=sys.stderr)
        return 1

    try:
        import flexs_tpu_torch as flexs
    except ModuleNotFoundError as e:
        # Run outside a checkout (the script alone in a directory): there is
        # nothing to drive.
        print(f"chip_smoke: {e}; run it from the root of a checkout of the repository",
              file=sys.stderr)
        return 1
    from flexs_tpu_torch import profile_duplex_rowcost as rowcost
    from flexs_tpu_torch.landscapes import rna
    from flexs_tpu_torch.ops import cuda_duplex
    from flexs_tpu_torch.ops import rna_duplex as rd
    from flexs_tpu_torch.profile_duplex_rowcost import time_ms

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    rng = np.random.default_rng(SEED)
    reg = rna.registry()
    problem = reg["L100_RNA1"]
    start = problem["starts"][1]

    stamps = [("1 build", time.perf_counter())]
    # 1. Build every library at once, one nvcc each.
    builds = (cuda_duplex.MAIN,) + cuda_duplex.VARIANTS
    build_pool = ThreadPoolExecutor(max_workers=len(builds))
    pending = {v: build_pool.submit(timed_build, cuda_duplex, v) for v in builds}
    for v in builds:
        print_build(v, *pending[v].result())
    build_pool.shutdown()
    print(f"card: {card}")

    stamps.append(("2 kernel vs plain", time.perf_counter()))
    # 2. Kernel vs plain version on the card.
    land = rna.RNABinding(**problem["params"])
    plan = land.device_fitness()[1].plan
    targets_rev, em = plan.targets_rev, plan.em
    maxloop = land.params.maxloop
    cases = []
    max_diff = 0.0

    def random_tokens(b, l1):
        return torch.as_tensor(rng.integers(0, 4, (b, l1)), device="cuda")

    for b, l1 in [(100, 100), (512, 100), (4096, 100), (64, 50), (64, 14)]:
        _, _, diff = kernel_vs_plain(cuda_duplex, random_tokens(b, l1), targets_rev, em, maxloop)
        max_diff = max(max_diff, diff)
        cases.append(f"B={b},L1={l1},T=1")
    two = rna.RNABinding(**reg["L100_RNA1+2"]["params"])
    _, _, diff = kernel_vs_plain(
        cuda_duplex, random_tokens(100, 100), two.device_fitness()[1].plan.targets_rev, em, maxloop
    )
    max_diff = max(max_diff, diff)
    cases.append("B=100,L1=100,T=2")
    all_a = torch.full((4, 100), 3, device="cuda")  # token 3 = "A"
    all_a[1:] = random_tokens(3, 100)
    kern, _, diff = kernel_vs_plain(
        cuda_duplex, all_a, torch.full((1, 100), 3, device="cuda"), em, maxloop
    )
    assert float(kern[0, 0]) == 0.0, "an unpairable row must score 0"
    max_diff = max(max_diff, diff)
    cases.append("unpairable all-A row")
    em7 = rd.DuplexParams(maxloop=7).energy_model("cuda")
    _, _, diff = kernel_vs_plain(cuda_duplex, random_tokens(100, 100), targets_rev, em7, 7)
    max_diff = max(max_diff, diff)
    cases.append("B=100,L1=100,T=1,maxloop=7")
    # A short target: one warp per block.
    _, _, diff = kernel_vs_plain(cuda_duplex, random_tokens(100, 100), random_tokens(2, 32),
                                 em, maxloop)
    max_diff = max(max_diff, diff)
    cases.append("B=100,L1=100,T=2,L2=32")
    # Landscape level: conserved-region zeroing and the two-target mean,
    # kernel on the card vs the plain version on the CPU.
    c20 = reg["C20_L100_RNA1+2"]["params"]
    tok = rng.integers(0, 4, (64, 100))
    pattern = flexs.Alphabet(flexs.RNAA).encode_one(c20["conserved_region"]["pattern"])
    tok[::2, 21:21 + len(pattern)] = pattern
    on_card = rna.RNABinding(**c20).fitness_from_tokens(tok).cpu()
    on_cpu = rna.RNABinding(**c20, device="cpu").fitness_from_tokens(tok)
    assert torch.equal(on_card, on_cpu), float((on_card - on_cpu).abs().max())
    assert (on_card[1::2] == 0).all() and (on_card[::2] != 0).all()
    cases.append("C20_L100_RNA1+2 landscape, card vs CPU")
    print(f"kernel == plain (bitwise) on: {'; '.join(cases)}")

    # Timing: the kernel alone on the landscape's plan, the wrapper the main
    # path calls (checks, output, launch), and the plain version.
    reps, inner = rowcost.TIMING_REPS, rowcost.TIMING_INNER
    timings = {}
    for b in (100, 512, 4096):
        tokens = random_tokens(b, 100)
        entry = {
            "ms": time_ms(lambda: cuda_duplex.launch_plan(plan, tokens), reps, inner),
            "sm_clock_power_after": clock_line(),
            "plain_ms": time_ms(
                lambda: cuda_duplex.duplex_energies_plain(tokens, targets_rev, em, maxloop),
                reps, 1),
            **bound_entry(rowcost.plan_bytes(plan, tokens), (b, 1, 100, 100, maxloop)),
        }
        if b in (100, 512):
            entry["wrapper_ms"] = time_ms(
                lambda: cuda_duplex.duplex_energies(tokens, targets_rev, em, maxloop, plan=plan),
                reps, inner)
        timings[b] = entry
        print(f"timing B={b}, T=1, L1=L2=100: kernel {entry['ms']} ms "
              f"(SM clock, power after: "
              f"{entry['sm_clock_power_after']}), wrapper {entry.get('wrapper_ms')} ms, "
              f"plain {entry['plain_ms']} ms, bound {entry['bound_ms']} ms "
              f"({entry['bound_by']}; {entry['n_bytes']} bytes, "
              f"{entry['operations']} operations)")

    stamps.append(("3 fused", time.perf_counter()))
    # 3. Fused main path at full width.
    runner = flexs.runtime.DeviceAdaleadNAM(
        land, flexs.RNAA, rounds=10, sequences_batch_size=100,
        model_queries_per_batch=2000, starting_sequence=start,
        signal_strength=0.9, seed=0,
    )
    cost_before = land.cost
    cuda_duplex.reset_launch_counts()
    t0 = time.perf_counter()
    df, meta = runner.run(verbose=False)
    torch.cuda.synchronize()
    fused_wall = time.perf_counter() - t0
    fused_counts = main_path_counts(cuda_duplex, "fused", FUSED_LAUNCHES)
    queries = int(df["model_cost"].max()) + (land.cost - cost_before)
    check_run_frame(df, 10, 100, 2000, start, per_round=100)
    truth = land.get_fitness(df["sequence"].tolist())
    truth_diff = float(np.abs(df["true_score"].to_numpy() - truth).max())
    assert truth_diff <= 1e-6, truth_diff
    fused_top = float(df["true_score"].max())
    assert round(fused_top, 6) == FUSED_TOP, fused_top
    print(f"fused: wall {fused_wall} s, {queries / fused_wall} queries/s "
          f"(model + landscape), top true_score {fused_top}, "
          f"kernel launches {fused_counts}, rows {len(df)}")

    stamps.append(("4 host", time.perf_counter()))
    # 4. Host path.
    host_land = rna.RNABinding(**problem["params"])
    model = flexs.baselines.models.NoisyAbstractModel(host_land, 0.9, seed=0)
    explorer = flexs.baselines.explorers.Adalead(
        model, rounds=3, sequences_batch_size=100, model_queries_per_batch=2000,
        starting_sequence=start, alphabet=flexs.RNAA, seed=0,
    )
    cuda_duplex.reset_launch_counts()
    t0 = time.perf_counter()
    df_host, _ = explorer.run(host_land, verbose=False)
    torch.cuda.synchronize()
    host_wall = time.perf_counter() - t0
    host_counts = main_path_counts(cuda_duplex, "host", HOST_LAUNCHES)
    check_run_frame(df_host, 3, 100, 2000, start, per_round=99)
    host_truth = host_land.get_fitness(df_host["sequence"].tolist())
    assert float(np.abs(df_host["true_score"].to_numpy() - host_truth).max()) <= 1e-6
    host_top = float(df_host["true_score"].max())
    assert round(host_top, 6) == HOST_TOP, host_top
    print(f"host: wall {host_wall} s, top true_score {host_top}, "
          f"kernel launches {host_counts}, rows {len(df_host)}")

    stamps.append(("5 tf-bind", time.perf_counter()))
    # 5. TF-Bind-8: no kernel of this port on its path.
    tf_readings = tf_binding_phases(flexs, cuda_duplex, card)
    print(f"tf-bind readings: {json.dumps(tf_readings)}")

    stamps.append(("6 surrogate", time.perf_counter()))
    # 6. The trained-surrogate path and the generic landscape sweep.
    surrogate_readings = surrogate_phases(flexs, cuda_duplex, card)
    print(f"surrogate readings: {json.dumps(surrogate_readings)}")

    stamps.append(("7 row-cost", time.perf_counter()))
    # 7. Row-cost builds: the profiler's run, check and timing of every
    # build on its seeded inputs, with the redesigned kernel beside them.
    cuda_duplex.reset_launch_counts()
    rc = rowcost.measure(*rowcost.seeded_inputs("cuda"))
    torch.cuda.synchronize()
    rc_counts = cuda_duplex.launch_counts()
    silent = [v for v, n in rc_counts.items() if n == 0]
    assert not silent, f"the row-cost path never launched {silent}"
    print(f"row-cost phase, SM clock and power after: {clock_line()}")
    rc_entries = {v: {} for v in cuda_duplex.VARIANTS}
    for b, batch in rc.items():
        bound = bound_entry(batch["n_bytes"], batch["dims"])
        for v, reading in batch["variants"].items():
            entry = {**reading, "plain_ms": batch["plain_ms"], **bound}
            rc_entries[v][b] = entry
            print(f"row-cost {v} B={b}: {entry['ms']} ms, {entry['us_per_row']} us/row, "
                  f"plain {entry['plain_ms']} ms, bound {entry['bound_ms']} ms "
                  f"({entry['bound_by']}), equal to baseline {entry['equal_to_baseline']}, "
                  f"max |diff| vs plain {entry['max_abs_err']}")
        r = batch["redesign"]
        print(f"row-cost phase duplex_dp B={b}: {r['ms']} ms, {r['us_per_row']} us/row, "
              f"max |diff| vs plain {r['max_abs_err']}")
    print(f"row-cost: {list(cuda_duplex.EXACT_VARIANTS)} and duplex_dp == plain (bitwise) at "
          f"B={tuple(rc)}; launches {rc_counts}")

    stamps.append(("8 fold", time.perf_counter()))
    # 8. The fold DP and RNAFolding: no kernel of this port on its path.
    fold_readings = fold_phases(flexs, cuda_duplex, card)
    print(f"fold readings: {json.dumps(fold_readings)}")

    stamps.append(("9 gfp", time.perf_counter()))
    # 9. GFP's ProteinBERT oracle at full width: no kernel of this port either.
    gfp_readings = gfp_phases(flexs, cuda_duplex, card)
    print(f"gfp readings: {json.dumps(gfp_readings)}")

    stamps.append(("10 models", time.perf_counter()))
    # 10. The rest of the models and the exact-GP surrogate.
    model_readings = model_phases(flexs, cuda_duplex, card)
    print(f"model readings: {json.dumps(model_readings)}")

    # Wall of each phase, so the script's time can be kept near 700 s.
    stamps.append(("end", time.perf_counter()))
    phase_walls = step_walls(stamps)
    print(f"phase walls (s): {json.dumps(phase_walls)}")

    # 11. Report: the main path's shape (B=100) at the top level, B=512 and
    # B=4096 beside it, and the same call's row-cost readings.
    kernels = [{
        "name": "duplex_dp",
        "route": "cuda",
        "source": "flexs_tpu_torch/csrc/duplex_dp.cu",
        "replaces": "flexs_tpu/ops/pallas_duplex.py:374",
        "launches": fused_counts[cuda_duplex.MAIN],
        "host_launches": host_counts[cuda_duplex.MAIN],
        "rna_generic_sweep_launches": surrogate_readings["rna_generic_sweep"]["duplex_launches"],
        "gp_fused_launches": model_readings["fused"]["duplex_launches"],
        "gp_host_launches": model_readings["host"]["duplex_launches"],
        "max_abs_err": max_diff,
        **timings[100],
        "library_ms": None,
        "at_B512": timings[512],
        "at_B4096": timings[4096],
        "rowcost_phase": {b: batch["redesign"] for b, batch in rc.items()},
    }]
    # The row-cost builds: the profiler's B=4096 at the top level, B=100
    # beside it; `launches` counts the row-cost phase, `fused_launches` the
    # fused run.
    for v in cuda_duplex.VARIANTS:
        exact = v in cuda_duplex.EXACT_VARIANTS
        kernels.append({
            "name": f"duplex_rowcost_{v.replace('-', '_')}",
            "route": "cuda",
            "source": "flexs_tpu_torch/csrc/duplex_rowcost.cu",
            "replaces": "scripts/profile_duplex_rowcost.py:206",
            "launches": rc_counts[v],
            "fused_launches": fused_counts[v],
            "knockout": v != "baseline",
            "tolerance": "bitwise" if exact else "finite only (wrong by design)",
            **rc_entries[v][rowcost.BATCH],
            "library_ms": None,
            "at_B100": rc_entries[v][rowcost.MAIN_PATH_BATCH],
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
