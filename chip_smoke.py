#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failed check raises, and the script exits nonzero):
  1. build, from this checkout, the main path's CUDA duplex kernel
     (flexs_tpu_torch/csrc/duplex_dp.cu), the eight row-cost knockouts of
     it (csrc/duplex_rowcost.cu) and the first kernel (csrc/duplex_first.cu):
     ten nvcc runs, all started together in threads;
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
  7. row-cost builds: the path of `python -m
     flexs_tpu_torch.profile_duplex_rowcost`.  `profile_duplex_rowcost.
     measure` runs every build (baseline, the main path's library; the
     knockouts of duplex_dp_kernel<16>; first) on the profiler's seeded
     inputs at B=4096 and B=100, requires the exact builds (baseline,
     unrolled, chains-1, chains-8, clocked, first) to equal the plain
     version bitwise and the others (wrong by design) to give finite
     f32[B], times each (us per row and its difference from baseline) and
     splits a row into four parts by the clocked build's stamps; printed
     beside them: baseline's time against phase 2's kernel time, and at
     B=100 the parts' sum against the clocked build's own us per row;
  8. the fold (RNAFolding; no kernel of this port, no duplex build may
     launch):
     a. `zuker_mfe_batch` on the card against the CPU on seeded rows (B=64
        at L = 14, 50, 100) and the structured rows of
        tests/test_rna_fold.py: bitwise expected, max |diff| <= 1e-5
        required;
     b. the readings of `python -m flexs_tpu_torch.profile_fold`;
     c. the fused run: DeviceAdaleadNAM on RNAFolding from L100_RNA1's start
        1 (L=100), NAM 0.9, seed 0, 10 x 100 x 2000, then its first 2
        rounds again under torch.profiler (CUDA activity only): the 2-round
        frame equal to the 10-round run's first rounds, run invariants,
        true_score == get_fitness exactly; wall, queries/s, launches,
        device time, top true_score;
     d. the host run: Adalead + NoisyAbstractModel, 3 rounds;
     e. a generic sweep over starts 1-5 at ss 0.9 in lockstep, cut to 1
        round: cells 1 and 5 equal standalone runs;
  9. GFP at full width (12 layers, hidden 768, 12 heads, 256 tokens; the
     seeded-init oracle, as no checkpoint is in the checkout; 100 rows a
     forward pass), TF32 off for the whole phase, no duplex build may
     launch:
     a. the oracle on the card against the CPU on the wild type and the
        three starts, rtol and atol 1e-4;
     b. the fused run from ed_10_wt, NAM 0.9, 5 x 100 x 2000, under
        torch.profiler (CUDA activity only): wall, queries/s, peak memory,
        device idle share and the oracle's share of the wall (CUDA events);
     c. the host run, 2 rounds, on a landscape scoring 32 rows a pass;
     d. a generic sweep over 1 of the 3 starts, cut to 1 round ("map");
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
  11. the host explorers (a launches no duplex build, nor do b and c;
     d launches the main path's kernel through the oracle, and no row-cost
     build may launch):
     a. their components on the card against the CPU at 3MSI's width
        (L = 66, 20 letters), rtol = atol: CMA-ES's tell at n = 1,320,
        popsize 15, from init and across an eigenbasis refresh (1e-4); the
        VAE (intermediate 250) decoder and log probability (1e-5), and its
        CUDA-graph training steps equal to eager ones bitwise; the Q
        network's all-action Q (1e-5) and a training call (1e-4); the
        actor-critic (fc 128; 1e-5) and a PPO update (1e-4); the DynaPPO
        density over 2,000 cached neighbours, bitwise;
     b. the paper's 3MSI table row (scripts/run_paper_table.py:100-160):
        random, genetic, bo, cmaes, cbas, dbas, dqn, ppo, dynappo and
        dynappo_mutative over a perfect model of RosettaFolding 3msi (the
        DynaPPOs over their default 11-member ensemble), 2 rounds x 100 x
        2000 (dynappo_mutative 500 model queries a round), start ed_3_wt,
        seed 0: run invariants, true_score == get_fitness; wall and top
        beside the reference's 10-round mean (a reading); DynaPPO's act
        calls and the device's idle share over a window of 2,000 of them;
     c. GPR_BO Thompson over all 65,536 8-mers of SIX6_REF_R1 with an
        identity ensemble of three CNN(8, 32, 100), 2 rounds x 100: model
        cost grows by 65,536 a round;
     d. BO over NAM 0.9 (3 rounds) and DynaPPO with its default members
        (2 rounds) on L100_RNA1 from start 1: duplex launches and tops
        pinned (34, 0.587749; 17, 0.579332);
  12. the fused runners of the non-RL explorers (a, b and d's GA sweep
     launch no duplex build; c and d's BO sweep launch the main path's
     kernel through the oracle, and no row-cost build may launch):
     a. the paper's fused 3MSI rows (scripts/run_paper_table.py:161-214):
        DeviceRandomNAM (elitist=False), DeviceGeneticAlgorithmNAM,
        DeviceCMAESNAM (maximize=True) and DeviceBONAM over a perfect model
        of RosettaFolding 3msi, start ed_3_wt, seed 0, 10 x 100 x 2000;
        DeviceCbASNAM with algo "cbas" and "dbas" cut to 2 rounds: run
        invariants, true_score == get_fitness exactly on each round's rows;
        wall, queries/s, host syncs and top beside phase 11b's host top
        and the reference's 10-round mean (a reading); the VAE's CUDA-graph
        steps equal to eager ones bitwise on a one-cycle DbAS run;
     b. GPR_BO over all 65,536 8-mers of SIX6_REF_R1, 10 rounds x 100, with
        NAM 0.9 (Thompson) and a perfect model: the model cost grows by
        65,536 a round, the perfect run's round 1 is the table's top 100
        without the start, and the perfect run on the card equals the
        same run on the CPU row for row;
     c. DeviceGeneticAlgorithmNAM and DeviceBONAM over NAM 0.9 on L100_RNA1
        from start 1, 10 x 100 x 2000, each twice: identical frames, duplex
        launches and tops pinned (2,949, 0.632479; 111, 0.584328);
     d. run_robustness_sweep(algorithm="ga") over 4 TF-Bind landscapes x
        ss {0.5, 0.9} x seeds {0, 1} in one lockstep chunk of 16 cells (1
        round), and run_landscape_robustness_sweep(algorithm="bo") over
        L100_RNA1's starts 1-3: first and last cells equal standalone
        runs; wall, s per cell, sequences scored/s;
  13. the fused RL runners (a and c launch no duplex build; b and d's DQN
     sweep launch the main path's kernel through the oracle, and no
     row-cost build may launch):
     a. the paper's fused RL rows on 3MSI (scripts/run_paper_table.py:
        175-240): DeviceDQNNAM, DevicePPONAM, DeviceDynaPPONAM
        (env_batch_size=16) and DeviceDynaPPOMutativeNAM over a perfect
        model of RosettaFolding 3msi, start ed_3_wt, seed 0, 100 x 2000,
        cut in rounds (RL_RUN_ROUNDS): run invariants, true_score ==
        get_fitness exactly on each round's rows; wall, queries/s, host
        syncs (DynaPPO's per round: none inside a round) and top beside
        phase 11b's host top and the reference's DynaPPO row (0.934, best
        0.972); DynaPPO's CUDA-graph episodes equal to eager ones bitwise
        on a 1-round run; PPO's update on the card against the same update
        on the CPU from the card's inputs (parameters within 1e-4 of the
        update's size, statistics within 1e-5 relative);
     b. DevicePPONAM (2 rounds) and DeviceDynaPPONAM (1 round) over NAM 0.9
        on L100_RNA1 from start 1, 100 x 2000, each twice: identical
        frames; duplex launches, top and the last round's mean true_score
        pinned (6,531, 0.579332, 0.442182; 134, 0.579332, 0.236061);
     c. the density on the card against the CPU's, on a seeded 3MSI-width
        pool, under both metrics (distances bitwise, the weighted sums
        within 1e-6 relative: the card's dot product adds in another
        order); one DeviceDynaPPOMutativeNAM round with
        density_metric="edit" on 3MSI beside a Hamming one;
     d. run_robustness_sweep(algorithm="dynappo") in one lockstep chunk of
        16 cells (4 TF-Bind landscapes x ss {0.5, 0.9} x seeds {0, 1}) and
        run_landscape_robustness_sweep(algorithm="dqn") over L100_RNA1's
        starts 1-3, 2 rounds, duplex launches pinned (4,003): first and
        last cells equal standalone runs exactly; wall, s per cell,
        sequences scored/s;
  14. the infrastructure modules (the duplex kernel launches in b and e,
     and in c's traced round):
     a. a 4-cell TF-Bind GA grid (SIX6_REF_R1 x 2 starts x ss 0.9 x seeds
        {0, 1}, 2 rounds of 100 x 500) through `flexs_tpu_torch.cli`
        without a mesh, on a one-rank `multihost_sweep_mesh()` with
        checkpoints, rerun (resumed from them, nothing rewritten), and over
        two torchrun ranks that share the card and gather over gloo: the
        four CSVs must be equal byte for byte;
     b. a CNN at 3MSI's width fit, saved with `save_state` after its first
        `train` (weights, Adam state, generator), loaded into another model
        and fit again: equal to the uninterrupted fit bitwise; host Adalead
        + NAM on L100_RNA1 run 2 rounds, then `resume_explorer` to 3: the
        logged rows unchanged, the duplex kernel launched, every round's
        true_score equal to `get_fitness` of its rows as one batch;
     c. `amortized_seconds_per_call` of the kernel at B = 100 beside phase
        2's CUDA-event median, and one fused L100_RNA1 round under
        `profiling.trace`, whose Chrome trace must name the duplex kernel;
     d. `python -m flexs_tpu_torch.cli`'s fast path as a program
        (SIX6_REF_R1, 1 start, 2 rounds, 100 x 2000), equal to the same
        call in this process;
     e. the native library (native/flexs_native.cc, built with g++)
        against the card: Rosetta 3msi within rtol 1e-4 / atol 1e-5 and
        the duplex DP against the kernel on 100 L100_RNA1 rows within
        rtol 1e-4 / atol 1e-3;
  15. the measurement entry points (flexs_tpu_torch.bench and
     bench_surrogate), small; each stage's JSON line must have its keys,
     in order, and name this card:
     a. bench.run_rna_oracle at B=100, 5 calls a reading: the kernel on a
        plan, bitwise equal to its plain version on bench.py's check
        batch, 19 launches;
     b. bench.run_single with one run_once (seed 0, no warm-up): phase
        5b's run, the same top true_score, no duplex launch;
     c. bench_surrogate.bench_tfbind_cmaes cut to 1 round on SIX6_REF_R1
        from one start: DeviceCMAESNAM with the 3-CNN ensemble surrogate;
  16. the paper table and the north-star grid (flexs_tpu_torch.
     run_paper_table, bench_northstar and aggregate_northstar), small; no
     duplex build may launch:
     a. run_paper_table with device-cmaes and random, 1 start, 1 round:
        the per-start, row and JSON lines parse and agree, each JSON line
        names this card, and the fused row's max equals a standalone
        DeviceCMAESNAM run of the same start and seed;
     b. bench_northstar with random and adalead over 8 landscapes, 1
        round, a chunk of 8: a line per family (8 cells each) and the
        summary;
     c. aggregate_northstar over b's output: its summary equals b's in
        total_cells and total_seqs, and its artifact holds both families;
  17. print the wall of each phase, one JSON line describing each kernel,
     the card's name and power limit, and last the device JSON line.

Each path's phase sets the launch counters of every build to 0 just before
it and reads them just after; a phase in which one of its kernels never
launched fails, and so does a main-path run that launched a row-cost
build.  The script needs one CUDA card and imports nothing of JAX.
"""
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

SEED = 0
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
# took 85 s on an H100 (PERF.md), so its depth is cut (to 2 rounds, and to 1
# since phase 12 came); cells are held to standalone runs of the same depth.
FOLD_SWEEP_ROUNDS = 1
# The profiled fused run's rounds: under the profiler the 10-round run took
# 107 s and its events 27 s more on an H100 (PERF.md, Cells), so only its
# first rounds are profiled, and held to the full run's first rounds.
FOLD_PROFILED_ROUNDS = 2
# Phase 9: GFP at full width; card vs CPU, and the depth of its host run and sweep.
GFP_TOLERANCE = 1e-4  # rtol and atol
GFP_WIDTH = dict(layers=12, hidden=768)  # TAPE's bert-base; 12 heads, 256 tokens
# Rows per GFP forward pass: the runner's proposal batch, so that no chunk of
# a 100-row oracle call is padded.  The host run keeps the reference's 32:
# its model queries come in small batches, each padded to a whole chunk.
GFP_BATCH = 100
# The fused run is cut in depth to 5 rounds, the host run to 2 and the sweep
# to 2 of the 3 starts since phase 12 came (the script took 1,078 s of phases
# with 10, 3 and 3 on an H100, PERF.md, Cells), and the sweep to 1 start
# since phase 14 came (1,038 s of phases with 2).
GFP_FUSED_ROUNDS, GFP_HOST_ROUNDS, GFP_SWEEP_ROUNDS, GFP_SWEEP_STARTS = 5, 2, 1, 1
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
# Phase 11: the host explorers.  (a) Their components on the card against
# the CPU at 3MSI's width (L = 66, 20 letters): CMA-ES over n = 1,320 with
# popsize 15, the VAE (intermediate 250), the Q network, the actor-critic
# (fc 128) and the DynaPPO density.
# Each is rtol = atol (`np.allclose`): inference 1e-5, a training step and
# CMA-ES's tell 1e-4.
COMPONENT_TOLERANCE = 1e-5
COMPONENT_TRAIN_TOLERANCE = CMAES_TOLERANCE = 1e-4
# (b) The paper's 3MSI table row (scripts/run_paper_table.py:100-160) cut in
# depth to 2 rounds; each top printed beside the reference's 10-round mean
# (`run_paper_table.REFERENCE`, a reading, not a gate).
EXPLORER_RUN = dict(rounds=2, sequences_batch_size=100, model_queries_per_batch=2000)
PAPER_EXPLORERS = ("random", "genetic", "bo", "cmaes", "cbas", "dbas", "dqn", "ppo", "dynappo",
                   "dynappo_mutative")
# DynaPPOMutative's model budget is cut from 2000 to 500 queries a round:
# each query is a one-row walk step (an `act`, an ensemble query and a
# density call, ~19 ms on an H100), 78 s for 2 rounds at 2000.
PAPER_RUN_CUTS = {"dynappo_mutative": dict(model_queries_per_batch=500)}
# DynaPPO's device busy share is read over a steady window of `act` calls
# in round 1's model phase (calls 1,000-2,999 of 8,712 a round).
DYNAPPO_PROFILED_ACTS = (1000, 2000)
# (c) GPR_BO over all of TF-Bind-8, and (d) the kernel's path on L100_RNA1:
# BO over NAM 0.9 for 3 rounds and DynaPPO with its 11 default members for
# 2, each pinned (duplex launches, top true_score) from its first run on an
# H100.
GPR_BO_ROUNDS = 2
L100_BO_ROUNDS, L100_DYNAPPO_ROUNDS = 3, 2
L100_BO_LAUNCHES, L100_BO_TOP = 34, 0.587749
L100_DYNAPPO_LAUNCHES, L100_DYNAPPO_TOP = 17, 0.579332
# Phase 12: the fused runners of the non-RL explorers.  (a) The paper's
# fused 3MSI rows (scripts/run_paper_table.py:161-214): a perfect model of
# RosettaFolding 3msi, start ed_3_wt, seed 0, 10 rounds x 100 x 2000; the
# CbAS and DbAS rows cut in depth to 2 rounds (each later round trains 21
# VAE bursts).  Tops are read beside phase 11b's host explorers and the
# reference's 10-round means, not gated.
FUSED_RUN = dict(rounds=10, sequences_batch_size=100, model_queries_per_batch=2000)
FUSED_CBAS_ROUNDS = 2
# (b) GPR_BO over all 65,536 8-mers of SIX6_REF_R1, 10 rounds x 100.
GPR_BO_FUSED_ROUNDS = 10
# The VAE's CUDA-graph steps are held bitwise to eager ones on a DbAS run of
# one cycle a round (two training bursts), 2 rounds.
GRAPH_CHECK_QUERIES = 100
# (c) GA and BO over NAM 0.9 on L100_RNA1 from start 1, 10 x 100 x 2000:
# duplex launches and top true_score, pinned from their first run on an H100.
FUSED_L100_PINS = {"ga": (2949, 0.632479), "bo": (111, 0.584328)}
# (d) Sweeps: GA over 4 TF-Bind landscapes x ss {0.5, 0.9} x seeds {0, 1} in
# one lockstep chunk of 16 cells, and BO over L100_RNA1's starts 1-3.  The GA
# sweep is cut in depth to 1 round: on the 4^8 space its population runs
# out of novel children, so a round runs many generations (a host sync
# each), and 10 rounds took 252 s for the chunk on an H100, 2 rounds 57 s
# with its two standalone runs (PERF.md, Cells).
FUSED_SWEEP_LANDSCAPES, FUSED_SWEEP_SS, FUSED_SWEEP_SEEDS = 4, (0.5, 0.9), (0, 1)
FUSED_GA_SWEEP_ROUNDS = 1
FUSED_RNA_SWEEP_STARTS = (1, 2, 3)
# Phase 13: the fused RL runners.  (a) The paper's fused RL rows on 3MSI
# (scripts/run_paper_table.py:175-240): a perfect model of RosettaFolding
# 3msi, start ed_3_wt, seed 0, 100 x 2000.  DQN, PPO and the mutative
# runner are cut in rounds to keep the phase near 150 s: their step loops
# are host-bound (a DQN or PPO step per model query, 2,000 a round), and
# phase 13 took 239 s in the whole script at 2, 2, 4 and 5 rounds before
# DynaPPO's episodes became CUDA graphs (PERF.md, Cells).  Tops are
# readings beside phase 11b's host runs and the reference's DynaPPO row.
RL_RUN = dict(sequences_batch_size=100, model_queries_per_batch=2000)
RL_RUN_ROUNDS = {"dqn": 1, "ppo": 1, "dynappo": 10, "dynappo_mutative": 3}
# The PPO update of 13a's 3MSI run on the card vs the same update on the CPU
# from the card's inputs: the parameters' distance, relative to the
# update's own size (10 Adam steps; a gradient entry near 0 may take
# either sign on the two devices, so no elementwise bound), and the
# observation statistics (Welford sums in another order).
PPO_TRAIN_RTOL, PPO_STATS_RTOL = 1e-4, 1e-5
# The last DQN burst of 13a's 3MSI run (20 Adam steps on samples drawn on
# the card) replayed on the CPU from the card's inputs and the card's
# draws: the weights' distance, relative to the weights' norm.
DQN_BURST_RTOL = 1e-4
# (b) PPO and DynaPPO over NAM 0.9 on L100_RNA1 from start 1, 100 x 2000,
# cut to 2 rounds and 1; duplex launches, top and the last round's mean
# true_score pinned from their first run on an H100.  No proposal beats
# the start (0.579332) in these rounds, so the top pins nothing; the last
# round's mean reads proposals of a policy after PPO updates (PPO's one
# update a round, DynaPPO's one a batch).
RL_L100_ROUNDS = {"ppo": 2, "dynappo": 1}
RL_L100_PINS = {"ppo": (6531, 0.579332, 0.442182), "dynappo": (134, 0.579332, 0.236061)}
# (c) The density on the card vs the CPU: a seeded pool at 3MSI's width.
DENSITY_POOL, DENSITY_QUERIES, DENSITY_RTOL = 2048, 16, 1e-6
# (d) Sweeps: DynaPPO over 4 TF-Bind landscapes x ss {0.5, 0.9} x seeds
# {0, 1} in one lockstep chunk of 16 cells, DQN over L100_RNA1's starts
# 1-3, each cut in rounds.  DQN runs 2 so that its walk, replay ring and
# schedule carry across a round; its duplex launches are pinned from its
# first run on an H100.
RL_SWEEP_ROUNDS = {"dynappo": 2, "dqn": 2}
RL_DQN_SWEEP_LAUNCHES = 4003

# Phase 14, the infrastructure modules.  (a, d) A 4-cell TF-Bind GA grid
# (SIX6_REF_R1 x 2 starts x ss 0.9 x seeds {0, 1}, 2 rounds of 100
# proposals; model queries cut from 2,000 to 500 a round: on the 4^8
# space GA runs out of novel children, and a round takes many
# generations) through the CLI without a mesh, on a one-rank mesh with
# checkpoints (twice: the rerun resumes) and over two torchrun ranks that
# share the card; the CLI's fast path as a program (SIX6_REF_R1, 1 start,
# 2 rounds, 100 x 2000).
INFRA_GA_GRID = ["--landscapes", "SIX6_REF_R1", "--starts", "2", "--signal-strengths", "0.9",
                 "--seeds", "0", "1", "--rounds", "2", "--batch", "100", "--queries", "500",
                 "--algorithm", "ga"]
INFRA_FAST_PATH = ["--landscapes", "SIX6_REF_R1", "--starts", "1", "--signal-strengths", "0.9",
                   "--rounds", "2", "--batch", "100", "--queries", "2000"]
INFRA_SUBPROCESS_TIMEOUT_S = 300
# (b) A CNN at 3MSI's width (66 x 20, 32 filters, hidden 100) fit twice on
# 512 seeded rows, against a fit stopped after its first call, saved,
# loaded into another model and resumed; then host Adalead + NAM 0.9 on
# L100_RNA1 from start 1 (100 x 2000), 2 rounds resumed to 3.
INFRA_FIT_ROWS, INFRA_FIT_EPOCHS = 512, 2
INFRA_RESUME_ROUNDS = (2, 3)
# (e) The native library against the card: Rosetta 3msi on 1,024 seeded
# rows and the wild type, the duplex DP on 100 seeded L100_RNA1 rows.
NATIVE_ROSETTA_ROWS, NATIVE_DUPLEX_ROWS = 1024, 100
NATIVE_ROSETTA_TOL = dict(rtol=1e-4, atol=1e-5)
NATIVE_DUPLEX_TOL = dict(rtol=1e-4, atol=1e-3)
# Phase 15: the bench's stages, small.  The RNA oracle stage at B=100 with 5
# calls a reading launches the kernel once for its check batch and 3 x (1 +
# 5) times for its readings; the 3-CNN CMA-ES bench runs 1 round from one
# start on one landscape.
BENCH_ORACLE_BATCH, BENCH_ORACLE_REPS = 100, 5
BENCH_ORACLE_LAUNCHES = 1 + 3 * (1 + BENCH_ORACLE_REPS)
BENCH_CMAES = dict(rounds=1, landscapes=("SIX6_REF_R1",), starts_n=1)
BENCH_CMAES_KEYS = ["bench", "rounds", "runs", "mean_max", "s_per_run", "s", "card"]
# Phase 16: the paper table and the north-star grid, small.  The table's fused
# CMA-ES and host Random rows from 3MSI's first start for 1 round; the grid's
# Random and Adalead families over 8 TF-Bind landscapes, 1 round, one chunk.
PAPER_TABLE_SMOKE = ["--explorers", "device-cmaes", "random", "--starts", "1", "--rounds", "1"]
PAPER_ROW_KEYS = ["explorer", "starts", "start_offset", "rounds", "maxes", "mean", "best",
                  "reference", "wall_s", "card"]
NORTHSTAR_SMOKE = ["--families", "random", "adalead", "--landscapes", "8", "--rounds", "1",
                   "--chunk", "8"]
NORTHSTAR_FAMILY_KEYS = ["family", "signal_strengths", "cells", "wall_s", "seqs", "seqs_per_sec",
                         "mean_max_fitness", "min_max_fitness", "card"]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


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

    def fused(rounds):
        cost = land.cost
        runner = flexs.runtime.DeviceAdaleadNAM(land, flexs.RNAA, starting_sequence=starts[0],
                                                seed=0, **{**nam_kw, "rounds": rounds})
        (df, _), wall = timed(lambda: runner.run(verbose=False))
        return df, wall, land.cost - cost

    steps.append(("c fused", time.perf_counter()))
    df, wall, landscape_cost = fused(PHASE6_RUN["rounds"])
    steps.append(("c profiled run and trace", time.perf_counter()))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        df_again, profiled_wall, _ = fused(FOLD_PROFILED_ROUNDS)
    steps.append(("c device totals", time.perf_counter()))
    kernels = device_kernels(prof)
    steps.append(("c checks", time.perf_counter()))
    device_s = sum(e.self_device_time_total for e in kernels) / 1e6
    pd.testing.assert_frame_equal(df[df["round"] <= FOLD_PROFILED_ROUNDS], df_again)
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
        "profiled_rounds": FOLD_PROFILED_ROUNDS, "profiled_wall_s": profiled_wall,
        "kernel_launches": sum(e.count for e in kernels),
        "device_kernel_s": device_s, "device_idle_share_vs_profiled_wall": 1 - device_s
        / profiled_wall, "top_kernels": [{"name": e.key[:80], "count": e.count,
                                          "device_s": e.self_device_time_total / 1e6}
                                         for e in kernels[:6]],
    }
    print(f"rnafolding fused run (L100_RNA1 start 1, NAM 0.9, 10 x 100 x 2000): "
          f"{json.dumps(fused_reading)}; the profiled run's frame is the full run's first "
          f"{FOLD_PROFILED_ROUNDS} rounds and true_score == get_fitness [{card}]")

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
    fused_run = {**PHASE6_RUN, "rounds": GFP_FUSED_ROUNDS}
    rounds, batch, budget = (
        fused_run[k] for k in ("rounds", "sequences_batch_size", "model_queries_per_batch"))

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
            **fused_run)
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
    print(f"gfp fused run (ed_10_wt, NAM 0.9, {rounds} x 100 x 2000, under the profiler): "
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
    # d. A generic sweep over GFP_SWEEP_STARTS of the 3 starts (cut since
    # phases 12 and 14 came, PERF.md, Cells), "map": in lockstep every step
    # scores all cells' rows, which costs the oracle-bound GFP run about 3x
    # (194 s for 3 cells at 2 rounds on an H100, PERF.md).
    torch.cuda.reset_peak_memory_stats()
    sweep, sweep_wall = timed(lambda: run_landscape_robustness_sweep(
        [land], flexs.AAS, starts[:GFP_SWEEP_STARTS], [0.9], seeds=[0],
        rounds=GFP_SWEEP_ROUNDS, sequences_batch_size=batch, model_queries_per_batch=budget,
        cell_mode="map"))
    assert len(sweep) == GFP_SWEEP_STARTS
    assert (sweep["max_fitness"] >= sweep["start_fitness"]).all()
    scored = int(sweep["model_cost"].sum() + sweep["landscape_cost"].sum())
    sweep_reading = {"cells": len(sweep), "rounds": GFP_SWEEP_ROUNDS, "wall_s": sweep_wall,
                     "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                     "sequences_scored_per_s": scored / sweep_wall,
                     "max_fitness": sweep["max_fitness"].tolist()}
    print(f"gfp generic sweep (map, {GFP_SWEEP_STARTS} starts): {json.dumps(sweep_reading)} "
          f"[{card}]")
    no_duplex_launches(cuda_duplex, "9")
    steps.append(("end", time.perf_counter()))
    walls = step_walls(steps)
    print(f"phase 9 step walls (s): {json.dumps(walls)}")
    return {"shape": shape, "card_vs_cpu_max_abs_diff": oracle_diff, "fused": fused_reading,
            "host_wall_s": host_wall, "host_top": host_top, "sweep": sweep_reading,
            "step_walls_s": walls}


def _mutants(rng, tokens, n: int, letters: int = 4) -> np.ndarray:
    """n copies of random rows of `tokens`, each with 1-3 random positions redrawn."""
    out = tokens[rng.integers(0, len(tokens), n)].copy()
    for row in out:
        pos = rng.choice(out.shape[1], rng.integers(1, 4), replace=False)
        row[pos] = rng.integers(0, letters, len(pos))
    return out


def regressors_card_vs_cpu(flexs, land, card: str) -> dict:
    """Phase 10a: each regressor fitted and queried on the card and on the CPU."""
    from flexs_tpu_torch.baselines.explorers.dyna_ppo import tpu_native_default_models

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
        built = [m for m in tpu_native_default_models(length, flexs.RNAA, dev)
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

    from flexs_tpu_torch.baselines.explorers.dyna_ppo import tpu_native_default_models
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
    members = tpu_native_default_models(len(starts[0]), flexs.RNAA)
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


def _carry(t):
    """A tensor, or a tuple/state of tensors, copied to the card."""
    if isinstance(t, torch.Tensor):
        return t.cuda()
    if hasattr(t, "_fields"):
        return type(t)(*(_carry(x) for x in t))
    return t


def close(name: str, card_value, cpu_value, tolerance: float) -> float:
    """max |card - cpu| of two arrays or tensors.

    Raises unless both are finite, of one shape, and |card - cpu| <=
    tolerance * (1 + |cpu|) everywhere (`np.allclose` with rtol = atol =
    tolerance, as the CPU tests hold the port to the JAX package).
    """
    a = card_value.detach().cpu().numpy() if hasattr(card_value, "detach") else card_value
    b = cpu_value.detach().cpu().numpy() if hasattr(cpu_value, "detach") else cpu_value
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape and np.isfinite(a).all(), (name, a.shape, b.shape)
    diff = float(np.abs(a - b).max())
    assert np.allclose(a, b, rtol=tolerance, atol=tolerance), (
        f"{name}: card vs CPU max |diff| {diff} beyond rtol = atol = {tolerance}")
    return diff


def explorer_components_card_vs_cpu(flexs, card: str) -> dict:
    """Phase 11a: the explorers' components on the card against the CPU at 3MSI's width."""
    from flexs_tpu_torch.baselines.explorers.environments.dyna_ppo import DynaPPOEnvironment
    from flexs_tpu_torch.landscapes import rosetta
    from flexs_tpu_torch.ops import cmaes
    from flexs_tpu_torch.rl import PPOAgent
    from flexs_tpu_torch.utils.vae import VAE

    rng = np.random.default_rng(SEED)
    alphabet = flexs.Alphabet(flexs.AAS)
    start = list(rosetta.registry()["3msi"]["starts"].values())[0]
    length, letters = len(start), len(alphabet)
    dim = length * letters
    diffs = {}

    # CMA-ES: a tell from init, then one that refreshes the eigenbasis.
    popsize = 15
    gap = cmaes.lazy_gap(dim, popsize)
    state = cmaes.init(rng.normal(size=dim).astype(np.float32), 0.45, device="cpu")
    for k, count in enumerate((0, gap - 1)):
        state = state._replace(count=count)
        sols = rng.normal(size=(popsize, dim)).astype(np.float32)
        fits = rng.random(popsize).astype(np.float32)
        on_card = cmaes.tell_numpy(_carry(state), sols, fits)
        state = cmaes.tell_numpy(state, sols, fits)
        for name in ("mean", "sigma", "cov"):
            diffs[f"cmaes_tell{k}_{name}"] = close(
                name, getattr(on_card, name), getattr(state, name), CMAES_TOLERANCE)
        diffs[f"cmaes_tell{k}_basis"] = close("basis", cmaes.covariance(on_card),
                                              cmaes.covariance(state), CMAES_TOLERANCE)

    # The VAE: trained one epoch on the CPU, its weights carried to the card.
    seqs = alphabet.decode(rng.integers(0, letters, (120, length)))
    vae_cpu = VAE(length, flexs.AAS, intermediate_dim=250, epochs=1, verbose=False, seed=0,
                  device="cpu")
    vae_cpu.train_model(seqs, np.ones(len(seqs)))
    vae_card = VAE(length, flexs.AAS, intermediate_dim=250, verbose=False, seed=0)
    vae_card.set_weights({k: v.cuda() for k, v in vae_cpu.get_weights().items()})
    z = rng.standard_normal((16, 2)).astype(np.float32)
    diffs["vae_decode"] = close("decode", vae_card.decode_numpy(z), vae_cpu.decode_numpy(z),
                                COMPONENT_TOLERANCE)
    diffs["vae_log_probability"] = close(
        "log probability", vae_card.calculate_log_probability(seqs[:64]),
        vae_cpu.calculate_log_probability(seqs[:64]), COMPONENT_TOLERANCE)
    # Training on the card: CUDA-graph steps equal eager ones bitwise.
    graphed, eager = (VAE(length, flexs.AAS, intermediate_dim=250, epochs=2, verbose=False,
                          seed=0) for _ in range(2))
    eager.cuda_graph = False
    for vae in (graphed, eager):
        vae.train_model(seqs, np.linspace(0.5, 1.0, len(seqs)))
    for (name, a), b in zip(graphed.get_weights().items(), eager.get_weights().values()):
        assert torch.equal(a, b), f"VAE {name}: graphed training differs from eager"
    diffs["vae_graphed_vs_eager_training"] = 0.0

    # The Q network: all-action Q, then one training call on the same batches.
    dqns = {}
    for dev in ("cpu", "cuda"):
        dqns[dev] = flexs.baselines.explorers.DQN(
            None, rounds=1, sequences_batch_size=16, model_queries_per_batch=16,
            starting_sequence=start, alphabet=flexs.AAS, train_epochs=5, seed=0, device=dev)
        dqns[dev].initialize_data_structures()
    dqns["cuda"].q_network.load_state_dict(dqns["cpu"].q_network.state_dict())
    eye = np.eye(letters, dtype=np.float32)
    states = eye[rng.integers(0, letters, (4, length))].reshape(4, -1)
    diffs["dqn_all_action_q"] = close("all-action Q", dqns["cuda"].all_action_q(states),
                                      dqns["cpu"].all_action_q(states), COMPONENT_TOLERANCE)
    obs = eye[rng.integers(0, letters, (5, 16, length))].reshape(5, 16, -1)
    nxt = eye[rng.integers(0, letters, (5, 16, length))].reshape(5, 16, -1)
    batch = (obs, nxt * (1 - obs), rng.random((5, 16)).astype(np.float32), nxt)
    for dqn in dqns.values():
        dqn._train(*(torch.as_tensor(a, device=dqn.device) for a in batch))
    diffs["dqn_train"] = close(
        "Q network after training", torch.nn.utils.parameters_to_vector(
            dqns["cuda"].q_network.parameters()),
        torch.nn.utils.parameters_to_vector(dqns["cpu"].q_network.parameters()),
        COMPONENT_TRAIN_TOLERANCE)

    # The actor-critic of DynaPPO at 3MSI: obs 66 x 21, 20 actions.
    obs_dim = length * (letters + 1)
    agents = {dev: PPOAgent(obs_dim, letters, seed=0, device=dev) for dev in ("cpu", "cuda")}
    agents["cuda"].net.load_state_dict(agents["cpu"].net.state_dict())
    x = rng.random((64, obs_dim)).astype(np.float32)
    with torch.no_grad():
        (lc, vc), (lg, vg) = agents["cpu"].net(torch.tensor(x)), agents["cuda"].net(
            torch.tensor(x).cuda())
    diffs["actor_critic_logits"] = close("logits", lg, lc, COMPONENT_TOLERANCE)
    diffs["actor_critic_values"] = close("values", vg, vc, COMPONENT_TOLERANCE)
    t = length * 16
    ppo_batch = {
        "obs": rng.random((t, obs_dim)).astype(np.float32),
        "actions": rng.integers(0, letters, t), "logprobs": np.full(t, -np.log(letters)),
        "rewards": rng.random(t), "dones": np.arange(t) % length == length - 1,
        "values": rng.random(t), "masks": rng.random((t, letters)) < 0.9,
    }
    ppo_batch["masks"][np.arange(t), ppo_batch["actions"]] = True
    losses = [agents[dev].train(ppo_batch) for dev in ("cuda", "cpu")]
    diffs["ppo_train_loss"] = close("PPO loss", np.array(losses[:1]), np.array(losses[1:]),
                                    COMPONENT_TRAIN_TOLERANCE)
    diffs["ppo_train"] = close(
        "actor-critic after training",
        torch.nn.utils.parameters_to_vector(agents["cuda"].net.parameters()),
        torch.nn.utils.parameters_to_vector(agents["cpu"].net.parameters()),
        COMPONENT_TRAIN_TOLERANCE)

    # The DynaPPO density: 2,000 cached neighbours of the start, 16 queries.
    base = alphabet.encode_one(start)
    cache = _mutants(rng, base[None], 2000, letters)
    queries = alphabet.decode(_mutants(rng, base[None], 16, letters))
    fitness = rng.random(len(cache))
    densities = {}
    for dev in ("cpu", "cuda"):
        env = DynaPPOEnvironment(flexs.AAS, length, None, None, 16, device=dev)
        env._density.update(alphabet.decode(cache), fitness)
        densities[dev] = env._density.densities(queries)
    assert np.array_equal(densities["cuda"], densities["cpu"]), "densities differ"
    assert (densities["cpu"] > 0).any()
    diffs["dynappo_density"] = 0.0
    print(f"explorer components card vs CPU (3MSI width: n = {dim} for CMA-ES, VAE 250, "
          f"fc 128): {json.dumps(diffs)}; the density bitwise [{card}]")
    return diffs


def check_explorer_frame(df, landscape, rounds: int, batch: int, start: str) -> None:
    """A host explorer's frame: its rounds, row counts, costs, and true scores from the oracle."""
    cols = ["sequence", "model_score", "true_score", "round", "model_cost",
            "measurement_cost"]
    assert list(df.columns) == cols, list(df.columns)
    assert df["round"].max() == rounds
    r0 = df[df["round"] == 0]
    assert len(r0) == 1 and r0["sequence"].iloc[0] == start
    for r in range(1, rounds + 1):
        assert 0 < len(df[df["round"] == r]) <= batch, r
    for col in ("model_cost", "measurement_cost"):
        assert df.groupby("round")[col].first().is_monotonic_increasing, col
    assert df["measurement_cost"].iloc[-1] == len(df)
    truth = landscape.get_fitness(df["sequence"].tolist())
    diff = float(np.abs(df["true_score"].to_numpy() - truth).max())
    assert diff <= 1e-6, diff


def host_run(explorer, landscape, rounds: int, start: str):
    """(frame, wall s, top) of one explorer run, its frame checked."""
    (df, _), wall = timed(lambda: explorer.run(landscape, verbose=False))
    check_explorer_frame(df, landscape, rounds, EXPLORER_RUN["sequences_batch_size"], start)
    return df, wall, float(df["true_score"].max())


def profile_acts(agent, first: int, count: int) -> dict:
    """Count `agent.act`'s calls, and profile the card over calls first .. first + count - 1.

    The returned dict holds "calls", and once the window has closed the
    finished profiler ("prof") and the window's wall ("wall_s").
    """
    from torch.profiler import ProfilerActivity, profile

    window = {"calls": 0}
    original = agent.act

    def act(*args, **kwargs):
        if window["calls"] == first:
            torch.cuda.synchronize()
            window["prof"] = profile(activities=[ProfilerActivity.CUDA])
            window["prof"].start()
            window["t0"] = time.perf_counter()
        out = original(*args, **kwargs)  # numpy arrays: the call has synchronized
        window["calls"] += 1
        if window["calls"] == first + count:
            window["wall_s"] = time.perf_counter() - window["t0"]
            window["prof"].stop()
        return out
    agent.act = act
    return window


def explorer_phases(flexs, cuda_duplex, card: str) -> dict:
    """Phase 11 (a-d): the host explorers on the card."""
    from flexs_tpu_torch import run_paper_table
    from flexs_tpu_torch.landscapes import rna, rosetta, tf_binding
    from flexs_tpu_torch.profile_main_path import device_kernels

    steps = [("a components", time.perf_counter())]
    cuda_duplex.reset_launch_counts()
    components = explorer_components_card_vs_cpu(flexs, card)

    # b. The paper's 3MSI row: a perfect model of the landscape (DynaPPO's
    # two run on the landscape with their default 11-member ensemble).
    problem = rosetta.registry()["3msi"]
    start = list(problem["starts"].values())[0]
    rounds = EXPLORER_RUN["rounds"]
    paper = {}
    for name in PAPER_EXPLORERS:
        steps.append((f"b {name}", time.perf_counter()))
        land = rosetta.RosettaFolding(**problem["params"])
        model = flexs.LandscapeAsModel(land)
        run = {**EXPLORER_RUN, **PAPER_RUN_CUTS.get(name, {})}
        explorer = run_paper_table.make(name, model, land, start, alphabet=flexs.AAS, **run)
        reading = {}
        if name == "dynappo":
            # Its cost is host round trips: count the agent's act calls and
            # read the device's busy share over a steady window of them.
            window = profile_acts(explorer.agent, *DYNAPPO_PROFILED_ACTS)
            df, wall, top = host_run(explorer, land, rounds, start)
            kernels = device_kernels(window["prof"])
            device_s = sum(e.self_device_time_total for e in kernels) / 1e6
            reading.update(act_calls=window["calls"], profiled_acts=DYNAPPO_PROFILED_ACTS,
                           window_wall_s=window["wall_s"], window_device_kernel_s=device_s,
                           window_device_idle_share=1 - device_s / window["wall_s"],
                           window_kernel_launches=sum(e.count for e in kernels))
        else:
            df, wall, top = host_run(explorer, land, rounds, start)
        reading.update(wall_s=wall, top=top, rows=len(df),
                       model_cost=int(df["model_cost"].iloc[-1]),
                       reference_10_round_mean=run_paper_table.REFERENCE[name][0])
        paper[name] = reading
        print(f"3msi {name} ({rounds} rounds, start {start[:8]}..): "
              f"{json.dumps(reading)} [{card}]")
    no_duplex_launches(cuda_duplex, "11a-b")

    # c. GPR_BO Thompson over all 65,536 8-mers of SIX6_REF_R1.
    steps.append(("c gpr_bo", time.perf_counter()))
    tf_problem = tf_binding.registry()["SIX6_REF_R1"]
    tf_land = tf_binding.TFBinding(**tf_problem["params"])
    cnns = [flexs.baselines.models.CNN(8, 32, 100, flexs.DNAA, seed=s) for s in range(3)]
    ensemble = flexs.Ensemble(cnns, combine_with=lambda x: x)
    gpr = flexs.baselines.explorers.GPR_BO(
        ensemble, **{**EXPLORER_RUN, "rounds": GPR_BO_ROUNDS},
        starting_sequence=tf_problem["starts"][0], alphabet=flexs.DNAA,
        seq_proposal_method="Thompson", seed=0)
    cuda_duplex.reset_launch_counts()
    df_gpr, gpr_wall, gpr_top = host_run(gpr, tf_land, GPR_BO_ROUNDS, tf_problem["starts"][0])
    no_duplex_launches(cuda_duplex, "11c")
    costs = df_gpr.groupby("round")["model_cost"].first().to_numpy()
    assert (np.diff(costs) == 4**8).all(), costs
    gpr_reading = {"wall_s": gpr_wall, "top": gpr_top, "rows": len(df_gpr),
                   "model_cost_per_round": 4**8}
    print(f"gpr_bo Thompson (SIX6_REF_R1, {GPR_BO_ROUNDS} rounds, 3 CNNs): "
          f"{json.dumps(gpr_reading)} [{card}]")

    # d. The kernel's path: BO over NAM and DynaPPO on L100_RNA1 from start 1.
    reg = rna.registry()
    l100_start = reg["L100_RNA1"]["starts"][1]
    l100 = {}
    for name, n_rounds, pins in (("bo", L100_BO_ROUNDS, (L100_BO_LAUNCHES, L100_BO_TOP)),
                                 ("dynappo", L100_DYNAPPO_ROUNDS,
                                  (L100_DYNAPPO_LAUNCHES, L100_DYNAPPO_TOP))):
        steps.append((f"d {name}", time.perf_counter()))
        land = rna.RNABinding(**reg["L100_RNA1"]["params"])
        model = flexs.baselines.models.NoisyAbstractModel(land, 0.9, seed=0)
        run = {**EXPLORER_RUN, "rounds": n_rounds}
        explorer = run_paper_table.make(name, model, land, l100_start, alphabet=flexs.RNAA,
                                         **run)
        cuda_duplex.reset_launch_counts()
        (df, _), wall = timed(lambda: explorer.run(land, verbose=False))
        launches = path_launches(cuda_duplex, f"L100_RNA1 {name}")
        check_explorer_frame(df, land, n_rounds, EXPLORER_RUN["sequences_batch_size"], l100_start)
        top = float(df["true_score"].max())
        reading = {"wall_s": wall, "top": top, "rows": len(df), "duplex_launches": launches}
        l100[name] = reading
        print(f"L100_RNA1 {name} ({n_rounds} rounds, start 1): {json.dumps(reading)} "
              f"[{card}]")
        assert launches == pins[0], (name, launches)
        assert round(top, 6) == pins[1], (name, top)
    steps.append(("end", time.perf_counter()))
    walls = step_walls(steps)
    print(f"phase 11 step walls (s): {json.dumps(walls)}")
    return {"components": components, "paper_3msi": paper, "gpr_bo": gpr_reading,
            "l100": l100, "step_walls_s": walls}


def check_fused_frame(df, landscape, rounds: int, batch: int, start: str, unique: bool) -> None:
    """A fused runner's frame: its rounds and row counts, costs, and true_score == get_fitness.

    `true_score` must equal `get_fitness` exactly on each round's rows
    scored as one batch: the runner scores a round's proposals as one
    batch, and on the card the order of a Rosetta row sum depends on the
    batch's shape (scored as one batch of the whole frame, 3MSI's rows
    move by one ulp).  `unique`: no sequence measured twice (Random's
    uniform sample, CMA-ES's and BO's pools may repeat a measured
    sequence, and CbAS's round 1 the start, as in the JAX package).
    """
    check_explorer_frame(df, landscape, rounds, batch, start)
    assert np.isnan(df["model_score"].iloc[0])
    if unique:
        assert df["sequence"].is_unique, "a sequence was measured twice"
    truth = np.concatenate([
        landscape.get_fitness(df[df["round"] == r]["sequence"].tolist())
        for r in range(rounds + 1)
    ])
    assert np.array_equal(df["true_score"].to_numpy(), truth), float(
        np.abs(df["true_score"].to_numpy() - truth).max())


def fused_run(runner, landscape):
    """(frame, reading) of one fused run: wall, queries/s, host syncs, top, rows."""
    from flexs_tpu_torch.runtime import jit_runner

    cost = landscape.cost
    jit_runner.reset_run_counts()
    (df, _), wall = timed(lambda: runner.run(verbose=False))
    queries = int(df["model_cost"].iloc[-1]) + landscape.cost - cost
    return df, {"wall_s": wall, "queries_per_s": queries / wall,
                "host_syncs": jit_runner.run_counts["syncs"],
                "draw_calls": jit_runner.run_counts["draw_calls"],
                "top": float(df["true_score"].max()), "rows": len(df),
                "model_cost": int(df["model_cost"].iloc[-1])}


def same_as_alone(row, land, cls, alphabet, run) -> None:
    """A sweep's summary row equals the standalone run of `cls` with the row's cell."""
    cost = land.cost
    single, _ = cls(land, alphabet, starting_sequence=row["start"], seed=int(row["seed"]),
                    signal_strength=float(row["signal_strength"]), **run).run(verbose=False)
    assert row["max_fitness"] == single["true_score"].max(), row
    assert row["model_cost"] == single["model_cost"].iloc[-1], row
    assert row["landscape_cost"] == land.cost - cost, row


def fused_runner_phases(flexs, cuda_duplex, card: str, host_tops: dict) -> dict:
    """Phase 12 (a-d): the fused runners of the non-RL explorers on the card."""
    import pandas as pd
    from flexs_tpu_torch import run_paper_table, runtime
    from flexs_tpu_torch.landscapes import rna, rosetta, tf_binding
    from flexs_tpu_torch.parallel import run_landscape_robustness_sweep, run_robustness_sweep
    from flexs_tpu_torch.runtime import jit_runner

    steps = [("a 3msi", time.perf_counter())]
    # a. The paper's fused 3MSI rows over a perfect model.
    problem = rosetta.registry()["3msi"]
    start = problem["starts"]["ed_3_wt"]
    paper = {}
    for name, cls, kw, host_name in (
        ("random", runtime.DeviceRandomNAM, dict(elitist=False), "random"),
        ("ga", runtime.DeviceGeneticAlgorithmNAM, {}, "genetic"),
        ("cmaes", runtime.DeviceCMAESNAM, dict(maximize=True), "cmaes"),
        ("bo", runtime.DeviceBONAM, {}, "bo"),
        ("cbas", runtime.DeviceCbASNAM, dict(algo="cbas"), "cbas"),
        ("dbas", runtime.DeviceCbASNAM, dict(algo="dbas"), "dbas"),
    ):
        steps.append((f"a {name}", time.perf_counter()))
        run = {**FUSED_RUN, "rounds": FUSED_CBAS_ROUNDS} if cls is runtime.DeviceCbASNAM \
            else FUSED_RUN
        land = rosetta.RosettaFolding(**problem["params"])
        runner = cls(land, flexs.AAS, starting_sequence=start, model="perfect", seed=0,
                     **run, **kw)
        cuda_duplex.reset_launch_counts()
        df, reading = fused_run(runner, land)
        no_duplex_launches(cuda_duplex, f"12a {name}")
        assert df["measurement_cost"].iloc[-1] == len(df) == land.cost
        check_fused_frame(df, land, run["rounds"], run["sequences_batch_size"], start,
                          unique=name == "ga")
        reading.update(rounds=run["rounds"], host_top_2_rounds=host_tops[host_name]["top"],
                       reference_10_round_mean=run_paper_table.REFERENCE[host_name][0])
        paper[name] = reading
        print(f"fused 3msi {name} ({run['rounds']} rounds, perfect model): "
              f"{json.dumps(reading)} [{card}]")

    # The VAE steps as CUDA-graph replays equal eager ones (DbAS, one cycle a round).
    steps.append(("a graph vs eager", time.perf_counter()))
    land = rosetta.RosettaFolding(**problem["params"])
    cfg = runtime.AdaleadConfig(
        rounds=FUSED_CBAS_ROUNDS, sequences_batch_size=FUSED_RUN["sequences_batch_size"],
        model_queries_per_batch=GRAPH_CHECK_QUERIES, alphabet_size=20, perfect_model=True)
    tokens = torch.as_tensor(flexs.Alphabet(flexs.AAS).encode_one(start), device=land.device)
    graph_walls = {}
    results = []
    for graph in (True, False):
        gen = torch.Generator(device=land.device)
        gen.manual_seed(0)
        res, graph_walls[graph] = timed(lambda: runtime.cbas_runner.run_cbas_nam(
            *land.device_fitness(), tokens, cfg, 1.0, gen, algo="dbas", cuda_graph=graph))
        results.append(res)
    for name, a, b in zip(results[0]._fields, *results):
        assert torch.equal(a, b), f"graphed DbAS != eager in {name}"
    paper["dbas"]["graph_vs_eager_one_cycle_s"] = [graph_walls[True], graph_walls[False]]
    print(f"fused dbas, one cycle a round: CUDA-graph VAE steps == eager bitwise; walls "
          f"{graph_walls[True]} s graphed, {graph_walls[False]} s eager [{card}]")

    # b. GPR_BO over the whole TF-Bind-8 space.
    steps.append(("b gpr_bo", time.perf_counter()))
    tf_problem = tf_binding.registry()["SIX6_REF_R1"]
    tf_start = tf_problem["starts"][0]
    gpr = {}
    frames = {}
    for label, model, device in (("nam_thompson", "nam", None), ("perfect", "perfect", None),
                                 ("perfect_cpu", "perfect", "cpu")):
        land = tf_binding.TFBinding(**tf_problem["params"], device=device)
        runner = runtime.DeviceGPRBONAM(
            land, flexs.DNAA, rounds=GPR_BO_FUSED_ROUNDS, sequences_batch_size=100,
            model_queries_per_batch=2000, starting_sequence=tf_start, model=model,
            signal_strength=0.9, seed=0, device=device)
        cuda_duplex.reset_launch_counts()
        df, reading = fused_run(runner, land)
        no_duplex_launches(cuda_duplex, f"12b {label}")
        check_fused_frame(df, land, GPR_BO_FUSED_ROUNDS, 100, tf_start, unique=True)
        costs = df.groupby("round")["model_cost"].first().to_numpy()
        assert (np.diff(costs) == 4**8).all() and costs[1] == 4**8, costs
        frames[label], gpr[label] = df, reading
        print(f"fused gpr_bo {label} (SIX6_REF_R1, {GPR_BO_FUSED_ROUNDS} rounds): "
              f"{json.dumps(reading)} [{card}]")
    table = tf_binding.TFBinding(**tf_problem["params"], device="cpu").table.numpy()
    order = np.argsort(-table, kind="stable")
    start_idx = int(flexs.Alphabet(flexs.DNAA).encode_one(tf_start) @ (4 ** np.arange(7, -1, -1)))
    want = table[order[order != start_idx][:100]]
    got = frames["perfect"][frames["perfect"]["round"] == 1]["true_score"].to_numpy()
    assert np.array_equal(got, want.astype(np.float64)), "round 1 is not the table's top 100"
    pd.testing.assert_frame_equal(frames["perfect"], frames["perfect_cpu"])
    print("fused gpr_bo perfect: round 1 == the table's top 100 without the start; "
          f"card == CPU row for row [{card}]")

    # c. The kernel's path: GA and BO over NAM 0.9 on L100_RNA1, twice each.
    reg = rna.registry()
    l100_start = reg["L100_RNA1"]["starts"][1]
    l100 = {}
    for name, cls in (("ga", runtime.DeviceGeneticAlgorithmNAM), ("bo", runtime.DeviceBONAM)):
        steps.append((f"c {name}", time.perf_counter()))
        runs = []
        for _ in range(2):
            land = rna.RNABinding(**reg["L100_RNA1"]["params"])
            runner = cls(land, flexs.RNAA, starting_sequence=l100_start, signal_strength=0.9,
                         seed=0, **FUSED_RUN)
            cuda_duplex.reset_launch_counts()
            df, reading = fused_run(runner, land)
            reading["duplex_launches"] = path_launches(cuda_duplex, f"fused L100_RNA1 {name}")
            check_fused_frame(df, land, FUSED_RUN["rounds"], 100, l100_start,
                              unique=name == "ga")
            runs.append((df, reading))
        pd.testing.assert_frame_equal(runs[0][0], runs[1][0])
        assert runs[0][1]["duplex_launches"] == runs[1][1]["duplex_launches"]
        reading = {**runs[0][1], "second_wall_s": runs[1][1]["wall_s"]}
        l100[name] = reading
        print(f"fused L100_RNA1 {name} (NAM 0.9, start 1, twice, identical frames): "
              f"{json.dumps(reading)} [{card}]")
        launches, top = FUSED_L100_PINS[name]
        assert reading["duplex_launches"] == launches, (name, reading["duplex_launches"])
        assert round(reading["top"], 6) == top, (name, reading["top"])

    # d. Sweeps: GA over TF-Bind in one lockstep chunk, BO over L100_RNA1's starts.
    steps.append(("d ga sweep", time.perf_counter()))
    names = list(tf_binding.registry())[:FUSED_SWEEP_LANDSCAPES]
    cuda_duplex.reset_launch_counts()
    ga_run = {**FUSED_RUN, "rounds": FUSED_GA_SWEEP_ROUNDS}
    jit_runner.reset_run_counts()
    ga_sweep, ga_wall = timed(lambda: run_robustness_sweep(
        names, [tf_start], signal_strengths=FUSED_SWEEP_SS, seeds=FUSED_SWEEP_SEEDS,
        algorithm="ga", **ga_run))
    ga_syncs = jit_runner.run_counts["syncs"]
    no_duplex_launches(cuda_duplex, "12d ga sweep")
    assert len(ga_sweep) == len(names) * len(FUSED_SWEEP_SS) * len(FUSED_SWEEP_SEEDS)
    assert (ga_sweep["max_fitness"] >= ga_sweep["start_fitness"]).all()

    for row in (ga_sweep.iloc[0], ga_sweep.iloc[-1]):
        same_as_alone(row, tf_binding.TFBinding(name=row["landscape"]),
                      runtime.DeviceGeneticAlgorithmNAM, flexs.DNAA, ga_run)
    steps.append(("d bo sweep", time.perf_counter()))
    starts = [reg["L100_RNA1"]["starts"][k] for k in FUSED_RNA_SWEEP_STARTS]
    land = rna.RNABinding(**reg["L100_RNA1"]["params"])
    cuda_duplex.reset_launch_counts()
    bo_sweep, bo_wall = timed(lambda: run_landscape_robustness_sweep(
        [land], flexs.RNAA, starts, signal_strengths=[0.9], seeds=[0], algorithm="bo",
        **FUSED_RUN))
    bo_launches = path_launches(cuda_duplex, "fused BO sweep")
    for row in (bo_sweep.iloc[0], bo_sweep.iloc[-1]):
        same_as_alone(row, rna.RNABinding(**reg["L100_RNA1"]["params"]), runtime.DeviceBONAM,
                      flexs.RNAA, FUSED_RUN)
    sweeps = {}
    for label, df, wall, rounds in (("ga_tf_bind", ga_sweep, ga_wall, FUSED_GA_SWEEP_ROUNDS),
                                    ("bo_l100", bo_sweep, bo_wall, FUSED_RUN["rounds"])):
        scored = int(df["model_cost"].sum() + df["landscape_cost"].sum())
        sweeps[label] = {"cells": len(df), "rounds": rounds, "wall_s": wall,
                         "s_per_cell": wall / len(df),
                         "sequences_scored_per_s": scored / wall,
                         "mean_max_fitness": float(df["max_fitness"].mean())}
    sweeps["ga_tf_bind"]["host_syncs"] = ga_syncs
    sweeps["bo_l100"]["duplex_launches"] = bo_launches
    print(f"fused sweeps (first and last cells == standalone runs): {json.dumps(sweeps)} "
          f"[{card}]")
    steps.append(("end", time.perf_counter()))
    walls = step_walls(steps)
    print(f"phase 12 step walls (s): {json.dumps(walls)}")
    return {"paper_3msi": paper, "gpr_bo": gpr, "l100": l100, "sweeps": sweeps,
            "step_walls_s": walls}


def density_card_vs_cpu(flexs, start: str) -> dict:
    """The DynaPPO densities on the card vs the CPU, on a seeded pool at 3MSI's width.

    Distances must be bitwise equal; the fitness-weighted sums within
    DENSITY_RTOL relative (the card's dot product adds in another order).
    """
    from flexs_tpu_torch.ops import packed_hamming
    from flexs_tpu_torch.ops.hamming import banded_edit_distance_matrix
    from flexs_tpu_torch.runtime import dyna_ppo_runner as dyna

    rng = np.random.default_rng(SEED)
    base = flexs.Alphabet(flexs.AAS).encode_one(start)
    pool = np.repeat(base[None], DENSITY_POOL, axis=0)
    for row in pool:
        pos = rng.choice(len(base), rng.integers(0, 5), replace=False)
        row[pos] = rng.integers(0, 20, len(pos))
    pool[1] = np.roll(base, 1)  # a block shift: Hamming far, Levenshtein 2
    queries = pool[rng.choice(DENSITY_POOL, DENSITY_QUERIES, replace=False)]
    queries[0] = base
    fit = rng.random(DENSITY_POOL).astype(np.float32)
    n_den = DENSITY_POOL - 5
    bits, per_word, _ = packed_hamming.packing_spec(len(base), 20)
    out = {}
    for metric in ("hamming", "edit"):
        got = {}
        for dev in ("cuda", "cpu"):
            q, p = torch.as_tensor(queries, device=dev), torch.as_tensor(pool, device=dev)
            f, n = torch.as_tensor(fit, device=dev), torch.tensor(n_den, device=dev)
            if metric == "edit":
                d = banded_edit_distance_matrix(q, p, band=2)
                dens = dyna._edit_density(q, p, f, n)
            else:
                qp, pp = packed_hamming.pack_tokens(q, 20), packed_hamming.pack_tokens(p, 20)
                d = packed_hamming.packed_hamming_matrix(qp, pp, bits, per_word)
                dens = dyna._hamming_density(qp, pp, f, n, bits, per_word)
            got[dev] = (d.cpu(), dens.cpu())
        assert torch.equal(got["cuda"][0], got["cpu"][0]), f"{metric} distances differ"
        card, cpu = got["cuda"][1], got["cpu"][1]
        assert (cpu > 0).sum() >= DENSITY_QUERIES // 2, cpu
        rel = float(((card - cpu).abs() / cpu.abs().clamp(min=1e-30)).max())
        assert rel <= DENSITY_RTOL, (metric, rel)
        out[metric] = {"max_rel_diff": rel, "bitwise": bool(torch.equal(card, cpu)),
                       "nonzero": int((cpu > 0).sum())}
    return out


@contextlib.contextmanager
def timed_dqn_bursts():
    """CUDA-event spans of every DQN training burst run inside the block (a list of pairs)."""
    from flexs_tpu_torch.runtime import dqn_runner

    spans = []
    burst = dqn_runner._DQNRun.burst

    def timed_burst(self, gens):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        burst(self, gens)
        end.record()
        spans.append((start, end))

    dqn_runner._DQNRun.burst = timed_burst
    try:
        yield spans
    finally:
        dqn_runner._DQNRun.burst = burst


@contextlib.contextmanager
def captured_ppo_train():
    """The first fused PPO update run inside the block: its inputs and outputs on the CPU.

    Yields a dict that gets `run` (the card run's settings), `before` and
    `after` (each cell's flat parameters, Adam state and statistics) and
    `args` (the trajectory `_PPORun.train` took).
    """
    from flexs_tpu_torch.runtime import ppo_runner

    seen = {}
    train = ppo_runner._PPORun.train

    def state(run):
        return [[x.detach().cpu().clone() for x in opt] for opt in run.opt_states], \
            [x.cpu().clone() for x in run.stats]

    def capturing_train(self, *args):
        if seen:
            return train(self, *args)
        seen["before"] = state(self)
        seen["args"] = [{k: v.cpu() for k, v in a.items()} if isinstance(a, dict)
                        else a.cpu() if torch.is_tensor(a) else list(a) for a in args]
        seen["run"] = dict(C=self.C, traj_cap=self.traj_cap, ppo_cfg=self.ppo_cfg,
                           cfg=self.cfg, dim=self.dim)
        train(self, *args)
        seen["after"] = state(self)

    ppo_runner._PPORun.train = capturing_train
    try:
        yield seen
    finally:
        ppo_runner._PPORun.train = train


@contextlib.contextmanager
def captured_dqn_burst():
    """The last fused DQN burst run inside the block: its inputs and result, on the card.

    Yields a dict that gets, for the first cell that trains in the burst,
    the Q network's flat weights before and after, the replay ring, the
    burst's settings and the state of the cell's generator as the burst
    starts (the burst draws its samples from it).  Device copies only, so
    the run takes no host sync; each burst overwrites the last one's.
    """
    from flexs_tpu_torch.runtime import dqn_runner

    seen = {}
    burst = dqn_runner._DQNRun.burst
    ring = ("mem_obs", "mem_next", "mem_act", "mem_act_val", "mem_rew", "mem_prio")

    def capturing_burst(self, gens):
        if not gens:
            return burst(self, gens)
        c, g = gens[0]
        seen.update(
            gen_state=g.get_state(), before=self.flats[c].detach().clone(),
            ring={name: getattr(self, name)[c].clone() for name in ring},
            n=self.mem_n[c].clone(),
            run=dict(L=self.L, A=self.cfg.alphabet_size, B=self.cfg.sequences_batch_size,
                     M=self.memory_size, train_epochs=self.train_epochs, gamma=self.gamma),
        )
        burst(self, gens)
        seen["after"] = self.flats[c].detach().clone()

    dqn_runner._DQNRun.burst = capturing_burst
    try:
        yield seen
    finally:
        dqn_runner._DQNRun.burst = burst


def dqn_burst_card_vs_cpu(seen: dict) -> dict:
    """Run the captured DQN burst again on the CPU and hold the card's weights to it.

    The samples' uniforms are drawn again on the card from a copy of the
    cell's generator, so the CPU replays the same draws; the sampling
    (`per_indices`) and the 20 training steps run on the CPU.
    """
    from flexs_tpu_torch.baselines.explorers.dqn import QNetwork, train_step
    from flexs_tpu_torch.baselines.models.torch_model import (
        adam_init, flatten_parameters, one_hot,
    )
    from flexs_tpu_torch.runtime.dqn_runner import per_indices

    run = seen["run"]
    L, A, B, M = run["L"], run["A"], run["B"], run["M"]
    dim = L * A
    ring = {k: v.cpu() for k, v in seen["ring"].items()}
    n = seen["n"].cpu()
    assert int(n) >= B, f"the captured burst was not kept ({int(n)} transitions < {B})"
    before = seen["before"].cpu()
    net = QNetwork(L, A, torch.Generator())
    flat = flatten_parameters(net)
    with torch.no_grad():
        flat.copy_(before)
    opt_state = adam_init(flat[None])
    gen = torch.Generator(device="cuda")
    gen.set_state(seen["gen_state"])
    for _ in range(run["train_epochs"]):
        u = torch.empty(B, device="cuda").uniform_(0, 1, generator=gen).cpu()
        idx = per_indices(ring["mem_prio"][:M], n, u)
        obs = one_hot(ring["mem_obs"][idx], A).reshape(B, dim)
        nxt = one_hot(ring["mem_next"][idx], A).reshape(B, dim)
        acts = one_hot(ring["mem_act"][idx], dim) * ring["mem_act_val"][idx][:, None]
        train_step(net, opt_state, obs, acts, ring["mem_rew"][idx], nxt, run["gamma"])
    card = seen["after"].cpu()
    step, diff = flat.detach() - before, card - flat.detach()
    rel = float(diff.norm() / flat.norm())
    assert float(step.norm()) > 0 and rel <= DQN_BURST_RTOL, rel
    return {"steps": run["train_epochs"], "transitions": int(n), "weights": flat.numel(),
            "rel_diff": rel, "rel_diff_to_update": float(diff.norm() / step.norm()),
            "update_norm": float(step.norm()), "max_abs_diff": float(diff.abs().max())}


def ppo_train_card_vs_cpu(seen: dict) -> dict:
    """Run the captured PPO update again on the CPU and hold the card's result to it."""
    import types

    from flexs_tpu_torch.baselines.models.torch_model import AdamState, flatten_parameters
    from flexs_tpu_torch.rl import ppo
    from flexs_tpu_torch.runtime import ppo_runner

    run = types.SimpleNamespace(dev=torch.device("cpu"), **seen["run"])
    (opts, stats) = seen["before"]
    run.nets, run.opt_states = [], []
    for opt in opts:
        net = ppo.ActorCritic(run.dim, run.dim, (128,), torch.Generator())
        flat = flatten_parameters(net)
        with torch.no_grad():
            flat.copy_(opt[0][0])
        run.nets.append(net)
        run.opt_states.append(AdamState(flat[None], *(x.clone() for x in opt[1:])))
    run.stats = ppo.ObsStats(*(x.clone() for x in stats))
    ppo_runner._PPORun.train(run, *seen["args"])
    card_opts, card_stats = seen["after"]
    out = {"rows": sum(min(s, run.traj_cap - 1) for s in seen["args"][-1])}
    for c, (card, cpu, start) in enumerate(zip(card_opts, run.opt_states, opts)):
        step = cpu.params - start[0]
        diff = card[0] - cpu.params
        rel = float(diff.norm() / step.norm())
        assert float(step.norm()) > 0 and rel <= PPO_TRAIN_RTOL, (c, rel)
        assert torch.equal(card[3], cpu.count), (card[3], cpu.count)
        out[f"cell_{c}"] = {"update_norm": float(step.norm()), "rel_diff": rel,
                            "max_abs_diff": float(diff.abs().max()),
                            "max_abs_step": float(step.abs().max())}
    for name, card, cpu in zip(ppo.ObsStats._fields, card_stats, run.stats):
        rel = float(((card - cpu).abs() / cpu.abs().clamp(min=1e-30)).max())
        assert rel <= PPO_STATS_RTOL, (name, rel)
        out[f"stats_{name}_max_rel_diff"] = rel
    return out


def rl_runner_phases(flexs, cuda_duplex, card: str, host_tops: dict) -> dict:
    """Phase 13 (a-d): the fused RL runners on the card."""
    import pandas as pd
    from flexs_tpu_torch import run_paper_table, runtime
    from flexs_tpu_torch.landscapes import rna, rosetta, tf_binding
    from flexs_tpu_torch.parallel import run_landscape_robustness_sweep, run_robustness_sweep
    from flexs_tpu_torch.runtime import jit_runner

    run, batch = RL_RUN, RL_RUN["sequences_batch_size"]
    classes = {"dqn": runtime.DeviceDQNNAM, "ppo": runtime.DevicePPONAM,
               "dynappo": runtime.DeviceDynaPPONAM,
               "dynappo_mutative": runtime.DeviceDynaPPOMutativeNAM}
    kwargs = {"dynappo": dict(env_batch_size=16)}
    steps = [("a 3msi", time.perf_counter())]
    # a. The paper's fused RL rows on 3MSI over a perfect model.
    problem = rosetta.registry()["3msi"]
    start = problem["starts"]["ed_3_wt"]
    paper = {}
    for name, cls in classes.items():
        steps.append((f"a {name}", time.perf_counter()))
        rounds = RL_RUN_ROUNDS[name]
        land = rosetta.RosettaFolding(**problem["params"])
        runner = cls(land, flexs.AAS, starting_sequence=start, model="perfect", seed=0,
                     rounds=rounds, **run, **kwargs.get(name, {}))
        cuda_duplex.reset_launch_counts()
        with timed_dqn_bursts() as bursts, captured_dqn_burst() as dqn_burst, \
                captured_ppo_train() as ppo_train:
            df, reading = fused_run(runner, land)
        no_duplex_launches(cuda_duplex, f"13a {name}")
        if name == "dqn":
            burst_s = sum(a.elapsed_time(b) for a, b in bursts) / 1e3
            reading.update(bursts=len(bursts), burst_s=burst_s,
                           burst_share=burst_s / reading["wall_s"],
                           burst_card_vs_cpu=dqn_burst_card_vs_cpu(dqn_burst))
        # The DynaPPO runners' experiment phases score on the landscape too.
        measured = land.cost if name in ("dqn", "ppo") else len(df)
        assert df["measurement_cost"].iloc[-1] == len(df) == measured
        check_fused_frame(df, land, rounds, batch, start, unique=name != "dqn")
        reading.update(rounds=rounds, syncs_per_round=reading["host_syncs"] / rounds,
                       host_top_2_rounds=host_tops[name]["top"],
                       reference_dynappo=run_paper_table.REFERENCE["dynappo"])
        if name == "dynappo":
            assert reading["host_syncs"] == 0, "DynaPPO synced inside a round"
        if name == "ppo":
            reading["train_card_vs_cpu"] = ppo_train_card_vs_cpu(ppo_train)
        paper[name] = reading
        print(f"fused 3msi {name} ({rounds} rounds, perfect model): {json.dumps(reading)} "
              f"[{card}]")

    # DynaPPO's episodes as CUDA-graph replays equal eager ones (1 round).
    steps.append(("a graph vs eager", time.perf_counter()))
    land = rosetta.RosettaFolding(**problem["params"])
    cfg = runtime.AdaleadConfig(rounds=1, alphabet_size=20, perfect_model=True, **run)
    tokens = torch.as_tensor(flexs.Alphabet(flexs.AAS).encode_one(start), device=land.device)
    results, graph_walls = [], {}
    for graph in (True, False):
        gen = torch.Generator(device=land.device)
        gen.manual_seed(0)
        res, graph_walls[graph] = timed(lambda: runtime.dyna_ppo_runner.run_dyna_ppo_nam(
            *land.device_fitness(), tokens, cfg, 1.0, gen, env_batch_size=16,
            cuda_graph=graph))
        results.append(res)
    for name, a, b in zip(results[0]._fields, *results):
        assert torch.equal(a, b), f"graphed DynaPPO != eager in {name}"
    paper["dynappo"]["graph_vs_eager_1_round_s"] = [graph_walls[True], graph_walls[False]]
    print(f"fused dynappo, 1 round: CUDA-graph episodes == eager bitwise; walls "
          f"{graph_walls[True]} s graphed, {graph_walls[False]} s eager [{card}]")

    # b. The kernel's path: PPO and DynaPPO over NAM 0.9 on L100_RNA1, twice each.
    reg = rna.registry()
    l100_start = reg["L100_RNA1"]["starts"][1]
    l100 = {}
    for name in ("ppo", "dynappo"):
        steps.append((f"b {name}", time.perf_counter()))
        rounds = RL_L100_ROUNDS[name]
        runs = []
        for _ in range(2):
            land = rna.RNABinding(**reg["L100_RNA1"]["params"])
            runner = classes[name](land, flexs.RNAA, starting_sequence=l100_start,
                                   signal_strength=0.9, seed=0, rounds=rounds, **run,
                                   **kwargs.get(name, {}))
            cuda_duplex.reset_launch_counts()
            df, reading = fused_run(runner, land)
            reading["duplex_launches"] = path_launches(cuda_duplex, f"fused L100_RNA1 {name}")
            reading["last_round_mean"] = float(df.loc[df["round"] == rounds, "true_score"].mean())
            check_fused_frame(df, land, rounds, batch, l100_start, unique=True)
            runs.append((df, reading))
        pd.testing.assert_frame_equal(runs[0][0], runs[1][0])
        assert runs[0][1]["duplex_launches"] == runs[1][1]["duplex_launches"]
        reading = {**runs[0][1], "rounds": rounds, "second_wall_s": runs[1][1]["wall_s"]}
        l100[name] = reading
        print(f"fused L100_RNA1 {name} (NAM 0.9, start 1, {rounds} rounds, twice, identical "
              f"frames): {json.dumps(reading)} [{card}]")
        launches, top, mean = RL_L100_PINS[name]
        assert reading["duplex_launches"] == launches, (name, reading["duplex_launches"])
        assert round(reading["top"], 6) == top, (name, reading["top"])
        assert round(reading["last_round_mean"], 6) == mean, (name, reading["last_round_mean"])

    # c. The density on the card, and an exact-density mutative round.
    steps.append(("c density", time.perf_counter()))
    cuda_duplex.reset_launch_counts()
    density = density_card_vs_cpu(flexs, start)
    print(f"density card vs CPU (3MSI width, {DENSITY_QUERIES} x {DENSITY_POOL}; distances "
          f"bitwise, sums within {DENSITY_RTOL} relative): {json.dumps(density)} [{card}]")
    for metric in ("hamming", "edit"):
        land = rosetta.RosettaFolding(**problem["params"])
        runner = runtime.DeviceDynaPPOMutativeNAM(
            land, flexs.AAS, starting_sequence=start, model="perfect", seed=0, rounds=1,
            density_metric=metric, **run)
        df, reading = fused_run(runner, land)
        # At R = 1 the annealed experiment budget is the whole batch: the
        # round proposes B - (2 B) // 2 = 0 sequences (its batches a host sync each).
        assert len(df) == 1 and reading["host_syncs"] > 1, reading
        density[f"mutative_1_round_{metric}"] = reading
    no_duplex_launches(cuda_duplex, "13c")
    print(f"fused 3msi dynappo_mutative, 1 round: edit density wall "
          f"{density['mutative_1_round_edit']['wall_s']} s beside Hamming "
          f"{density['mutative_1_round_hamming']['wall_s']} s [{card}]")

    # d. Sweeps: DynaPPO over TF-Bind in one lockstep chunk, DQN over L100_RNA1's starts.
    steps.append(("d dynappo sweep", time.perf_counter()))
    tf_start = tf_binding.registry()["SIX6_REF_R1"]["starts"][0]
    names = list(tf_binding.registry())[:FUSED_SWEEP_LANDSCAPES]
    dyna_run = {**run, "rounds": RL_SWEEP_ROUNDS["dynappo"]}
    cuda_duplex.reset_launch_counts()
    jit_runner.reset_run_counts()
    dyna_sweep, dyna_wall = timed(lambda: run_robustness_sweep(
        names, [tf_start], signal_strengths=FUSED_SWEEP_SS, seeds=FUSED_SWEEP_SEEDS,
        algorithm="dynappo", **dyna_run))
    dyna_syncs = jit_runner.run_counts["syncs"]
    no_duplex_launches(cuda_duplex, "13d dynappo sweep")
    assert len(dyna_sweep) == len(names) * len(FUSED_SWEEP_SS) * len(FUSED_SWEEP_SEEDS)
    for row in (dyna_sweep.iloc[0], dyna_sweep.iloc[-1]):
        same_as_alone(row, tf_binding.TFBinding(name=row["landscape"]),
                      runtime.DeviceDynaPPONAM, flexs.DNAA, dyna_run)
    steps.append(("d dqn sweep", time.perf_counter()))
    starts = [reg["L100_RNA1"]["starts"][k] for k in FUSED_RNA_SWEEP_STARTS]
    dqn_run = {**run, "rounds": RL_SWEEP_ROUNDS["dqn"]}
    land = rna.RNABinding(**reg["L100_RNA1"]["params"])
    cuda_duplex.reset_launch_counts()
    dqn_sweep, dqn_wall = timed(lambda: run_landscape_robustness_sweep(
        [land], flexs.RNAA, starts, signal_strengths=[0.9], seeds=[0], algorithm="dqn",
        **dqn_run))
    dqn_launches = path_launches(cuda_duplex, "fused DQN sweep")
    assert dqn_launches == RL_DQN_SWEEP_LAUNCHES, dqn_launches
    for row in (dqn_sweep.iloc[0], dqn_sweep.iloc[-1]):
        same_as_alone(row, rna.RNABinding(**reg["L100_RNA1"]["params"]), runtime.DeviceDQNNAM,
                      flexs.RNAA, dqn_run)
    sweeps = {}
    for label, df, wall, rounds in (("dynappo_tf_bind", dyna_sweep, dyna_wall, dyna_run["rounds"]),
                                    ("dqn_l100", dqn_sweep, dqn_wall, dqn_run["rounds"])):
        scored = int(df["model_cost"].sum() + df["landscape_cost"].sum())
        sweeps[label] = {"cells": len(df), "rounds": rounds, "wall_s": wall,
                         "s_per_cell": wall / len(df),
                         "sequences_scored_per_s": scored / wall,
                         "mean_max_fitness": float(df["max_fitness"].mean())}
    sweeps["dynappo_tf_bind"]["host_syncs"] = dyna_syncs
    sweeps["dqn_l100"]["duplex_launches"] = dqn_launches
    print(f"fused RL sweeps (first and last cells == standalone runs): {json.dumps(sweeps)} "
          f"[{card}]")
    steps.append(("end", time.perf_counter()))
    walls = step_walls(steps)
    print(f"phase 13 step walls (s): {json.dumps(walls)}")
    return {"paper_3msi": paper, "l100": l100, "density": density, "sweeps": sweeps,
            "step_walls_s": walls}


def start_cli(argv, out: str, ranks: int = 1) -> subprocess.Popen:
    """`python -m flexs_tpu_torch.cli` as a program (under torchrun for several ranks).

    It leads a new process group (so `stop` ends its whole process tree),
    with its output in `<out>.log`.
    """
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(filter(None, (
        root, os.environ.get("PYTHONPATH"))))}
    launcher = [] if ranks == 1 else ["-m", "torch.distributed.run", "--standalone",
                                      "--nproc-per-node", str(ranks)]
    with open(out + ".log", "w") as log:
        return subprocess.Popen(
            [sys.executable, *launcher, "-m", "flexs_tpu_torch.cli", *argv, "--out", out],
            cwd=root, env=env, stdout=log, stderr=subprocess.STDOUT, start_new_session=True,
        )


def stop(proc: subprocess.Popen) -> None:
    """Kill a started program's whole process tree if it still runs."""
    if proc.poll() is None:
        os.killpg(proc.pid, 9)
        proc.wait()


def finish(proc: subprocess.Popen, out: str, what: str) -> str:
    """The output of a program started by `start_cli`, which must exit 0 in time."""
    try:
        proc.wait(timeout=INFRA_SUBPROCESS_TIMEOUT_S)
    finally:
        stop(proc)
    log = read_text(out + ".log")
    assert proc.returncode == 0, f"{what} exited {proc.returncode}:\n{log[-4000:]}"
    return log


def read_text(path: str) -> str:
    with open(path) as f:
        return f.read()


def infrastructure_phases(flexs, cuda_duplex, card: str, kernel_ms_b100: float) -> dict:
    """Phase 14 (a-e): mesh=, checkpointing, profiling, the CLI and the native binding."""
    import pandas as pd
    import torch.distributed as dist
    from flexs_tpu_torch import cli, native
    from flexs_tpu_torch.landscapes import rna, rosetta
    from flexs_tpu_torch.ops import rna_duplex as rd
    from flexs_tpu_torch.utils import checkpointing, profiling

    steps = [("a d programs started", time.perf_counter())]
    readings = {}
    with tempfile.TemporaryDirectory() as tmp:
        out = {name: os.path.join(tmp, f"{name}.csv")
               for name in ("no_mesh", "one_rank", "resumed", "two_ranks", "fast", "fast_here")}
        ckpt = os.path.join(tmp, "ckpt")
        # a, d. The programs run beside the in-process work; the card is shared.
        programs = {"two_ranks": start_cli(INFRA_GA_GRID, out["two_ranks"], ranks=2),
                    "fast": start_cli(INFRA_FAST_PATH, out["fast"])}
        try:
            steps.append(("a in-process grid", time.perf_counter()))
            walls = {}
            for name, extra in (("no_mesh", ["--no-mesh"]),
                                ("one_rank", ["--chunk-size", "2", "--checkpoint-dir", ckpt]),
                                ("resumed", ["--chunk-size", "2", "--checkpoint-dir", ckpt])):
                if name == "resumed":
                    chunks = {f: os.stat(os.path.join(ckpt, f)).st_mtime_ns
                              for f in sorted(os.listdir(ckpt)) if f.endswith(".npz")}
                (rc, walls[name]) = timed(lambda: cli.main(INFRA_GA_GRID + extra
                                                            + ["--out", out[name]]))
                assert rc == 0, name
            assert len(chunks) == 2, chunks
            assert {f: os.stat(os.path.join(ckpt, f)).st_mtime_ns for f in chunks} == chunks, \
                "the rerun rewrote a checkpoint"
            grid = read_text(out["no_mesh"])
            for name in ("one_rank", "resumed"):
                assert read_text(out[name]) == grid, f"the {name} CSV differs from mesh=None"
            frame = pd.read_csv(out["no_mesh"])
            assert len(frame) == 4 and np.isfinite(frame["max_fitness"]).all()
            assert (frame["max_fitness"] >= frame["start_fitness"]).all()
            assert cli.main(INFRA_FAST_PATH + ["--no-mesh", "--out", out["fast_here"]]) == 0
            readings["cli_grid"] = {"walls_s": walls, "mean_max_fitness":
                                    float(frame["max_fitness"].mean())}

            # b. save_state/load_state mid-fit on the card, then resume_explorer.
            steps.append(("b state", time.perf_counter()))
            readings["state"] = resumed_fit_on_card(flexs, checkpointing, tmp)
            steps.append(("b resume_explorer", time.perf_counter()))
            readings["resume_explorer"] = resumed_host_run(flexs, cuda_duplex, checkpointing, tmp)

            # e. The native library against the card.
            steps.append(("e native", time.perf_counter()))
            readings["native"] = native_vs_card(flexs, cuda_duplex, native, rna, rosetta, rd)

            steps.append(("a d programs", time.perf_counter()))
            logs = {name: finish(proc, out[name], name) for name, proc in programs.items()}
        finally:
            for proc in programs.values():
                stop(proc)
        assert read_text(out["two_ranks"]) == grid, "the two ranks' CSV differs from mesh=None"
        assert logs["two_ranks"].count("4 cells on 2 device(s)") == 2, logs["two_ranks"][-2000:]
        assert read_text(out["fast"]) == read_text(out["fast_here"]), \
            "the fast path as a program differs from the same call in this process"
        fast = pd.read_csv(out["fast"])
        assert len(fast) == 1 and fast["max_fitness"].iloc[0] >= fast["start_fitness"].iloc[0]
        readings["cli_grid"]["two_ranks"] = "== mesh=None (CSV bytes)"
        readings["cli_fast_path"] = {"max_fitness": float(fast["max_fitness"].iloc[0]),
                                     "model_cost": int(fast["model_cost"].iloc[0])}

        # c. Profiling, with the card to this process alone.
        steps.append(("c profiling", time.perf_counter()))
        readings["profiling"] = profiling_on_card(flexs, cuda_duplex, profiling, rna, tmp,
                                                  kernel_ms_b100)
    if dist.is_initialized():
        dist.destroy_process_group()
    steps.append(("end", time.perf_counter()))
    walls = step_walls(steps)
    print(f"phase 14 step walls (s): {json.dumps(walls)}")
    readings["step_walls_s"] = walls
    print(f"infrastructure: CLI GA grid (4 cells) == over a one-rank mesh == resumed from its "
          f"checkpoints == over two torchrun ranks sharing the card (CSV bytes); fast path as a "
          f"program == in process: {json.dumps(readings['cli_fast_path'])} [{card}]")
    return readings


def resumed_fit_on_card(flexs, checkpointing, tmp: str) -> dict:
    """A CNN fit resumed from `save_state` equals the uninterrupted fit bitwise."""
    rng = np.random.default_rng(SEED)
    seqs = ["".join(rng.choice(list(flexs.AAS), 66)) for _ in range(INFRA_FIT_ROWS)]
    labels = rng.random(INFRA_FIT_ROWS)

    def cnn(seed):
        return flexs.baselines.models.CNN(66, 32, 100, flexs.AAS, epochs=INFRA_FIT_EPOCHS,
                                          seed=seed)

    whole = cnn(0)
    whole.train(seqs, labels)
    whole.train(seqs, labels)
    first = cnn(0)
    first.train(seqs, labels)
    path = os.path.join(tmp, "fit", "state.pt")
    template = {"adam": first._state, "generator": first._generator}
    checkpointing.save_state(path, template)
    resumed = cnn(1)  # other weights and draws, all replaced by the checkpoint's
    state = checkpointing.load_state(path, template=template)
    assert state["adam"].params.device == first._state.params.device
    assert state["generator"].device == first._generator.device
    resumed._state, resumed._generator = state["adam"], state["generator"]
    resumed.train(seqs, labels)
    for name, a, b in zip(whole._state._fields, whole._state, resumed._state):
        assert torch.equal(a, b), f"the resumed fit's {name} differs from the whole fit's"
    preds = resumed.get_fitness(seqs[:100])
    assert np.array_equal(preds, whole.get_fitness(seqs[:100])) and np.isfinite(preds).all()
    return {"weights": int(whole._state.params.numel()), "adam_count":
            int(whole._state.count[0]), "file_bytes": os.path.getsize(path)}


def resumed_host_run(flexs, cuda_duplex, checkpointing, tmp: str) -> dict:
    """Host Adalead + NAM on L100_RNA1, resumed from its log from 2 rounds to 3.

    The logged rounds stay as they were, the resumed round measures
    through the duplex kernel, and every round's true_score equals
    `get_fitness` of that round's rows as one batch.
    """
    import pandas as pd
    from flexs_tpu_torch.landscapes import rna

    problem = rna.registry()["L100_RNA1"]
    start = problem["starts"][1]
    log = os.path.join(tmp, "host", "run.csv")
    partial_rounds, rounds = INFRA_RESUME_ROUNDS

    def explorer(land, n_rounds, log_file=None):
        model = flexs.baselines.models.NoisyAbstractModel(land, 0.9, seed=0)
        return flexs.baselines.explorers.Adalead(
            model, rounds=n_rounds, sequences_batch_size=100, model_queries_per_batch=2000,
            starting_sequence=start, alphabet=flexs.RNAA, seed=0, log_file=log_file)

    land = rna.RNABinding(**problem["params"])
    explorer(land, partial_rounds, log).run(land, verbose=False)
    partial, _ = checkpointing.load_run(log)
    land = rna.RNABinding(**problem["params"])
    cuda_duplex.reset_launch_counts()
    (df, _), wall = timed(lambda: checkpointing.resume_explorer(
        explorer(land, rounds), land, log, verbose=False))
    launches = path_launches(cuda_duplex, "resumed host")
    pd.testing.assert_frame_equal(df.iloc[: len(partial)], partial)
    assert df["round"].max() == rounds and len(df) > len(partial)
    check = rna.RNABinding(**problem["params"])
    for r in range(rounds + 1):
        rows = df[df["round"] == r]
        truth = check.get_fitness(rows["sequence"].tolist())
        assert np.array_equal(rows["true_score"].to_numpy(), truth), f"round {r}"
    return {"wall_s": wall, "duplex_launches": launches, "rows": len(df),
            "top": float(df["true_score"].max()),
            "resumed_round_top": float(df.loc[df["round"] == rounds, "true_score"].max())}


def native_vs_card(flexs, cuda_duplex, native, rna, rosetta, rd) -> dict:
    """The g++-built native scorers against the card: Rosetta 3msi and the duplex kernel."""
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    native.load()
    build_s = time.perf_counter() - t0
    land = rosetta.RosettaFolding(**rosetta.registry()["3msi"]["params"])
    aa = flexs.Alphabet(flexs.AAS)
    tokens = np.concatenate([rng.integers(0, 20, (NATIVE_ROSETTA_ROWS, len(land.wt_sequence))),
                             aa.encode([land.wt_sequence])])
    on_card = land.fitness_from_tokens(tokens).cpu().numpy()
    host = native.rosetta_score_batch(land, tokens)
    np.testing.assert_allclose(host, on_card, **NATIVE_ROSETTA_TOL)
    problem = rna.registry()["L100_RNA1"]["params"]
    rland = rna.RNABinding(**problem)
    plan = rland.device_fitness()[1].plan
    target = flexs.Alphabet(flexs.RNAA).encode_one(problem["targets"][0])
    assert torch.equal(plan.targets_rev[0].cpu(), torch.as_tensor(target).flip(0))
    seqs = rng.integers(0, 4, (NATIVE_DUPLEX_ROWS, 100))
    before = cuda_duplex.launches
    kernel = cuda_duplex.duplex_energies(torch.as_tensor(seqs, device="cuda"), plan.targets_rev,
                                         plan.em, rland.params.maxloop)[:, 0].cpu().numpy()
    assert cuda_duplex.launches == before + 1, "duplex_energies did not launch the kernel once"
    host_e = native.rna_duplex_energy_batch(seqs, target, rland.params)
    np.testing.assert_allclose(host_e, kernel, **NATIVE_DUPLEX_TOL)
    assert np.isfinite(kernel).all() and (kernel < 0).all()
    return {"build_s": build_s, "rosetta_rows": len(tokens),
            "rosetta_max_abs_diff": float(np.abs(host - on_card).max()),
            "duplex_rows": NATIVE_DUPLEX_ROWS, "duplex_launches": 1,
            "duplex_max_abs_diff": float(np.abs(host_e - kernel).max()),
            "duplex_max_rel_diff": float((np.abs(host_e - kernel) / np.abs(kernel)).max())}


def profiling_on_card(flexs, cuda_duplex, profiling, rna, tmp: str, kernel_ms_b100: float) -> dict:
    """`amortized_seconds_per_call` of the kernel at B=100, and a traced fused round."""
    problem = rna.registry()["L100_RNA1"]
    land = rna.RNABinding(**problem["params"])
    plan = land.device_fitness()[1].plan
    tokens = torch.as_tensor(np.random.default_rng(SEED).integers(0, 4, (100, 100)), device="cuda")
    amortized_ms = profiling.amortized_seconds_per_call(
        cuda_duplex.launch_plan, plan, tokens, reps=100) * 1e3
    runner = flexs.runtime.DeviceAdaleadNAM(
        land, flexs.RNAA, rounds=1, sequences_batch_size=100, model_queries_per_batch=2000,
        starting_sequence=problem["starts"][1], signal_strength=0.9, seed=0)
    trace_dir = os.path.join(tmp, "trace")
    cuda_duplex.reset_launch_counts()
    with profiling.trace(trace_dir):
        df, _ = runner.run(verbose=False)
        torch.cuda.synchronize()
    launches = path_launches(cuda_duplex, "traced fused round")
    (trace_file,) = os.listdir(trace_dir)
    with open(os.path.join(trace_dir, trace_file)) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    duplex = [e for e in kernels if "duplex_dp" in e.get("name", "")]
    assert duplex, f"the trace names no duplex kernel ({len(kernels)} kernel events)"
    assert df["round"].max() == 1
    reading = {"amortized_ms_b100": amortized_ms, "phase2_cuda_event_median_ms_b100":
               kernel_ms_b100, "trace_events": len(events), "trace_kernel_events": len(kernels),
               "trace_duplex_events": len(duplex), "trace_duplex_name": duplex[0]["name"],
               "traced_round_duplex_launches": launches,
               "trace_duplex_device_ms": sum(e.get("dur", 0) for e in duplex) / 1e3}
    print(f"profiling: amortized_seconds_per_call of the duplex kernel at B=100 "
          f"{amortized_ms} ms beside phase 2's CUDA-event median {kernel_ms_b100} ms; "
          f"a traced fused round: {json.dumps(reading)} [{card_line()}]")
    return reading


def printed(fn):
    """(fn(), what it printed); what it printed is printed again."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    print(buf.getvalue(), end="")
    return out, buf.getvalue()


def captured(fn):
    """(fn(), the JSON lines it printed); what it printed is printed again."""
    out, text = printed(fn)
    return out, [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def bench_phases(cuda_duplex, card: str, tf_fused_top: float) -> dict:
    """Phase 15 (a-c): the stages of the measurement entry points, small."""
    from flexs_tpu_torch import bench, bench_surrogate

    steps = [("a rna oracle", time.perf_counter())]
    readings = {}
    # a. The RNA oracle stage: its readings launch the kernel on a plan.
    cuda_duplex.reset_launch_counts()
    (keys, energies), lines = captured(lambda: bench.run_rna_oracle(
        batch=BENCH_ORACLE_BATCH, reps=BENCH_ORACLE_REPS))
    launches = path_launches(cuda_duplex, "bench rna_oracle stage")
    assert launches == BENCH_ORACLE_LAUNCHES, launches
    assert keys["duplex_kernel_bitexact_vs_plain"] is True, keys
    assert energies.shape == (64, 1) and torch.isfinite(energies).all()
    stage_lines = lines
    readings["rna_oracle"] = {**keys, "duplex_launches": launches}

    # b. The single-run stage with one run of run_once, seed 0: phase 5b's run.
    steps.append(("b single run", time.perf_counter()))
    cuda_duplex.reset_launch_counts()
    (keys, tops), lines = captured(lambda: bench.run_single(seeds=(0,), warmup_seed=None))
    no_duplex_launches(cuda_duplex, "15b")
    assert tops == [tf_fused_top], (tops, tf_fused_top)
    stage_lines += lines
    readings["single_run"] = keys

    # c. The 3-CNN CMA-ES bench on TF-Bind-8, cut to 1 round, 1 landscape, 1 start.
    steps.append(("c tfbind cmaes", time.perf_counter()))
    cuda_duplex.reset_launch_counts()
    (mean_max, s_per_run), lines = captured(lambda: bench_surrogate.bench_tfbind_cmaes(
        BENCH_CMAES["rounds"], landscapes=BENCH_CMAES["landscapes"],
        starts_n=BENCH_CMAES["starts_n"]))
    no_duplex_launches(cuda_duplex, "15c")
    assert len(lines) == 1 and list(lines[0]) == BENCH_CMAES_KEYS, lines
    assert lines[0]["card"] == card and lines[0]["runs"] == 1, lines
    assert 0 < mean_max <= 1 and s_per_run > 0, (mean_max, s_per_run)
    readings["tfbind_cmaes"] = lines[0]

    # Each stage's line: its keys in order, on this card.
    assert [line["stage"] for line in stage_lines] == ["rna_oracle", "single_run"], stage_lines
    for line in stage_lines:
        assert list(line) == ["stage", *bench.STAGE_KEYS[line["stage"]], "stage_wall_s",
                              "card"], line
        assert line["card"] == card, line
    steps.append(("end", time.perf_counter()))
    walls = step_walls(steps)
    print(f"phase 15 step walls (s): {json.dumps(walls)}")
    readings["step_walls_s"] = walls
    return readings


def paper_northstar_phases(flexs, cuda_duplex, card: str) -> dict:
    """Phase 16 (a-c): the paper table, the north-star grid and its aggregator, small."""
    from flexs_tpu_torch import aggregate_northstar, bench_northstar, run_paper_table

    steps = [("a paper table", time.perf_counter())]
    readings = {}
    # a. The table's fused CMA-ES and host Random rows, 1 start, 1 round.
    cuda_duplex.reset_launch_counts()
    rc, text = printed(lambda: run_paper_table.main(PAPER_TABLE_SMOKE))
    no_duplex_launches(cuda_duplex, "16a")
    assert rc == 0, rc
    lines = text.splitlines()
    rows = [json.loads(line) for line in lines if line.startswith("{")]
    names = PAPER_TABLE_SMOKE[1:3]
    assert [r["explorer"] for r in rows] == names, rows
    for row in rows:
        name = row["explorer"]
        assert list(row) == PAPER_ROW_KEYS and row["card"] == card, row
        assert row["starts"] == len(row["maxes"]) == 1 and row["rounds"] == 1, row
        assert 0 < row["mean"] == row["best"] == row["maxes"][0] <= 1, row
        assert any(line.startswith(f"  {name} start 1/1: max {row['maxes'][0]:.3f}")
                   for line in lines), (name, lines)
        assert any(line.startswith(f"{name:<10} {row['mean']:>8.3f}/") for line in lines), name
    start = run_paper_table.paper_starts(1)[0]
    land = flexs.landscapes.rosetta.RosettaFolding(
        **flexs.landscapes.rosetta.registry()["3msi"]["params"])
    cuda_duplex.reset_launch_counts()
    df, _ = flexs.runtime.DeviceCMAESNAM(
        land, flexs.AAS, rounds=1, sequences_batch_size=100, model_queries_per_batch=2000,
        starting_sequence=start, model="perfect", maximize=True, seed=0).run(verbose=False)
    no_duplex_launches(cuda_duplex, "16a standalone")
    alone = float(df["true_score"].max())
    assert rows[0]["maxes"][0] == alone, (rows[0], alone)
    readings["paper_table"] = {"rows": rows, "standalone_device_cmaes_max": alone}

    # b. The north-star grid's Random and Adalead families, small.
    steps.append(("b northstar", time.perf_counter()))
    cuda_duplex.reset_launch_counts()
    rc, ns_text = printed(lambda: bench_northstar.main(NORTHSTAR_SMOKE))
    no_duplex_launches(cuda_duplex, "16b")
    assert rc == 0, rc
    ns_lines = [json.loads(line) for line in ns_text.splitlines() if line.startswith("{")]
    *families, summary = ns_lines
    assert [f["family"] for f in families] == ["random", "adalead"], ns_lines
    for fam in families:
        assert list(fam) == NORTHSTAR_FAMILY_KEYS and fam["card"] == card, fam
        assert fam["cells"] == 8 and fam["seqs"] > 0 and fam["wall_s"] > 0, fam
    assert summary["metric"] == "northstar_all_explorers_all_landscapes", summary
    assert summary["landscapes"] == 8 and summary["n_devices"] == 1, summary
    assert summary["total_cells"] == sum(f["cells"] for f in families), summary
    assert summary["total_seqs"] == sum(f["seqs"] for f in families), summary

    # c. The aggregator over b's output.
    steps.append(("c aggregate", time.perf_counter()))
    with tempfile.TemporaryDirectory() as tmp:
        log, out = os.path.join(tmp, "northstar.log"), os.path.join(tmp, "northstar.json")
        with open(log, "w") as f:
            f.write(ns_text)
        rc, agg_lines = captured(lambda: aggregate_northstar.main([log, "--out", out]))
        with open(out) as f:
            artifact = json.load(f)
    assert rc == 0, rc
    (agg,) = agg_lines
    for key in ("total_cells", "total_seqs"):
        assert agg[key] == summary[key], (key, agg, summary)
    assert agg == artifact["summary"] and agg["card"] == card, (agg, artifact["summary"])
    assert [r["family"] for r in artifact["families"]] == ["random", "adalead"], artifact
    readings["northstar"] = {"families": families, "summary": summary, "aggregate": agg}
    steps.append(("end", time.perf_counter()))
    walls = step_walls(steps)
    print(f"phase 16 step walls (s): {json.dumps(walls)}")
    readings["step_walls_s"] = walls
    return readings


def rowcost_phase(cuda_duplex, rowcost, phase2_ms: float):
    """Phase 7: `rowcost.measure` on its seeded inputs, every build launched.

    Returns (readings, launch counts).  Prints each build's time, us per
    row and difference from baseline, the clocked build's parts of a row,
    baseline's time at B=100 against phase 2's kernel time `phase2_ms`,
    and at B=100 the parts' sum against the clocked build's own us per row.
    """
    cuda_duplex.reset_launch_counts()
    rc = rowcost.measure(*rowcost.seeded_inputs("cuda"))
    torch.cuda.synchronize()
    rc_counts = cuda_duplex.launch_counts()
    silent = [v for v in cuda_duplex.ROWCOST_BUILDS if rc_counts[v] == 0]
    assert not silent, f"the row-cost path never launched {silent}"
    assert rc_counts[cuda_duplex.MAIN] == 0, rc_counts
    print(f"row-cost phase, SM clock and power after: {clock_line()}")
    for b, batch in rc.items():
        for v, entry in batch["builds"].items():
            print(f"row-cost {v} B={b}: {entry['ms']} ms, {entry['us_per_row']} us/row "
                  f"({entry['us_per_row_vs_baseline']:+} vs baseline), plain "
                  f"{batch['plain_ms']} ms, bound {entry['bound_ms']} ms ({entry['bound_by']}), "
                  f"{'== plain' if v in cuda_duplex.EXACT_VARIANTS else 'timing only'}, "
                  f"max |diff| vs plain {entry['max_abs_err']}")
        c = batch["clocked"]
        timed = batch["builds"]["clocked"]["us_per_row"]
        print(f"row-cost clocked B={b}: median cycles {json.dumps(c['cycles'])}, row "
              f"{c['row_cycles']}, SM clock {c['sm_clock_mhz']} MHz, parts "
              f"{c['parts_us_per_row']} us/row vs {timed} timed "
              f"(ratio {c['parts_us_per_row'] / timed})")
    base = rc[rowcost.MAIN_PATH_BATCH]["builds"]["baseline"]["ms"]
    print(f"row-cost: {list(cuda_duplex.EXACT_VARIANTS)} == plain (bitwise) at B={tuple(rc)}; "
          f"baseline at B=100 {base} ms vs phase 2's {phase2_ms} ms (ratio {base / phase2_ms}); "
          f"launches {rc_counts}")
    return rc, rc_counts


def rowcost_kernels(cuda_duplex, rowcost, rc, rc_counts, fused_counts) -> list:
    """The kernels line's entries of the row-cost builds.

    The profiler's B=4096 at the top level, B=100 beside it; `launches`
    counts phase 7, `fused_launches` the fused run.
    """
    sources = {"baseline": "flexs_tpu_torch/csrc/duplex_dp.cu",
               cuda_duplex.FIRST: "flexs_tpu_torch/csrc/duplex_first.cu"}
    entries = []
    for v in cuda_duplex.ROWCOST_BUILDS:
        exact = v in cuda_duplex.EXACT_VARIANTS
        entries.append({
            "name": f"duplex_rowcost_{v.replace('-', '_')}",
            "route": "cuda",
            "source": sources.get(v, "flexs_tpu_torch/csrc/duplex_rowcost.cu"),
            "replaces": "scripts/profile_duplex_rowcost.py:206",
            "launches": rc_counts[v],
            "fused_launches": fused_counts[v],
            "knockout": v not in ("baseline", cuda_duplex.FIRST),
            "tolerance": "bitwise" if exact else "finite only (wrong by design)",
            **rc[rowcost.BATCH]["builds"][v],
            "plain_ms": rc[rowcost.BATCH]["plain_ms"],
            "library_ms": None,
            "at_B100": {**rc[rowcost.MAIN_PATH_BATCH]["builds"][v],
                        "plain_ms": rc[rowcost.MAIN_PATH_BATCH]["plain_ms"]},
        })
        if v == "clocked":
            entries[-1]["clock_parts"] = {b: batch["clocked"] for b, batch in rc.items()}
    return entries


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
    # 1. Build every library at once, one nvcc each ("baseline" is MAIN's).
    builds = (cuda_duplex.MAIN,) + tuple(
        v for v in cuda_duplex.ROWCOST_BUILDS if v != "baseline")
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

    # Timing: the kernel alone on the landscape's plan (a bound launcher,
    # checked once), the wrapper the main path calls (checks, output,
    # launch), and the plain version.
    reps, inner = rowcost.TIMING_REPS, rowcost.TIMING_INNER
    timings = {}
    for b in (100, 512, 4096):
        tokens = random_tokens(b, 100)
        entry = {
            "ms": time_ms(cuda_duplex.launcher(plan, tokens)[1], reps, inner),
            "sm_clock_power_after": clock_line(),
            "plain_ms": time_ms(
                lambda: cuda_duplex.duplex_energies_plain(tokens, targets_rev, em, maxloop),
                reps, 1),
            **rowcost.bound_entry(rowcost.plan_bytes(plan, tokens), (b, 1, 100, 100, maxloop)),
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
              f"{entry['adds']} adds, {entry['mins']} mins)")

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
    # build on its seeded inputs.
    rc, rc_counts = rowcost_phase(cuda_duplex, rowcost, timings[100]["ms"])

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

    stamps.append(("11 explorers", time.perf_counter()))
    # 11. The host explorers, their components and the kernel's path through them.
    explorer_readings = explorer_phases(flexs, cuda_duplex, card)
    print(f"explorer readings: {json.dumps(explorer_readings)}")

    stamps.append(("12 fused runners", time.perf_counter()))
    # 12. The fused runners of the non-RL explorers, and their sweeps.
    fused_readings = fused_runner_phases(flexs, cuda_duplex, card,
                                         explorer_readings["paper_3msi"])
    print(f"fused runner readings: {json.dumps(fused_readings)}")

    stamps.append(("13 rl runners", time.perf_counter()))
    # 13. The fused RL runners, and their sweeps.
    rl_readings = rl_runner_phases(flexs, cuda_duplex, card, explorer_readings["paper_3msi"])
    print(f"rl runner readings: {json.dumps(rl_readings)}")

    stamps.append(("14 infrastructure", time.perf_counter()))
    # 14. mesh=, checkpointing, profiling, the CLI and the native binding.
    infra_readings = infrastructure_phases(flexs, cuda_duplex, card, timings[100]["ms"])
    print(f"infrastructure readings: {json.dumps(infra_readings)}")

    stamps.append(("15 bench", time.perf_counter()))
    # 15. The measurement entry points' stages, small.
    bench_readings = bench_phases(cuda_duplex, card, tf_readings["fused_top"])
    print(f"bench readings: {json.dumps(bench_readings)}")

    stamps.append(("16 paper table, northstar", time.perf_counter()))
    # 16. The paper table, the north-star grid and its aggregator, small.
    paper_readings = paper_northstar_phases(flexs, cuda_duplex, card)
    print(f"paper table and northstar readings: {json.dumps(paper_readings)}")

    # Wall of each phase, so the script's time can be kept under 1,000 s.
    stamps.append(("end", time.perf_counter()))
    phase_walls = step_walls(stamps)
    print(f"phase walls (s): {json.dumps(phase_walls)}")

    # 17. Report: the main path's shape (B=100) at the top level, B=512 and
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
        "l100_bo_launches": explorer_readings["l100"]["bo"]["duplex_launches"],
        "l100_dynappo_launches": explorer_readings["l100"]["dynappo"]["duplex_launches"],
        "fused_l100_ga_launches": fused_readings["l100"]["ga"]["duplex_launches"],
        "fused_l100_bo_launches": fused_readings["l100"]["bo"]["duplex_launches"],
        "fused_bo_sweep_launches": fused_readings["sweeps"]["bo_l100"]["duplex_launches"],
        "fused_l100_ppo_launches": rl_readings["l100"]["ppo"]["duplex_launches"],
        "fused_l100_dynappo_launches": rl_readings["l100"]["dynappo"]["duplex_launches"],
        "fused_dqn_sweep_launches": rl_readings["sweeps"]["dqn_l100"]["duplex_launches"],
        "resumed_host_launches": infra_readings["resume_explorer"]["duplex_launches"],
        "traced_round_launches": infra_readings["profiling"]["traced_round_duplex_launches"],
        "native_check_launches": infra_readings["native"]["duplex_launches"],
        "bench_rna_oracle_launches": bench_readings["rna_oracle"]["duplex_launches"],
        "paper_table_northstar_launches": 0,  # phase 16 requires none
        "max_abs_err": max_diff,
        **timings[100],
        "library_ms": None,
        "at_B512": timings[512],
        "at_B4096": timings[4096],
    }]
    kernels += rowcost_kernels(cuda_duplex, rowcost, rc, rc_counts, fused_counts)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
