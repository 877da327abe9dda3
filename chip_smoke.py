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
  5. row-cost knockouts: the path of `python -m
     flexs_tpu_torch.profile_duplex_rowcost`.  `profile_duplex_rowcost.
     measure` runs every build on the profiler's seeded inputs at B=4096
     and B=100, requires baseline and unrolled (and the redesigned kernel,
     timed beside them) to equal the plain version bitwise and const-rec
     and carry-windows (wrong by design) to give finite f32[B], and times
     each;
  6. print one JSON line describing each kernel, the card's name and power
     limit, and last the device JSON line.

Each path's phase sets the launch counters of every build to 0 just before
it and reads them just after; a phase in which one of its kernels never
launched fails, and so does a main-path run that launched a row-cost
build.  The script needs one CUDA card and imports nothing of JAX.
"""
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

    import flexs_tpu_torch as flexs
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

    # 1. Build every library at once, one nvcc each.
    builds = (cuda_duplex.MAIN,) + cuda_duplex.VARIANTS
    build_pool = ThreadPoolExecutor(max_workers=len(builds))
    pending = {v: build_pool.submit(timed_build, cuda_duplex, v) for v in builds}
    for v in builds:
        print_build(v, *pending[v].result())
    build_pool.shutdown()
    print(f"card: {card}")

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

    # 5. Row-cost builds: the profiler's run, check and timing of every
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

    # 6. Report: the main path's shape (B=100) at the top level, B=512 and
    # B=4096 beside it, and the same call's row-cost readings.
    kernels = [{
        "name": "duplex_dp",
        "route": "cuda",
        "source": "flexs_tpu_torch/csrc/duplex_dp.cu",
        "replaces": "flexs_tpu/ops/pallas_duplex.py:374",
        "launches": fused_counts[cuda_duplex.MAIN],
        "host_launches": host_counts[cuda_duplex.MAIN],
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
