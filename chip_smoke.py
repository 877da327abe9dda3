#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failed check raises, and the script exits nonzero):
  1. build the CUDA duplex kernel (flexs_tpu_torch/csrc/duplex_dp.cu) from
     this checkout with nvcc, and start the builds of its three row-cost
     knockouts beside it (one nvcc each, in threads);
  2. hold the kernel against its plain PyTorch version on the card, on
     numpy-seeded inputs at the main path's shapes and a few edge cases,
     requiring bitwise equality, and time both with CUDA events;
  3. run the fused main path: DeviceAdaleadNAM on RNABinding L100_RNA1
     (10 rounds x 100 proposals x 2000 model queries, NAM at signal
     strength 0.9) and check the run's invariants;
  4. run the host path: Adalead + NoisyAbstractModel on the same landscape
     for 3 rounds;
  5. row-cost knockouts: the path of `python -m
     flexs_tpu_torch.profile_duplex_rowcost`.  Wait for the knockout builds,
     then `profile_duplex_rowcost.measure` runs every variant on the
     profiler's seeded inputs at B=4096 and B=100, requires baseline and
     unrolled to equal the plain version bitwise and const-rec and
     carry-windows (wrong by design) to give finite f32[B], and times each;
  6. print one JSON line describing each kernel, the card's name and power
     limit, and last the device JSON line.

Each path's phase sets the launch counters of every build to 0 just before
it and reads them just after; a phase in which one of its kernels never
launched fails, and so does a main-path run that launched a knockout
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


def main_path_counts(cuda_duplex, path: str) -> dict:
    """Launch counts of a main path's run: the baseline build only, at least once."""
    counts = cuda_duplex.launch_counts()
    assert counts["baseline"] > 0, f"the {path} run never launched the duplex kernel"
    stray = {v: n for v, n in counts.items() if v != "baseline" and n}
    assert not stray, f"the {path} run launched knockout builds: {stray}"
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
    if kern.shape != plain.shape or not torch.isfinite(kern).all():
        raise AssertionError(f"kernel output {tuple(kern.shape)} is not finite/shaped")
    diff = float((kern - plain).abs().max())
    if not torch.equal(kern, plain):
        raise AssertionError(
            f"kernel != plain at B={tokens.shape[0]} L1={tokens.shape[1]} "
            f"T={targets_rev.shape[0]}: max |diff| {diff}"
        )
    return kern, plain, diff


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing was run",
              file=sys.stderr)
        return 1

    import flexs_tpu_torch as flexs
    from flexs_tpu_torch import profile_duplex_rowcost as rowcost
    from flexs_tpu_torch.landscapes import rna
    from flexs_tpu_torch.ops import cuda_duplex
    from flexs_tpu_torch.profile_duplex_rowcost import time_ms

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    rng = np.random.default_rng(SEED)
    reg = rna.registry()
    problem = reg["L100_RNA1"]
    start = problem["starts"][1]

    # 1. Build: the knockouts in threads, the main path's kernel meanwhile.
    knockouts = [v for v in cuda_duplex.VARIANTS if v != "baseline"]
    build_pool = ThreadPoolExecutor(max_workers=len(knockouts))
    knockout_builds = {v: build_pool.submit(timed_build, cuda_duplex, v) for v in knockouts}
    print_build("baseline", *timed_build(cuda_duplex, "baseline"))
    print(f"card: {card}")

    # 2. Kernel vs plain version on the card.
    land = rna.RNABinding(**problem["params"])
    targets_rev, em, _, _ = land.device_fitness()[1]
    maxloop = land.params.maxloop
    cases = []
    max_diff = 0.0

    def random_tokens(b, l1):
        return torch.as_tensor(rng.integers(0, 4, (b, l1)), device="cuda")

    for b, l1 in [(100, 100), (512, 100), (64, 50), (64, 14)]:
        _, _, diff = kernel_vs_plain(cuda_duplex, random_tokens(b, l1), targets_rev, em, maxloop)
        max_diff = max(max_diff, diff)
        cases.append(f"B={b},L1={l1},T=1")
    two = rna.RNABinding(**reg["L100_RNA1+2"]["params"])
    _, _, diff = kernel_vs_plain(
        cuda_duplex, random_tokens(100, 100), two.device_fitness()[1][0], em, maxloop
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

    # Timing at the main path's shape (B=100) and a wider batch (B=512).
    # The kernel alone is timed on prepared arguments; the wrapper's time
    # adds its torch prep.
    reps, inner = rowcost.TIMING_REPS, rowcost.TIMING_INNER
    timings = {}
    for b in (100, 512):
        tokens = random_tokens(b, 100)
        args, dims = cuda_duplex.prepare(tokens, targets_rev, em, maxloop)
        entry = {
            "ms": time_ms(lambda: cuda_duplex.launch(args, dims), reps, inner),
            "plain_ms": time_ms(
                lambda: cuda_duplex.duplex_energies_plain(tokens, targets_rev, em, maxloop),
                reps, 1),
            **bound_entry(sum(a.numel() * a.element_size() for a in args), dims),
            "wrapper_ms": time_ms(
                lambda: cuda_duplex.duplex_energies(tokens, targets_rev, em, maxloop),
                reps, inner),
        }
        timings[b] = entry
        print(f"timing B={b}, T=1, L1=L2=100: kernel {entry['ms']} ms, "
              f"wrapper {entry['wrapper_ms']} ms, plain {entry['plain_ms']} ms, "
              f"bound {entry['bound_ms']} ms ({entry['bound_by']}; "
              f"{entry['n_bytes']} bytes, {entry['operations']} operations)")

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
    fused_counts = main_path_counts(cuda_duplex, "fused")
    queries = int(df["model_cost"].max()) + (land.cost - cost_before)
    check_run_frame(df, 10, 100, 2000, start, per_round=100)
    truth = land.get_fitness(df["sequence"].tolist())
    truth_diff = float(np.abs(df["true_score"].to_numpy() - truth).max())
    assert truth_diff <= 1e-6, truth_diff
    fused_top = float(df["true_score"].max())
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
    host_counts = main_path_counts(cuda_duplex, "host")
    check_run_frame(df_host, 3, 100, 2000, start, per_round=99)
    host_top = float(df_host["true_score"].max())
    print(f"host: wall {host_wall} s, top true_score {host_top}, "
          f"kernel launches {host_counts}, rows {len(df_host)}")

    # 5. Row-cost knockouts: the profiler's run, check and timing of every
    # build on its seeded inputs.
    for v in knockouts:
        print_build(v, *knockout_builds[v].result())
    build_pool.shutdown()
    cuda_duplex.reset_launch_counts()
    rc = rowcost.measure(*rowcost.seeded_inputs("cuda"))
    torch.cuda.synchronize()
    rc_counts = cuda_duplex.launch_counts()
    silent = [v for v, n in rc_counts.items() if n == 0]
    assert not silent, f"the row-cost path never launched {silent}"
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
    print(f"row-cost: {list(cuda_duplex.EXACT_VARIANTS)} == plain (bitwise) at "
          f"B={tuple(rc)}; launches {rc_counts}")

    # 6. Report: the main path's shape (B=100) at the top level, B=512 beside it.
    kernels = [{
        "name": "duplex_dp",
        "route": "cuda",
        "source": "flexs_tpu_torch/csrc/duplex_dp.cu",
        "replaces": "flexs_tpu/ops/pallas_duplex.py:374",
        "launches": fused_counts["baseline"],
        "host_launches": host_counts["baseline"],
        "max_abs_err": max_diff,
        **timings[100],
        "library_ms": None,
        "at_B512": timings[512],
    }]
    # The row-cost builds: the profiler's B=4096 at the top level, B=100
    # beside it; `launches` counts the row-cost phase, `fused_launches` the
    # fused run.
    for v in cuda_duplex.VARIANTS:
        exact = v in cuda_duplex.EXACT_VARIANTS
        kernels.append({
            "name": f"duplex_rowcost_{v.replace('-', '_')}",
            "route": "cuda",
            "source": "flexs_tpu_torch/csrc/duplex_dp.cu",
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
