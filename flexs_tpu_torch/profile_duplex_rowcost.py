"""What a DP row of the duplex kernel costs, on one CUDA card.

    python -m flexs_tpu_torch.profile_duplex_rowcost

Counterpart of scripts/profile_duplex_rowcost.py.  The main path's kernel,
duplex_dp_kernel<16> (csrc/duplex_dp.cu), runs its DP rows in series, each
ending in a barrier, so its time is L1 times a per-row cost.  Each row-cost
build (`cuda_duplex.ROWCOST_BUILDS`) is that kernel with one suspected part
of the cost taken away or changed (csrc/duplex_rowcost.cu says how):

  baseline       the main kernel itself, the main path's library;
  const-rec      no per-row record loads (row 0's records on every row);
  carry-windows  window rows in registers, columns through warp shuffles:
                 no shared-memory rings and no per-row barrier;
  unrolled       compile-time L1 and the row loop unrolled by 2;
  no-barrier     only the per-row barrier removed, the rings kept;
  chains-1/-8    1 or 8 partial interior minima instead of 4;
  dpx            each candidate's add and min as one DPX instruction on the
                 f32 bit patterns;
  clocked        the baseline plus clock64() stamps at four points of each
                 row, split into parts by `clock_parts`;
  first          the first CUDA kernel (csrc/duplex_first.cu), the
                 yardstick of PERF.md's earlier readings.

The exact builds (`cuda_duplex.EXACT_VARIANTS`) must equal the plain version
bitwise; the others are wrong by design, serve for timing only, and must
give a finite f32[B].  The inputs are the JAX script's: calibrated
parameters, seed 0, a random reversed target of length 100 and tokens
int[4096, 100]; every build also runs at the main path's B=100 (the first
100 sequences).  The time is the kernel alone on prepared arguments (CUDA
events, median of TIMING_REPS means of TIMING_INNER launches through
`cuda_duplex.launcher`, whose checks are made once).  The script
prints, per batch and build, ms, us per row and the difference from
baseline in us per row, and the least time the card could take
(`bound_entry`); for clocked, the median cycles of each part of a row, the
SM clock read by its timer, and the parts' sum in us beside its own us per
row; per kernel function of each library, the SASS size, backward branches
(what nvcc left rolled) and the row loop's instructions and shared loads;
then one JSON line of the readings.  It needs a card; a build that fails to
build, launch or check raises, and the script exits nonzero.
"""
import ctypes
import json
import re
import shutil
import subprocess

import numpy as np
import torch

from flexs_tpu_torch.ops import cuda_duplex
from flexs_tpu_torch.ops import rna_duplex as rd

VARIANTS = cuda_duplex.VARIANTS
BUILDS = cuda_duplex.ROWCOST_BUILDS
SEED = 0
L2 = 100
BATCH, L1 = 4096, 100
MAIN_PATH_BATCH = 100
N_COMPARED = 64  # rows compared with the baseline, as the JAX script does
TIMING_REPS = 5
TIMING_INNER = 20
CLOCK_PARTS = ("interior", "bulges", "barrier", "next row")

# One H100 SXM at its 1,980 MHz boost clock: device memory at 3.35 TB/s
# (NVIDIA data sheet); per SM and clock, four schedulers issue one warp
# instruction each (128 thread-instructions), FADD runs at 128 and FMNMX
# (compare, minimum, maximum) at 64 (CUDA C++ Programming Guide, throughput
# of native arithmetic instructions, compute capability 9.0).
HBM_BYTES_PER_S = 3.35e12
_SM_CLOCKS_PER_S = 132 * 1.98e9
ISSUE_PER_S = 128 * _SM_CLOCKS_PER_S
FP32_ADD_PER_S = 128 * _SM_CLOCKS_PER_S
FP32_MIN_PER_S = 64 * _SM_CLOCKS_PER_S


def time_ms(fn, reps: int, inner: int) -> float:
    """Median over `reps` of the mean ms per call of `inner` back-to-back calls."""
    fn()  # warm up
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def seeded_inputs(device):
    """(tokens int[4096, 100], reversed target int[100], em, maxloop) from seed 0.

    The draws repeat the JAX script's: the target first, then the tokens,
    both as int32 from numpy's default_rng(0).
    """
    rng = np.random.default_rng(SEED)
    params = rd.DuplexParams.calibrated()
    target_rev = rng.integers(0, 4, L2, dtype=np.int32)[::-1].copy()
    tokens = rng.integers(0, 4, size=(BATCH, L1), dtype=np.int32)
    return (
        torch.as_tensor(tokens, device=device),
        torch.as_tensor(target_rev, device=device),
        params.energy_model(device),
        params.maxloop,
    )


def run_variant(tokens, target_rev, em, maxloop: int, variant: str):
    """Duplex energies f32[B] of int[B, L1] CUDA tokens vs int[L2], by one build."""
    cuda_duplex.check_variant(variant, tokens.shape[-1], maxloop)
    if tokens.device.type != "cuda":
        raise ValueError(f"run_variant needs CUDA tensors, got {tokens.device}")
    if variant == cuda_duplex.FIRST:
        args, dims = cuda_duplex.prepare(tokens, target_rev[None], em, maxloop)
        return cuda_duplex.launch(args, dims)[:, 0]
    plan = cuda_duplex.make_plan(target_rev[None], em, maxloop)
    stamps = None
    if variant == "clocked":
        stamps = cuda_duplex.clock_buffers(tokens.shape[-1], plan.l2, tokens.device)
    return cuda_duplex.launch_variant(plan, tokens, variant, stamps)[:, 0]


def dp_operations(b: int, n_t: int, l1: int, l2: int, maxloop: int) -> dict:
    """f32 adds and mins the duplex DP does over B x T x L1 x L2 cells.

    The unpairable-cell mask (a compare and select) counts as a min.
    """
    interior = sum(
        1 for r in range(1, maxloop + 1) for dj in range(2, maxloop + 2)
        if r + dj - 1 <= maxloop and not (r == 1 and dj == 2)
    )
    bulges = 2 * (maxloop - 1)
    candidates = 4 + interior + bulges  # direct, interior and bulge: an add and a min each
    adds = candidates + 2 + 1 + 2  # + mB, + AU; + CLOSE; the two pushed window channels
    mins = candidates + 2 + 1 + 1  # the mB and AU terms; the running best; the mask
    cells = b * n_t * l1 * l2
    return {"adds": cells * adds, "mins": cells * mins}


def bound_entry(n_bytes: int, dims) -> dict:
    """The least time the card could take for one DP launch of `dims`.

    The larger of moving `n_bytes` once at the memory rate and doing the
    DP's adds and mins: each at its own rate, and together at the rate the
    schedulers issue instructions.
    """
    ops = dp_operations(*dims)
    op_s = max((ops["adds"] + ops["mins"]) / ISSUE_PER_S, ops["adds"] / FP32_ADD_PER_S,
               ops["mins"] / FP32_MIN_PER_S)
    bound = {"bytes": n_bytes / HBM_BYTES_PER_S * 1e3, "operations": op_s * 1e3}
    bound_by = max(bound, key=bound.get)
    return {"bound_ms": bound[bound_by], "bound_by": bound_by, "n_bytes": n_bytes,
            "adds": ops["adds"], "mins": ops["mins"]}


def row_cost(ms: float, l1: int, baseline_ms: float) -> dict:
    """us per DP row of a launch of `ms`, and its difference from the baseline's."""
    us = ms * 1e3 / l1
    return {"us_per_row": us, "us_per_row_vs_baseline": us - baseline_ms * 1e3 / l1}


def clock_parts(stamps, timer) -> dict:
    """The clocked build's stamps, as median cycles per part of a DP row.

    `stamps` int64[2, warps, L1, 4] and `timer` int64[2, 2] come from
    `cuda_duplex.clock_buffers` after a launch; a block that wrote nothing
    (the second, when the grid has one block) is left out.  Part k < 3 of
    row i runs from stamp k to stamp k + 1; part 3 from stamp 3 of row i to
    stamp 0 of row i + 1.  Returns each part's median over rows and warps
    (CLOCK_PARTS order), the median row, the SM clock in MHz from the
    timer's cycles over its nanoseconds, and the parts' sum in us.
    """
    s = np.asarray(stamps, dtype=np.int64)
    s = s[[blk for blk in range(s.shape[0]) if s[blk].any()]]
    if s.size == 0 or s.shape[2] < 2:
        raise ValueError("the clocked build wrote no stamps over two rows")
    parts = [s[..., k + 1] - s[..., k] for k in range(3)]
    parts.append(s[..., 1:, 0] - s[..., :-1, 3])
    medians = [float(np.median(p)) for p in parts]
    t = np.asarray(timer, dtype=np.int64)
    cycles, ns = int(t[1, 0] - t[0, 0]), int(t[1, 1] - t[0, 1])
    if cycles <= 0 or ns <= 0:
        raise ValueError(f"the clocked build's timer is not running: {t.tolist()}")
    mhz = cycles / ns * 1e3
    return {
        "cycles": dict(zip(CLOCK_PARTS, medians)),
        "row_cycles": float(np.median(s[..., 1:, 0] - s[..., :-1, 0])),
        "sm_clock_mhz": mhz,
        "parts_us_per_row": sum(medians) / mhz,
        "blocks": int(s.shape[0]), "warps": int(s.shape[1]),
    }


def plan_bytes(plan, tokens) -> int:
    """Bytes the main kernel reads and writes: tokens, the plan, the output."""
    tensors = (tokens, plan.t3g, plan.t2g, plan.open_col0, plan.close_coll, plan.open_row0,
               plan.close_rowl, plan.t_past, plan.t_fut)
    n_out = tokens.shape[0] * plan.n_targets * 4
    n_costs = ctypes.sizeof(plan.host_costs)
    return sum(x.numel() * x.element_size() for x in tensors) + n_costs + n_out


def _checked(v: str, out, plain, b: int):
    if out.shape != (b,) or out.dtype != torch.float32 or not torch.isfinite(out).all():
        raise AssertionError(f"{v} at B={b}: output is not a finite f32[{b}]")
    if v in cuda_duplex.EXACT_VARIANTS and not torch.equal(out, plain):
        raise AssertionError(f"{v} != plain version at B={b}: "
                             f"max |diff| {float((out - plain).abs().max())}")


def measure(tokens, target_rev, em, maxloop: int):
    """Run, check and time every build at B=BATCH and B=MAIN_PATH_BATCH.

    Each batch is the first b rows of `tokens`.  Returns, per b, a dict of
    the kernel's `dims`, the plain version's `plain_ms` (timed once per
    batch), `builds`: per build its ms, seq_per_s, `row_cost`,
    max_abs_err (vs the plain version), equal_to_baseline, correct (its
    first N_COMPARED rows equal the baseline's, the JAX script's check) and
    `bound_entry` (the plan's bytes; `first`'s own arguments' for it), and
    `clocked`: `clock_parts` of the clocked build's last timed launch.
    Raises AssertionError unless every output is a finite f32[b] and every
    exact build equals the plain version bitwise.
    """
    readings = {}
    plan = cuda_duplex.make_plan(target_rev[None], em, maxloop)
    for b in (BATCH, MAIN_PATH_BATCH):
        seqs = tokens[:b]
        args, dims = cuda_duplex.prepare(seqs, target_rev[None], em, maxloop)
        stamps = cuda_duplex.clock_buffers(seqs.shape[1], plan.l2, seqs.device)
        # Each build launched by a bound launcher: the checks are made once,
        # so the B=100 times are the kernel's, not a wrapper call's host work.
        launchers = {
            v: cuda_duplex.launcher(plan, seqs, v, stamps if v == "clocked" else None)
            for v in BUILDS if v != cuda_duplex.FIRST
        }
        launchers[cuda_duplex.FIRST] = (args[-1], lambda: cuda_duplex.launch(args, dims))
        outputs = {}
        for v, (out, launch) in launchers.items():
            launch()
            outputs[v] = out[:, 0]

        def plain_fn():
            return cuda_duplex.duplex_energies_plain(seqs, target_rev[None], em, maxloop)

        plain = plain_fn()[:, 0]
        torch.cuda.synchronize()
        for v, out in outputs.items():
            _checked(v, out, plain, b)

        base = outputs["baseline"]
        ms = {v: time_ms(launch, TIMING_REPS, TIMING_INNER)
              for v, (_, launch) in launchers.items()}
        on_plan = bound_entry(plan_bytes(plan, seqs), dims)
        n_first = sum(a.numel() * a.element_size() for a in args)
        builds = {}
        for v, out in outputs.items():
            builds[v] = {
                "ms": ms[v], "seq_per_s": b / ms[v] * 1e3,
                **row_cost(ms[v], dims[2], ms["baseline"]),
                "max_abs_err": float((out - plain).abs().max()),
                "equal_to_baseline": torch.equal(out, base),
                "correct": torch.equal(out[:N_COMPARED], base[:N_COMPARED]),
                **(bound_entry(n_first, dims) if v == cuda_duplex.FIRST else on_plan),
            }
        torch.cuda.synchronize()
        readings[b] = {
            "dims": dims,
            "plain_ms": time_ms(plain_fn, TIMING_REPS, 1),
            "builds": builds,
            "clocked": clock_parts(stamps[0].cpu(), stamps[1].cpu()),
        }
    return readings


def parse_sass(sass: str) -> dict:
    """Instruction count (NOPs left out), size and backward branches of SASS text.

    `sass` is `cuobjdump -sass` output: one `/*addr*/ INSTR ... ;` per
    instruction.  The size in bytes runs to the end of the last instruction,
    NOP padding included.  A loop that nvcc left rolled ends in a branch to
    a lower address; a branch to its own address (the trap after EXIT) is
    not one.
    """
    instructions, backward, end = 0, 0, 0
    for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", sass):
        addr, text = int(m.group(1), 16), m.group(2).strip()
        end = max(end, addr + 16)
        if re.search(r"\bNOP\b", text):
            continue
        instructions += 1
        if re.search(r"\bBRA\b", text):
            target = re.search(r"0x([0-9a-f]+)\s*$", text)
            if target is None:
                raise ValueError(f"branch target not understood: {text!r}")
            backward += int(target.group(1), 16) < addr
    if instructions == 0:
        raise ValueError("no SASS instructions found")
    return {"instructions": instructions, "bytes": end, "backward_branches": backward}


def longest_loop(sass: str) -> dict:
    """The widest backward branch's span: its instructions, its shared loads
    (LDS), and how far ahead of their use those loads are issued.

    That span is a kernel's DP row loop; a loop that nvcc unrolled a few
    rows deep counts those rows together.  `loop_load_use` is the median
    number of instructions from an LDS to the first instruction that reads
    its destination register, and `loop_loads_in_flight` the most LDS
    issued and not yet read at any point: with one warp per scheduler they
    say how much of the shared-memory latency the schedule hides.
    """
    ins = [(int(a, 16), t.strip()) for a, t in
           re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", sass) if not re.search(r"\bNOP\b", t)]
    spans = [(int(m.group(1), 16), a) for a, t in ins
             if (m := re.search(r"\bBRA\b.*0x([0-9a-f]+)\s*$", t)) and int(m.group(1), 16) < a]
    if not spans:
        return {"loop_instructions": 0, "loop_shared_loads": 0, "loop_load_use": 0,
                "loop_loads_in_flight": 0}
    lo, hi = max(spans, key=lambda s: s[1] - s[0])
    body = [t for a, t in ins if lo <= a <= hi]
    pending, distances, in_flight = {}, [], 0
    for k, text in enumerate(body):
        registers = re.findall(r"\bR(\d+)\b", text)
        for reg in set(registers[1:]) & set(pending):
            distances.append(k - pending.pop(reg))
        if re.search(r"\bLDS\b", text) and registers:
            pending[registers[0]] = k
        in_flight = max(in_flight, len(pending))
    return {"loop_instructions": len(body),
            "loop_shared_loads": sum(bool(re.search(r"\bLDS\b", t)) for t in body),
            "loop_load_use": float(np.median(distances)) if distances else 0.0,
            "loop_loads_in_flight": in_flight}


def sass_summary(build: str) -> dict:
    """Per kernel function of a build's library (built first if needed):
    parse_sass and longest_loop.  `build` is cuda_duplex.MAIN or a row-cost build."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    lib_path, _ = cuda_duplex.build(build)
    proc = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True, text=True,
                          check=True)
    summary = {}
    for part in proc.stdout.split("Function : ")[1:]:
        m = re.search(r"duplex_dp_kernelILi(\d+)E", part.splitlines()[0])
        name = f"<{m.group(1)}>" if m else "duplex_dp_kernel"
        summary[name] = {**parse_sass(part), **longest_loop(part)}
    return summary


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_duplex_rowcost needs a CUDA card")
    dev = torch.device("cuda", torch.cuda.current_device())
    tokens, target_rev, em, maxloop = seeded_inputs(dev)
    readings = measure(tokens, target_rev, em, maxloop)
    for b, batch in readings.items():
        for v, r in batch["builds"].items():
            print(f"{v:14s} B={b:5d}: {r['ms']:9.5f} ms ({r['us_per_row']:7.4f} us/row, "
                  f"{r['us_per_row_vs_baseline']:+8.4f} vs baseline)  "
                  f"{'== plain' if v in cuda_duplex.EXACT_VARIANTS else 'timing only'}",
                  flush=True)
        r = batch["builds"]["baseline"]
        print(f"{'plain':14s} B={b:5d}: {batch['plain_ms']:9.4f} ms; bound {r['bound_ms']:.5f} "
              f"ms ({r['bound_by']}; {r['adds']} adds, {r['mins']} mins)", flush=True)
        c = batch["clocked"]
        print(f"clocked        B={b:5d}: median cycles per row "
              + ", ".join(f"{k} {v:.0f}" for k, v in c["cycles"].items())
              + f" (row {c['row_cycles']:.0f}); SM clock {c['sm_clock_mhz']:.0f} MHz; parts "
              f"{c['parts_us_per_row']:.4f} us/row vs {batch['builds']['clocked']['us_per_row']:.4f}"
              " timed", flush=True)
    # "baseline" is MAIN's library.
    sass = {v: sass_summary(v) for v in (cuda_duplex.MAIN,) + BUILDS if v != "baseline"}
    for v, functions in sass.items():
        for name, s in functions.items():
            print(f"sass {v:14s} {name}: {s['instructions']} instructions ({s['bytes']} bytes), "
                  f"{s['backward_branches']} backward branches; row loop "
                  f"{s['loop_instructions']} instructions, {s['loop_shared_loads']} LDS, "
                  f"LDS to use {s['loop_load_use']} instructions (median), "
                  f"{s['loop_loads_in_flight']} LDS in flight at most", flush=True)

    print(json.dumps({
        "card": torch.cuda.get_device_name(0),
        "l1": L1, "l2": L2, "maxloop": maxloop,
        "exact_equals_plain": list(cuda_duplex.EXACT_VARIANTS),
        "readings": [
            {"variant": v, "batch": b, "plain_ms": batch["plain_ms"], **r}
            for b, batch in readings.items() for v, r in batch["builds"].items()
        ],
        "clocked": [{"batch": b, **batch["clocked"]} for b, batch in readings.items()],
        "sass": sass,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
