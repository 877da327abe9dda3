"""What the duplex kernel's per-row time is made of, on one CUDA card.

    python -m flexs_tpu_torch.profile_duplex_rowcost

Counterpart of scripts/profile_duplex_rowcost.py.  The first CUDA kernel
(csrc/duplex_rowcost.cu) runs its DP rows in series, so its time is L1
times a per-row cost.  Each knockout build of that source
(`cuda_duplex.VARIANTS`) takes one suspected part of that cost away:

  baseline       the first kernel, unchanged;
  const-rec      no dependent per-row record loads (constant grams and
                 column patches);
  carry-windows  window rows in registers, columns through warp shuffles,
                 no shared-memory rings and no per-row barrier;
  unrolled       compile-time L1 and maxloop, all loops marked for
                 unrolling, so every ring slot and index can be static.

const-rec and carry-windows are wrong by design and serve for timing only;
baseline and unrolled (`cuda_duplex.EXACT_VARIANTS`) must equal the plain
version bitwise.  The inputs are the JAX script's: calibrated parameters,
seed 0, a random reversed target of length 100 and tokens int[4096, 100].
Each variant also runs at the main path's B=100 (the first 100
sequences).  Beside the four builds, at both batches, stands the main
path's redesigned kernel (csrc/duplex_dp.cu, launched on a
`cuda_duplex.DuplexPlan`), held bitwise to the plain version too; it is a
reading, not a variant.  The time is the kernel alone on prepared
arguments (CUDA events, median of TIMING_REPS means of TIMING_INNER
launches).  The script
prints a table, then per kernel function of each build (the redesign's
template instances included) the SASS size, backward branches (what nvcc
left rolled) and the row loop's instructions and shared loads, then one
JSON line of the readings.  It needs a
card; a variant that fails to build, launch or check raises, and the
script exits nonzero.
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
SEED = 0
L2 = 100
BATCH, L1 = 4096, 100
MAIN_PATH_BATCH = 100
N_COMPARED = 64  # rows compared with the baseline, as the JAX script does
TIMING_REPS = 5
TIMING_INNER = 20


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
    args, dims = cuda_duplex.prepare(tokens, target_rev[None], em, maxloop)
    return cuda_duplex.launch(args, dims, variant)[:, 0]


def measure(tokens, target_rev, em, maxloop: int):
    """Run, check and time every variant at B=BATCH and B=MAIN_PATH_BATCH.

    Each batch is the first b rows of `tokens`.  Returns, per b, a dict of
    the kernel's `dims`, its argument bytes `n_bytes`, the plain version's
    `plain_ms` (timed once per batch), `variants`: per variant its ms,
    seq_per_s, us_per_row, max_abs_err (vs the plain version),
    equal_to_baseline, and correct (its first N_COMPARED rows equal the
    baseline's, the JAX script's check), and `redesign`: the same readings
    of the main path's kernel (`measure_redesign`).  Raises AssertionError unless every output is a
    finite f32[b] and every exact build and the redesign equal the plain
    version bitwise.
    """
    readings = {}
    plan = cuda_duplex.make_plan(target_rev[None], em, maxloop)
    for b in (BATCH, MAIN_PATH_BATCH):
        seqs = tokens[:b]
        outputs = {v: run_variant(seqs, target_rev, em, maxloop, v) for v in VARIANTS}

        def plain_fn():
            return cuda_duplex.duplex_energies_plain(seqs, target_rev[None], em, maxloop)

        plain = plain_fn()[:, 0]
        torch.cuda.synchronize()
        base = outputs["baseline"]
        for v, out in outputs.items():
            if out.shape != (b,) or out.dtype != torch.float32 or not torch.isfinite(out).all():
                raise AssertionError(f"{v} at B={b}: output is not a finite f32[{b}]")
            if v in cuda_duplex.EXACT_VARIANTS and not torch.equal(out, plain):
                raise AssertionError(
                    f"{v} != plain version at B={b}: "
                    f"max |diff| {float((out - plain).abs().max())}"
                )

        args, dims = cuda_duplex.prepare(seqs, target_rev[None], em, maxloop)
        variants = {}
        for v in VARIANTS:
            ms = time_ms(lambda: cuda_duplex.launch(args, dims, v), TIMING_REPS, TIMING_INNER)
            out = outputs[v]
            variants[v] = {
                "ms": ms, "seq_per_s": b / ms * 1e3, "us_per_row": ms * 1e3 / dims[2],
                "max_abs_err": float((out - plain).abs().max()),
                "equal_to_baseline": torch.equal(out, base),
                "correct": torch.equal(out[:N_COMPARED], base[:N_COMPARED]),
            }
        readings[b] = {
            "dims": dims,
            "n_bytes": sum(a.numel() * a.element_size() for a in args),
            "plain_ms": time_ms(plain_fn, TIMING_REPS, 1),
            "variants": variants,
            "redesign": measure_redesign(plan, seqs, plain, base),
        }
    return readings


def plan_bytes(plan, tokens) -> int:
    """Bytes the redesigned kernel reads and writes: tokens, the plan, the output."""
    tensors = (tokens, plan.t3g, plan.t2g, plan.open_col0, plan.close_coll, plan.open_row0,
               plan.close_rowl, plan.t_past, plan.t_fut)
    n_out = tokens.shape[0] * plan.n_targets * 4
    n_costs = ctypes.sizeof(plan.host_costs)
    return sum(x.numel() * x.element_size() for x in tensors) + n_costs + n_out


def measure_redesign(plan, seqs, plain, base) -> dict:
    """Check and time the main path's kernel on `plan` against f32[b] `plain`."""
    b = seqs.shape[0]
    out = cuda_duplex.launch_plan(plan, seqs)[:, 0]
    torch.cuda.synchronize()
    if not torch.equal(out, plain):
        raise AssertionError(
            f"the redesigned kernel != plain version at B={b}: "
            f"max |diff| {float((out - plain).abs().max())}"
        )
    ms = time_ms(lambda: cuda_duplex.launch_plan(plan, seqs), TIMING_REPS, TIMING_INNER)
    return {
        "ms": ms, "seq_per_s": b / ms * 1e3, "us_per_row": ms * 1e3 / seqs.shape[1],
        "max_abs_err": float((out - plain).abs().max()),
        "equal_to_baseline": torch.equal(out, base), "n_bytes": plan_bytes(plan, seqs),
    }


def parse_sass(sass: str) -> dict:
    """Instruction count (NOPs left out) and backward branches of SASS text.

    `sass` is `cuobjdump -sass` output: one `/*addr*/ INSTR ... ;` per
    instruction.  A loop that nvcc left rolled ends in a branch to a lower
    address; a branch to its own address (the trap after EXIT) is not one.
    """
    instructions, backward = 0, 0
    for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", sass):
        addr, text = int(m.group(1), 16), m.group(2).strip()
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
    return {"instructions": instructions, "backward_branches": backward}


def longest_loop(sass: str) -> dict:
    """Instructions and shared loads (LDS) in the widest backward branch's span.

    That span is a kernel's DP row loop; a loop that nvcc unrolled a few
    rows deep counts those rows together.
    """
    ins = [(int(a, 16), t.strip()) for a, t in
           re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", sass) if not re.search(r"\bNOP\b", t)]
    spans = [(int(m.group(1), 16), a) for a, t in ins
             if (m := re.search(r"\bBRA\b.*0x([0-9a-f]+)\s*$", t)) and int(m.group(1), 16) < a]
    if not spans:
        return {"loop_instructions": 0, "loop_shared_loads": 0}
    lo, hi = max(spans, key=lambda s: s[1] - s[0])
    body = [t for a, t in ins if lo <= a <= hi]
    return {"loop_instructions": len(body),
            "loop_shared_loads": sum(bool(re.search(r"\bLDS\b", t)) for t in body)}


def sass_summary(build: str) -> dict:
    """Per kernel function of a build's library (built first if needed):
    parse_sass and longest_loop.  `build` is cuda_duplex.MAIN or a variant."""
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
        for v, r in batch["variants"].items():
            print(f"{v:14s} B={b:5d}: {r['ms']:9.4f} ms ({r['seq_per_s']:10.0f} seq/s, "
                  f"{r['us_per_row']:7.3f} us/row)  correct={r['correct']}", flush=True)
        r = batch["redesign"]
        print(f"{'duplex_dp':14s} B={b:5d}: {r['ms']:9.4f} ms "
              f"({r['seq_per_s']:10.0f} seq/s, {r['us_per_row']:7.3f} us/row)  "
              f"equal to plain", flush=True)
        print(f"{'plain':14s} B={b:5d}: {batch['plain_ms']:9.4f} ms", flush=True)
    sass = {v: sass_summary(v) for v in (cuda_duplex.MAIN,) + VARIANTS}
    for v, functions in sass.items():
        for name, s in functions.items():
            print(f"sass {v:14s} {name}: {s['instructions']} instructions, "
                  f"{s['backward_branches']} backward branches; row loop "
                  f"{s['loop_instructions']} instructions, {s['loop_shared_loads']} LDS",
                  flush=True)

    print(json.dumps({
        "card": torch.cuda.get_device_name(0),
        "l1": L1, "l2": L2, "maxloop": maxloop,
        "exact_equals_plain": list(cuda_duplex.EXACT_VARIANTS),
        "readings": [
            {"variant": v, "batch": b, "plain_ms": batch["plain_ms"], **r}
            for b, batch in readings.items() for v, r in batch["variants"].items()
        ],
        "redesign": [{"batch": b, **batch["redesign"]} for b, batch in readings.items()],
        "sass": sass,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
