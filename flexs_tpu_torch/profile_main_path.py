"""Where the fused main path's time goes, on one CUDA card.

    python -m flexs_tpu_torch.profile_main_path

Runs DeviceAdaleadNAM on RNABinding L100_RNA1 (100 proposals x 2000 model
queries per round, NAM at signal strength 0.9, seed 0) five times: once
to warm up (it builds and loads the kernel), once timed without the
profiler, once under `torch.profiler` for the kernels, once more under it
with a span around each kernel-side call of the run, and once without it
with the program's own spans on.  Then it runs one
40-cell chunk of the TF-Bind-8 robustness sweep (8 landscapes x 5 signal
strengths, the same per-cell configuration, as `chip_smoke.py` runs it):
once to warm up at one round, once timed, and once more with the profiler
on for its last two rounds only, where the caches and so the distance
matrices are widest (all ten rounds make a million profiler events, which
take minutes to process).  The chunk's device time and idle share are
read from that window; its host syncs and draw calls from the timed run.
Prints one JSON line: the walls, the summed device time of all kernels,
the device's idle share (1 - kernel time / wall; kernels run on one
stream, so they never overlap) against the profiled and the unprofiled
wall, the duplex kernel's launches and device time, the top kernels by
device time, each span's calls and host seconds (a span's time includes
the spans nested in it; the spans slow the run, so compare spans with each
other and with the spanned wall), and for the sweep chunk its host syncs
and the calls and host seconds of its per-cell random draws.  The rounds,
NAM queries and mutant searches are the program's own spans
(`utils.profiling.span`), read from its span table by name with their
self time; the calls into `packed_hamming` and `cuda_duplex`, which carry
no program span, are spanned here, for that run only, by replacing each
attribute in SPANS.  The script fails if a span's attribute is gone or the
run never called it, so a renamed method cannot drop out of the table.
"""
import contextlib
import functools
import itertools
import json
import time
from typing import NamedTuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

import flexs_tpu_torch as flexs
from flexs_tpu_torch.landscapes import rna, tf_binding
from flexs_tpu_torch.ops import cuda_duplex, packed_hamming
from flexs_tpu_torch.parallel import run_robustness_sweep
from flexs_tpu_torch.runtime import jit_runner
from flexs_tpu_torch.utils import profiling

ROUNDS = 10  # the main path's full run, as chip_smoke.py drives it
TOP_KERNELS = 12
SWEEP_CHUNK_LANDSCAPES = 8  # x 5 signal strengths: one chunk of chip_smoke.py's sweep
PROFILED_ROUNDS = 2  # the chunk's last rounds, profiled
DRAW_OPS = ("aten::exponential_", "aten::random_", "aten::uniform_", "aten::randperm")

# The program's spans reported (`utils.profiling.span` names).
PROGRAM_SPANS = ("flexs.round", "flexs.nam_query", "flexs.mutants")

# Span label -> (owner, attribute).  Callers look these up on the owner at
# call time, so replacing the attribute puts the span around every call.
SPANS = {
    "packed_hamming.pack_tokens": (packed_hamming, "pack_tokens"),
    "packed_hamming.masked_hamming_matrix": (packed_hamming, "masked_hamming_matrix"),
    "duplex.duplex_energies": (cuda_duplex, "duplex_energies"),
    "duplex.launch_plan": (cuda_duplex, "launch_plan"),
}


def _traced(label, fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with record_function(label):
            return fn(*args, **kwargs)

    return wrapper


@contextlib.contextmanager
def spans_installed(wrap=_traced):
    """Replace each attribute in SPANS by `wrap(label, original)` while inside."""
    missing = [label for label, (owner, attr) in SPANS.items() if not hasattr(owner, attr)]
    if missing:
        raise AttributeError(f"span targets not found: {missing}")
    originals = {label: getattr(owner, attr) for label, (owner, attr) in SPANS.items()}
    for label, (owner, attr) in SPANS.items():
        setattr(owner, attr, wrap(label, originals[label]))
    try:
        yield
    finally:
        for label, (owner, attr) in SPANS.items():
            setattr(owner, attr, originals[label])


def program_spans(run) -> dict:
    """Calls, host and self seconds of each program span over `run()`, by name, untraced."""
    profiling.reset_spans()
    profiling.enable_spans(True)
    try:
        run()
    finally:
        profiling.enable_spans(False)
    return {name: {"calls": t["calls"], "host_s": t["total_s"], "self_s": t["self_s"]}
            for name, t in profiling.span_totals().items()}


def _timed_run(runner) -> float:
    t0 = time.perf_counter()
    runner.run(verbose=False)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


class DeviceTotal(NamedTuple):
    """One name's work on the card: `key`, `count` launches, device time in us."""

    key: str
    count: int
    self_device_time_total: float


def device_kernels(prof):
    """The kernels (and copies) a finished `torch.profiler.profile` saw on the card.

    One entry per name, longest first, summed from the profiler's raw
    events: `prof.key_averages()` builds a Python object and a call tree
    for every event, which took 111 s for the half million events of one
    profiled surrogate run on an H100's host (PERF.md).
    """
    totals = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            count, ns = totals.get(e.name(), (0, 0))
            totals[e.name()] = (count + 1, ns + e.duration_ns())
    kernels = [DeviceTotal(name, count, ns / 1e3) for name, (count, ns) in totals.items() if ns]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    return kernels


def top_kernels(kernels):
    return [
        {"name": e.key[:80], "count": e.count, "device_s": e.self_device_time_total / 1e6}
        for e in kernels[:TOP_KERNELS]
    ]


@contextlib.contextmanager
def before_each_round(fn):
    """Call `fn(k)` before the k-th call of `_Run.round` (from 0) while inside."""
    original = jit_runner._Run.round
    calls = itertools.count()

    @functools.wraps(original)
    def round_(run):
        fn(next(calls))
        return original(run)

    jit_runner._Run.round = round_
    try:
        yield
    finally:
        jit_runner._Run.round = original


def sweep_chunk_profile() -> dict:
    """Wall, device time and random-draw cost of one 40-cell sweep chunk."""
    names = list(tf_binding.registry())[:SWEEP_CHUNK_LANDSCAPES]
    first_profiled = ROUNDS - PROFILED_ROUNDS

    def chunk(on_window=None, rounds=ROUNDS):
        """(wall, wall of the last PROFILED_ROUNDS rounds) of one chunk."""
        window = {}

        def mark(k):
            if k == first_profiled:
                torch.cuda.synchronize()
                window["t0"] = time.perf_counter()
                if on_window is not None:
                    on_window()

        t0 = time.perf_counter()
        with before_each_round(mark):
            run_robustness_sweep(names, tf_binding.STARTS[:1], rounds=rounds)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        return t1 - t0, t1 - window.get("t0", t0)

    chunk(rounds=1)  # warm-up
    jit_runner.reset_run_counts()
    wall, window_wall = chunk()
    counts = dict(jit_runner.run_counts)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    _, profiled_window_wall = chunk(on_window=prof.start)
    prof.stop()
    events = prof.key_averages()
    kernels = device_kernels(prof)
    device_s = sum(e.self_device_time_total for e in kernels) / 1e6
    draws = [e for e in events if e.key in DRAW_OPS]
    return {
        "cells": 5 * len(names),
        "wall_s": wall,
        "profiled_rounds": PROFILED_ROUNDS,
        "window_wall_s": window_wall,
        "profiled_window_wall_s": profiled_window_wall,
        "device_kernel_s": device_s,
        "device_idle_share": 1 - device_s / profiled_window_wall if device_s else None,
        "device_idle_share_vs_unprofiled_wall": 1 - device_s / window_wall if device_s else None,
        "kernel_launches_total": sum(e.count for e in kernels),
        "host_syncs": counts["syncs"],  # of the whole timed chunk
        "draw_calls": counts["draw_calls"],
        "draw_ops": {e.key: {"calls": e.count, "host_s": e.cpu_time_total / 1e6} for e in draws},
        "top_kernels": top_kernels(kernels),
    }


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_main_path needs a CUDA card")

    problem = rna.registry()["L100_RNA1"]
    landscape = rna.RNABinding(**problem["params"])
    runner = flexs.runtime.DeviceAdaleadNAM(
        landscape, flexs.RNAA, rounds=ROUNDS, sequences_batch_size=100,
        model_queries_per_batch=2000, starting_sequence=problem["starts"][1],
        signal_strength=0.9, seed=0,
    )
    _timed_run(runner)  # warm-up
    wall = _timed_run(runner)

    cuda_duplex.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled_wall = _timed_run(runner)
    duplex_launches = cuda_duplex.launches
    kernels = device_kernels(prof)
    device_s = sum(e.self_device_time_total for e in kernels) / 1e6
    # The main path's kernel is a template (duplex_dp_kernel<M, K>); the
    # row-cost builds' untemplated kernel of the same name never runs here.
    duplex = [e for e in kernels if "duplex_dp_kernel<" in e.key]
    if device_s and duplex_launches and not duplex:
        raise SystemExit("the profiler saw device time but no duplex_dp_kernel<...> entry")

    with spans_installed(), profile(activities=[ProfilerActivity.CPU]) as prof:
        spanned_wall = _timed_run(runner)
    spans = {
        e.key: {"calls": e.count, "host_s": e.cpu_time_total / 1e6}
        for e in prof.key_averages()
        if e.key in SPANS
    }
    program = program_spans(lambda: _timed_run(runner))
    silent = [label for label in SPANS if spans.get(label, {}).get("calls", 0) == 0]
    silent += [name for name in PROGRAM_SPANS if name not in program]
    if silent:
        raise SystemExit(f"spans that recorded no calls: {silent}")

    print(json.dumps({
        "card": torch.cuda.get_device_name(0),
        "rounds": ROUNDS,
        "wall_s": wall,
        "profiled_wall_s": profiled_wall,
        "spanned_wall_s": spanned_wall,
        "device_kernel_s": device_s,
        "device_idle_share": 1 - device_s / profiled_wall if device_s else None,
        "device_idle_share_vs_unprofiled_wall": 1 - device_s / wall if device_s else None,
        "profiler_saw_device_time": device_s > 0,
        "kernel_launches_total": sum(e.count for e in kernels),
        "duplex_launches": duplex_launches,
        "duplex_device_s": sum(e.self_device_time_total for e in duplex) / 1e6,
        "spans": spans,
        "program_spans": program,
        "top_kernels": top_kernels(kernels),
        "tf_binding_sweep_chunk": sweep_chunk_profile(),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
