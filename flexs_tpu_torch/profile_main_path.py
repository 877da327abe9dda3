"""Where the fused main path's time goes, on one CUDA card.

    python -m flexs_tpu_torch.profile_main_path

Runs DeviceAdaleadNAM on RNABinding L100_RNA1 (100 proposals x 2000 model
queries per round, NAM at signal strength 0.9, seed 0) four times: once
to warm up (it builds and loads the kernel), once timed without the
profiler, once under `torch.profiler` for the kernels, and once more
under it with a span around each layer of the run.  Prints one JSON
line: the walls, the summed device time of all kernels, the device's
idle share (1 - kernel time / wall; kernels run on one stream, so they
never overlap) against the profiled and the unprofiled wall, the duplex
kernel's launches and device time, the top kernels by device time, and
each span's calls and host seconds (a span's time includes the spans
nested in it; the spans slow the run, so compare spans with each other
and with the spanned wall).  The spans are added here, for that run
only, by replacing each attribute in SPANS; the package itself carries no
instrumentation.  The script fails if a span's attribute is gone or the
run never called it, so a renamed method cannot drop out of the table.
"""
import contextlib
import functools
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

import flexs_tpu_torch as flexs
from flexs_tpu_torch.landscapes import rna
from flexs_tpu_torch.ops import cuda_duplex, packed_hamming
from flexs_tpu_torch.runtime import jit_runner

ROUNDS = 10  # the main path's full run, as chip_smoke.py drives it
TOP_KERNELS = 12

# Span label -> (owner, attribute).  Callers look these up on the owner at
# call time, so replacing the attribute puts the span around every call.
SPANS = {
    "round": (jit_runner._Run, "round"),
    "round.nam_query": (jit_runner._Run, "nam_query"),
    "round.novel_mutants": (jit_runner._Run, "novel_mutants"),
    "packed_hamming.pack_tokens": (packed_hamming, "pack_tokens"),
    "packed_hamming.packed_hamming_matrix": (packed_hamming, "packed_hamming_matrix"),
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


def _timed_run(runner) -> float:
    t0 = time.perf_counter()
    runner.run(verbose=False)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


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
    kernels = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
    ]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
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
    silent = [label for label in SPANS if spans.get(label, {}).get("calls", 0) == 0]
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
        "top_kernels": [
            {"name": e.key[:80], "count": e.count, "device_s": e.self_device_time_total / 1e6}
            for e in kernels[:TOP_KERNELS]
        ],
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
