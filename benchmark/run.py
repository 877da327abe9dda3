"""Run one cell of the port's benchmark once, and print its result as the last line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell (`BENCHMARK.json`'s workload) names a
configuration (`benchmark/configs/<config>.json`) and a traffic mix
(`benchmark/traffic/<mix>.json`).  The configuration's `family` selects
`families/<family>.py` (the port's landscape and sweep) and
`reference/<family>.py` (the plain reference); the mix's `entry` selects
`entries/<entry>.py`, which turns the seed into units of work; each
per-layer metric is read by `metrics/<metric>.py` (a suffix after a dot,
as in `idle_pct.run`, names the end-to-end metric it moves).

A run: imports, the inputs made from the seed, one warm-up unit (set-up);
then units drawn from the seed back to back until `--seconds` have passed,
each counted whole (the window), a sample of the distance op's calls kept
on the device.  With `--trace 1` the window's last unit runs once more
under the profiler with the benchmark's spans around the port's calls.
After the window the peak device memory is read, the program's state
freed, and every cell's outputs and the sampled distances compared with
the reference.  Earlier lines give the host record and each
unit's wall; the last line is the result, its last key the numbers
compared, each with its limit (also the last lines on standard error).
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import check, host, probes, work  # noqa: E402

T_TORCH = time.perf_counter()  # the harness's own imports, torch's among them, done

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "flexs_tpu"}


class ForbiddenImport(RuntimeError):
    pass


def load_cell(root: str, workload: str, overrides=None) -> SimpleNamespace:
    """The workload's entry, configuration and traffic mix, read from `root`'s files.

    `overrides` ({"config": {...}, "traffic": {...}}) replaces keys, for
    rehearsals at small sizes.
    """
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = {w["name"]: w for w in bench["workloads"]}.get(workload)
    if cell is None:
        raise SystemExit(f"unknown workload {workload!r}")
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(root, cfg_entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "benchmark", "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    overrides = overrides or {}
    config.update(overrides.get("config", {}))
    traffic.update(overrides.get("traffic", {}))

    def cell_metrics(kind):
        return [m for m in bench[kind] if workload in m.get("workloads", [workload])]

    return SimpleNamespace(name=workload, chips=cell["chips"], config=config, traffic=traffic,
                           end_to_end=cell_metrics("end_to_end"),
                           per_layer=cell_metrics("per_layer"), root=root)


def load_metric(name: str):
    """The reader of metric `name`: `metrics/<name>.py`, a `.<suffix>` naming the metric it moves apart."""
    name = name.split(".")[0]
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules():
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def set_precision(config):
    """Matrix products as the configuration states: TF32 only where it says so."""
    tf32 = bool(config.get("tf32", False))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def run_cell(spec, seed: int, seconds: float, trace: bool, device="cuda", t0=None,
             control: bool = False, faults=()) -> dict:
    """One run of the cell `spec` (from `load_cell`); prints the earlier lines, returns the result.

    `control` runs the window with the family's control in the program's
    place; `faults` are extra `(owner, attr, make)` swaps over the window
    (both for the checks of the comparison, never in a measured run).
    """
    t0 = time.perf_counter() if t0 is None else t0
    device = torch.device(device)
    config, traffic = spec.config, spec.traffic
    cache = os.path.join(spec.root, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    set_precision(config)
    rng = np.random.default_rng(seed % 2**63)
    dists = probes.DistSample(np.random.default_rng([seed % 2**63, 1]))

    t_import = time.perf_counter()
    from flexs_tpu_torch.runtime import jit_runner

    family = importlib.import_module(f"benchmark.families.{config['family']}")
    entry_mod = importlib.import_module(f"benchmark.entries.{traffic['entry']}")
    reference_mod = importlib.import_module(f"benchmark.reference.{config['family']}")
    import_s = time.perf_counter() - t_import

    t_inputs = time.perf_counter()
    inputs = family.make_inputs(config, device)
    sync(device)
    inputs_s = time.perf_counter() - t_inputs
    capture = probes.Capture()
    lookups = probes.LookupCount()
    rows = probes.RowCount()
    base = [(jit_runner, "run_cells", capture.make)]
    counted = base + [(jit_runner.CellRun, "dists_to_cache", lookups.make)]
    counted += [(o, a, rows.make) for o, a in family.ORACLE_TARGETS]
    with probes.replaced(base):
        entry = entry_mod.Entry(config, traffic, family, inputs, device, rng, capture)
        t_warm = time.perf_counter()
        entry.warm_up()
        sync(device)
        warm_s = time.perf_counter() - t_warm
    setup_s = time.perf_counter() - t0

    # The window.  Faults go in first, so that the probes see what they return.
    syncs0 = jit_runner.run_counts["syncs"]
    units, cells = [], []
    mode = (family.control(_reference(reference_mod, config, spec, inputs, device), device)
            if control else contextlib.nullcontext())
    sampled = [(jit_runner.CellRun, "dists_to_cache", dists.make)]
    with probes.replaced(list(faults)), probes.replaced((counted if trace else base) + sampled), \
            mode:
        t_window = time.perf_counter()
        while time.perf_counter() - t_window < seconds or not units:
            t_unit = time.perf_counter()
            unit = entry.next_unit()
            unit_cells = entry.run(unit)
            sync(device)
            t_end = time.perf_counter()
            units.append({"cells": len(unit_cells), "wall_s": t_end - t_unit,
                          "end_s": t_end - t_window})
            cells += unit_cells
    wall = units[-1]["end_s"]
    syncs = jit_runner.run_counts["syncs"] - syncs0
    window_lookup = lookups.total.copy()
    rounds = sum(entry.lockstep_runs(u["cells"]) for u in units) * config["rounds"]

    unit_trace, profiled = None, []
    if trace:
        unit_trace, profiled = _profiled_unit(entry, unit, units[-1]["wall_s"], family,
                                              jit_runner, counted, lookups, rows, device)
    if forbidden_modules():
        raise ForbiddenImport(forbidden_modules())

    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    # The program's state freed before the reference runs.
    del entry
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    record = host.record(device)
    print(json.dumps({"host": record, "units": units, "syncs": syncs,
                      "window_lookup_calls": window_lookup.calls,
                      "oracle_rows_scored": rows.rows, "setup_parts_s": {
                          "harness_imports": T_TORCH - T0, "port_import": import_s,
                          "inputs": inputs_s, "warm": warm_s, "total": setup_s}}), flush=True)

    settled = [c.settle() for c in cells + profiled]
    reference = _reference(reference_mod, config, spec, inputs, device)
    numbers = {**check.compare(settled, reference, config), **check.dist_errors(dists.settle())}
    print(json.dumps({"checked": {"rows": numbers["rows"], "dist_calls": dists.calls,
                                  "dist_samples": len(dists.samples),
                                  "dist_sampled": numbers["dist_sampled"]}}), flush=True)
    limits = config["limits"]
    compared = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = all(v["value"] <= v["limit"] for v in compared.values())
    window_cells = settled[:len(cells)]

    ctx = SimpleNamespace(
        config=config, peaks=work.peaks(), on_device=device.type == "cuda",
        sm_clock_mhz=(unit_trace or {}).get("sm_clock_mhz") or work.peaks()["sm_clock_max_mhz"],
        setup={"import_s": import_s, "warm_s": warm_s},
        window={"wall_s": wall, "syncs": syncs, "rounds": rounds, "cells": len(cells),
                "lookup": window_lookup, "bert_forwards": _forwards(window_cells)},
        unit=None if unit_trace is None or not unit_trace.get("device_ops") else {
            **unit_trace, "bert_forwards": _forwards(settled[len(cells):])},
    )
    if trace:
        metrics = {}
        for m in spec.per_layer:
            value = load_metric(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        rate = 60.0 * len(cells) / wall
        e2e = {"setup_s": setup_s, "cells_per_min": rate, "runs_per_min": rate,
               "mean_max_fitness": float(np.mean([c.reported_max for c in window_cells]))}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in spec.end_to_end}

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else device.type,
           "count": spec.chips, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": correct, "attempted": len(cells),
              "failed": 0 if correct else len(cells), "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = (unit_trace or {}).get("busy_s", 0.0)
        dev["window_s"] = (unit_trace or {}).get("window_s", 0.0)
        if unit_trace and unit_trace.get("breakdown"):
            result["breakdown"] = unit_trace["breakdown"]
    result["compared"] = compared
    if forbidden_modules():
        raise ForbiddenImport(forbidden_modules())
    return result


def _reference(reference_mod, config, spec, inputs, device):
    return reference_mod.Reference(config, spec.root, inputs, device)


def _forwards(cells) -> int:
    """Distinct rows the cells' NAM runs scored (each cell's start and inserted rows)."""
    return sum(work.distinct_rows(int(c.landscape_cost[-1]), int(c.valid.sum())) for c in cells)


def _profiled_unit(entry, unit, untraced_wall, family, jit_runner, counted, lookups, rows,
                   device):
    """`unit` once more under the profiler with the spans: its reduced trace and its cells.

    `untraced_wall` is the same unit's wall in the window, which the idle
    share is taken over: the profiler stretches the host's side of a unit.
    """
    from torch.profiler import ProfilerActivity, profile

    from benchmark import trace as trace_lib

    spans = [(jit_runner.CellRun, "dists_to_cache", probes.span("dist")),
             (jit_runner.CellRun, "fetch", probes.span("fetch")),
             (jit_runner._Run, "round", probes.span("round"))]
    spans += [(o, a, probes.span("oracle")) for o, a in family.ORACLE_TARGETS]
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    before = lookups.total.copy()
    clock = {}
    sampler = threading.Thread(target=host.sample_sm_clock, args=(clock, 1.0))
    with probes.replaced(counted), probes.replaced(spans):
        prof = profile(activities=activities)
        prof.start()
        if device.type == "cuda":
            sampler.start()
        t0 = time.perf_counter()
        cells = entry.run(unit)
        sync(device)
        wall = time.perf_counter() - t0
        prof.stop()
    if sampler.ident is not None:
        sampler.join()
    t_reduce = time.perf_counter()
    events = trace_lib.collect(prof, ["dist", "fetch", "round", "oracle"])
    del prof
    reduced = trace_lib.reduce(events, wall)
    reduced["lookup"] = lookups.total.minus(before)
    reduced["sm_clock_mhz"] = clock.get("sm_mhz")
    reduced["untraced_wall_s"] = untraced_wall
    print(json.dumps({"profiled_unit": {
        "wall_s": wall, "untraced_wall_s": untraced_wall,
        "trace_overhead_pct": 100.0 * (wall / untraced_wall - 1.0),
        "reduce_s": time.perf_counter() - t_reduce, "cells": len(cells),
        "device_ops": reduced["device_ops"], "linked_share": reduced["linked_share"],
        "busy_s": reduced.get("busy_s"), "span_device_s": reduced.get("span_device_s"),
        "sm_clock_mhz": clock.get("sm_mhz"), "lookup_calls": reduced["lookup"].calls}}),
        flush=True)
    return reduced, cells


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    spec = load_cell(os.getcwd(), args.workload)
    if torch.cuda.device_count() < spec.chips:
        print(f"{spec.name} needs {spec.chips} CUDA devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    try:
        result = run_cell(spec, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    except ForbiddenImport as e:
        print(f"the run loaded modules it must not: {e.args[0]}", file=sys.stderr)
        return 3
    for name, v in result["compared"].items():
        print(f"check {name} = {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
