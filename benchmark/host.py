"""The host record: the card's name, power limit and clocks, the CPU, and the host-loop control.

The control is a frozen copy of `flexs_tpu_torch.profile_fused_run`'s: a
host loop of one small op on a carried device scalar, timed with one
synchronize at the end and with a host sync every iteration (what a fused
run's `CellRun.fetch` costs a step).
"""
import os
import subprocess
import time

import torch

CONTROL_ITERATIONS = 2000
SMI_FIELDS = ("name", "power.limit", "clocks.sm", "clocks.max.sm")


def _smi(fields):
    """nvidia-smi's readings of the first card, as strings; {} where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={','.join(fields)}", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return {}
    return dict(zip(fields, (v.strip() for v in out.split(","))))


def sample_sm_clock(out: dict, after_s: float) -> None:
    """After `after_s` seconds, read the SM clock (MHz) into `out["sm_mhz"]`."""
    time.sleep(after_s)
    try:
        out["sm_mhz"] = float(_smi(("clocks.sm",))["clocks.sm"])
    except (KeyError, ValueError):
        pass


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return "unknown"


def host_loop(n: int, device, sync_each: bool):
    """n iterations of one op on a carried device scalar; a host sync each if `sync_each`."""
    x = torch.ones((), device=device)
    for _ in range(n):
        x = x * 1.000001
        if sync_each:
            x.tolist()
    return x


def _control_us(device, sync_each: bool, n: int = CONTROL_ITERATIONS) -> float:
    """Microseconds an iteration of `host_loop`, after one warm-up call."""
    host_loop(n // 10, device, sync_each).tolist()
    t0 = time.perf_counter()
    host_loop(n, device, sync_each).tolist()
    return (time.perf_counter() - t0) / n * 1e6


def record(device) -> dict:
    """The host record of this run's machine."""
    out = {"cpu": _cpu_model(), "cpus": os.cpu_count(),
           "cpus_usable": len(os.sched_getaffinity(0)),
           "control_us_one_sync": _control_us(device, False),
           "control_us_sync_each": _control_us(device, True)}
    if device.type == "cuda":
        out["card"] = _smi(SMI_FIELDS)
    return out
