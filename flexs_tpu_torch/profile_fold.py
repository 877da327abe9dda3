"""Time the Zuker fold DP (`ops/rna_fold.py`) on one CUDA card.

    python -m flexs_tpu_torch.profile_fold

Counterpart of scripts/profile_fold.py and scripts/bench_fold.py.  On
numpy-seeded tokens (seed 0) and the calibrated energy model it times
`zuker_mfe_batch`, each reading the median of REPS calls by CUDA events:

  (a) B in {100, 512} x L in {50, 100}, maxloop 16;
  (b) maxloop 16 / 8 / 4 at B=512, L=100 (P = 153 / 45 / 15 windows);
  (c) each cost-centre knockout at B=512, L=100, passed as the argument;
  (d) one call at B=100, L=100 under torch.profiler (CUDA activity only):
      the kernels it launches and their device time, beside the call's
      wall, which says how far host dispatch holds the card back.

Prints the readings, then one JSON line of them.  It needs a card.
"""
import json
import time

import numpy as np
import torch

from flexs_tpu_torch.ops import rna_fold
from flexs_tpu_torch.profile_duplex_rowcost import time_ms
from flexs_tpu_torch.profile_main_path import device_kernels

SEED = 0
REPS = 5
SHAPES = ((100, 50), (100, 100), (512, 50), (512, 100))
MAXLOOPS = (16, 8, 4)
SCALING_SHAPE = (512, 100)  # (B, L) of the maxloop and knockout readings
PROFILED_SHAPE = (100, 100)  # the fused run's oracle call at L=100


def measure(device) -> dict:
    """The readings of (a)-(d) on `device`, a CUDA device."""
    em = rna_fold.fold_energy_model(device=device)
    rng = np.random.default_rng(SEED)
    tokens = {
        (b, length): torch.as_tensor(rng.integers(0, 4, (b, length)), device=device)
        for b, length in SHAPES
    }
    out = {"shapes": [], "maxloop": [], "knockouts": []}
    for (b, length), tok in tokens.items():
        ms = time_ms(lambda: rna_fold.zuker_mfe_batch(tok, em), REPS, 1)
        out["shapes"].append({"batch": b, "length": length, "ms": ms,
                              "folds_per_s": b / ms * 1e3})
    tok = tokens[SCALING_SHAPE]
    for maxloop in MAXLOOPS:
        ms = time_ms(lambda: rna_fold.zuker_mfe_batch(tok, em, maxloop), REPS, 1)
        out["maxloop"].append({"maxloop": maxloop,
                               "windows": len(rna_fold._interior_windows(maxloop)), "ms": ms})
    for knockout in rna_fold.KNOCKOUTS:
        ms = time_ms(lambda: rna_fold.zuker_mfe_batch(tok, em, knockout=knockout), REPS, 1)
        out["knockouts"].append({"knockout": knockout, "ms": ms})
    out["profiled_call"] = profile_call(tokens[PROFILED_SHAPE], em)
    out["batch_length_maxloop"] = {"scaling": SCALING_SHAPE, "profiled": PROFILED_SHAPE}
    return out


def profile_call(tokens, em) -> dict:
    """Kernel launches, device time and wall of one warm fold call."""
    from torch.profiler import ProfilerActivity, profile

    rna_fold.zuker_mfe_batch(tokens, em)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rna_fold.zuker_mfe_batch(tokens, em)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = device_kernels(prof)
    device_s = sum(e.self_device_time_total for e in kernels) / 1e6
    return {"launches": sum(e.count for e in kernels), "device_s": device_s,
            "wall_s": wall, "device_busy_share": device_s / wall,
            "us_per_launch": wall / max(1, sum(e.count for e in kernels)) * 1e6}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_fold needs a CUDA card")
    dev = torch.device("cuda", torch.cuda.current_device())
    readings = measure(dev)
    for row in readings["shapes"]:
        print(f"B={row['batch']} L={row['length']}: {row['ms']:.3f} ms "
              f"({row['folds_per_s']:.0f} folds/s)")
    for row in readings["maxloop"]:
        print(f"maxloop {row['maxloop']} ({row['windows']} windows): {row['ms']:.3f} ms")
    for row in readings["knockouts"]:
        print(f"knockout {row['knockout']}: {row['ms']:.3f} ms")
    print(f"one call at B, L = {PROFILED_SHAPE}: {readings['profiled_call']}")
    print(json.dumps({"device": torch.cuda.get_device_name(0), **readings}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
