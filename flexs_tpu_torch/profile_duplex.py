"""Profile the RNA duplex oracle's paths on one CUDA card.

    python -m flexs_tpu_torch.profile_duplex

Counterpart of scripts/profile_duplex.py.  For L1 in {14, 100} and B in
{512, 4096} sequences against one random reversed target of length 100
(calibrated parameters, seed 0), it prints ms per call and sequences/s of:

  floor    the dispatch floor: one trivial elementwise op on f32[8, 128];
  gather   the gather-form DP, `rna_duplex._duplex_dp_batch`, in torch ops;
  slab     the plain slab DP, `rna_duplex.duplex_energy_from_slabs`;
  build    the slab build alone, `rna_duplex.build_slabs`;
  kernel   the CUDA kernel through `cuda_duplex.duplex_energies` on a plan
           made once (`cuda_duplex.make_plan`), as the landscape calls it.

Times are CUDA-event medians (`profile_duplex_rowcost.time_ms`).  A plain
path whose B=512 time, scaled by 8, would exceed PLAIN_LIMIT_S at B=4096 is
timed at B=512 only, and the row says so.  The CUDA kernel has no group
width, so there is no group sweep.  Ends with one JSON line of the
readings.  It needs a card.
"""
import json

import numpy as np
import torch

from flexs_tpu_torch.ops import cuda_duplex
from flexs_tpu_torch.ops import rna_duplex as rd
from flexs_tpu_torch.profile_duplex_rowcost import time_ms

TARGET_L2 = 100
LENGTHS = (14, 100)
BATCHES = (512, 4096)
PLAIN_LIMIT_S = 10.0
REPS, INNER = 5, 20  # the kernel and the floor
PLAIN_REPS, PLAIN_INNER = 3, 1  # the plain torch paths


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_duplex needs a CUDA card")
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(0)
    params = rd.DuplexParams.calibrated()
    em = params.energy_model(dev)
    maxloop = params.maxloop
    target_rev = torch.as_tensor(
        rng.integers(0, 4, TARGET_L2, dtype=np.int32)[::-1].copy(), device=dev
    )

    plan = cuda_duplex.make_plan(target_rev[None], em, maxloop)
    x0 = torch.zeros((8, 128), dtype=torch.float32, device=dev)
    floor_ms = time_ms(lambda: x0 + 1.0, REPS, INNER)
    print(f"dispatch floor (x + 1 on f32[8, 128]): {floor_ms:.4f} ms", flush=True)

    paths = {
        "gather": lambda t: rd._duplex_dp_batch(t, target_rev, em, maxloop),
        "slab": lambda t: rd.duplex_energy_from_slabs(t, target_rev, em, maxloop),
        "build": lambda t: rd.build_slabs(t, target_rev, em),
        "kernel": lambda t: cuda_duplex.duplex_energies(
            t, plan.targets_rev, em, maxloop, plan=plan),
    }
    readings = []
    for l1 in LENGTHS:
        skipped = set()
        for b in BATCHES:
            tokens = torch.as_tensor(
                rng.integers(0, 4, size=(b, l1), dtype=np.int32), device=dev
            )
            row = [f"L{l1} B{b}:"]
            for name, fn in paths.items():
                if name in skipped:
                    row.append(f"{name} not timed (plain path, > {PLAIN_LIMIT_S} s expected)")
                    continue
                reps, inner = (REPS, INNER) if name == "kernel" else (PLAIN_REPS, PLAIN_INNER)
                ms = time_ms(lambda: fn(tokens), reps, inner)
                readings.append({"l1": l1, "batch": b, "path": name, "ms": ms,
                                 "seq_per_s": b / ms * 1e3})
                row.append(f"{name} {ms:10.4f} ms ({b / ms * 1e3:10.0f} seq/s)")
                if name != "kernel" and ms * BATCHES[-1] / b > PLAIN_LIMIT_S * 1e3:
                    skipped.add(name)
            print(" | ".join(row), flush=True)

    print(json.dumps({
        "card": torch.cuda.get_device_name(0),
        "target_l2": TARGET_L2,
        "maxloop": maxloop,
        "dispatch_floor_ms": floor_ms,
        "readings": readings,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
