"""Throughput of the Turner-structured Zuker MFE DP (ops/rna_fold.py) on the card.

    python -m flexs_tpu_torch.bench_fold [--cpu] [--batch 512] [--length 100] [--reps 10]

Counterpart of scripts/bench_fold.py, with its flags.  The reference
oracle is ViennaRNA's `RNA.fold` (reference rna.py:26), a single-threaded
C Zuker implementation; the port runs the whole batch's DP as torch ops
on the card.  On tokens drawn from numpy's default_rng(0), for L=50 and
L=100 (or `--length`), it prints the first call's wall and mean MFE,
then the median of 3 readings of `zuker_mfe_batch`, each the mean of
`--reps` calls after a warm-up call (`utils.profiling.
amortized_seconds_per_call`: CUDA events on the card, as profile_fold
times; the host clock with `--cpu`), and last one JSON line of the
readings with the card's name and power limit.  Without `--cpu` it needs
a card.
"""
import argparse
import json
import sys

import numpy as np
import torch

from flexs_tpu_torch.bench import card_string, timed
from flexs_tpu_torch.device import resolve_device
from flexs_tpu_torch.ops import rna_fold
from flexs_tpu_torch.utils.profiling import amortized_seconds_per_call

LENGTHS = (50, 100)  # the BASELINE.md row wants both
SEED = 0


def run(batch: int = 512, lengths=LENGTHS, reps: int = 10, device=None) -> list:
    """One reading a length, on seeded tokens; each with the first call's MFEs (f32[B])."""
    device = resolve_device(device)
    em = rna_fold.fold_energy_model(device=device)
    rng = np.random.default_rng(SEED)
    readings = []
    for length in lengths:
        tokens = torch.as_tensor(
            rng.integers(0, 4, (batch, length)).astype(np.int32), device=device
        )
        mfe, t_first = timed(lambda: rna_fold.zuker_mfe_batch(tokens, em), device)
        print(f"L={length} first call: {t_first:.1f} s; "
              f"mean MFE {float(mfe.mean()):.3f} kcal/mol", flush=True)
        walls = [
            amortized_seconds_per_call(rna_fold.zuker_mfe_batch, tokens, em, reps=reps)
            for _ in range(3)
        ]
        med = sorted(walls)[1]
        print(
            f"B={batch} L={length}: {med*1e3:.1f} ms/batch median "
            f"(spread {min(walls)*1e3:.1f}-{max(walls)*1e3:.1f}) = "
            f"{batch/med:,.0f} seqs/s",
            flush=True,
        )
        readings.append({"batch": batch, "length": length, "first_call_s": t_first,
                         "mean_mfe": float(mfe.mean()), "ms_per_batch": med * 1e3,
                         "ms_spread": [min(walls) * 1e3, max(walls) * 1e3],
                         "seqs_per_sec": batch / med, "mfe": mfe})
    return readings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument(
        "--length", type=int, default=None,
        help="single length; default measures L=50 and L=100 (the "
        "BASELINE.md row wants both)",
    )
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)

    device = "cpu" if args.cpu else None
    readings = run(args.batch, [args.length] if args.length else LENGTHS, args.reps, device)
    print(json.dumps({
        "readings": [{k: v for k, v in r.items() if k != "mfe"} for r in readings],
        "reps": args.reps,
        "card": card_string(resolve_device(device)),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
