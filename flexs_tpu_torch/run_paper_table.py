"""Reproduce the reference paper's 3MSI benchmark table on the card.

    python -m flexs_tpu_torch.run_paper_table --explorers adalead genetic random
    python -m flexs_tpu_torch.run_paper_table --starts 2          # faster subset

Counterpart of scripts/run_paper_table.py, with its flags and lines.  Runs
each explorer with a perfect model (LandscapeAsModel) on the 3MSI Rosetta
landscape at the paper config (10 rounds x batch 100 x 2000 queries) over
the registry's 5 starting sequences, printing mean/best max fitness next to
the reference's recorded numbers (BASELINE.md; reference
paper_code/cloud/runs/3msi).  Each start's line is printed as the start
ends; each row's text line is followed by one JSON line of the row with
the card's name and power limit.  `--cpu` runs on the CPU; otherwise it
needs a card.
"""
import argparse
import json
import sys
import time

import numpy as np

from flexs_tpu_torch.alphabet import AAS
from flexs_tpu_torch.bench import card_string
from flexs_tpu_torch.device import resolve_device

REFERENCE = {
    "random": (0.417, 0.638),
    "adalead": (0.981, 0.996),
    "genetic": (1.000, 1.000),
    "bo": (0.996, 0.999),
    "cmaes": (0.887, 0.951),
    "cbas": (0.555, 0.693),
    "dbas": (0.679, 0.770),
    "dynappo": (0.934, 0.972),
    # Host-loop RL explorers, judged against the reference's only recorded
    # RL row (DynaPPO on 3MSI).
    "dqn": (0.934, 0.972),
    "ppo": (0.934, 0.972),
    "dynappo_mutative": (0.934, 0.972),
    # Fused device runners, judged against the same reference rows.
    "device-random": (0.417, 0.638),
    "device-adalead": (0.981, 0.996),
    "device-ga": (1.000, 1.000),
    "device-cmaes": (0.887, 0.951),
    "device-dqn": (0.934, 0.972),  # judged vs the DynaPPO RL row
    "device-bo": (0.996, 0.999),
    "device-cbas": (0.555, 0.693),
    "device-dbas": (0.679, 0.770),
    "device-ppo": (0.934, 0.972),
    "device-dynappo": (0.934, 0.972),
}
DEFAULT_EXPLORERS = ["random", "adalead", "genetic", "bo", "cmaes"]


def make(name: str, model, landscape, start: str, rounds: int = 10,
         sequences_batch_size: int = 100, model_queries_per_batch: int = 2000,
         alphabet: str = AAS, env_batch: int = 16, density_metric: str = "hamming",
         device=None):
    """The explorer `name` at the script's settings, seed 0.

    Host explorers explore `model`; the constructive and mutative DynaPPO
    and the fused `device-*` runners take `landscape` (the fused ones with a
    perfect model of it).  Explorers with a network or a generator, and the
    fused runners, live on `device` (default "cuda").
    """
    from flexs_tpu_torch import baselines, runtime as rt
    from flexs_tpu_torch.utils.vae import VAE

    ex = baselines.explorers
    common = dict(rounds=rounds, sequences_batch_size=sequences_batch_size,
                  model_queries_per_batch=model_queries_per_batch, alphabet=alphabet)
    if name == "random":
        return ex.Random(model, starting_sequence=start, seed=0, **common)
    if name == "adalead":
        return ex.Adalead(model, starting_sequence=start, seed=0, **common)
    if name == "genetic":
        return ex.GeneticAlgorithm(
            model, starting_sequence=start, population_size=100,
            parent_selection_strategy="wright-fisher", children_proportion=0.2, beta=0.05,
            seed=0, **common)
    if name == "bo":
        return ex.BO(model, starting_sequence=start, seed=0, **common)
    if name == "cmaes":
        return ex.CMAES(model, starting_sequence=start, population_size=15, seed=0,
                        maximize=True, device=device, **common)
    if name in ("cbas", "dbas"):
        vae = VAE(seq_length=len(start), alphabet=alphabet, intermediate_dim=250, epochs=10,
                  verbose=False, seed=0, device=device)
        return ex.CbAS(model, vae, starting_sequence=start, algo=name, seed=0, **common)
    if name == "dynappo":
        return ex.DynaPPO(landscape, starting_sequence=start, env_batch_size=env_batch, seed=0,
                          device=device, **common)
    if name == "dqn":
        return ex.DQN(model, starting_sequence=start, seed=0, device=device, **common)
    if name == "ppo":
        return ex.PPO(model, starting_sequence=start, seed=0, device=device, **common)
    if name == "dynappo_mutative":
        return ex.DynaPPOMutative(landscape, starting_sequence=start, seed=0, device=device,
                                  **common)
    fused = {
        "device-random": (rt.DeviceRandomNAM, dict(elitist=False)),  # the reference default
        "device-adalead": (rt.DeviceAdaleadNAM, {}),
        "device-ga": (rt.DeviceGeneticAlgorithmNAM, {}),
        "device-cmaes": (rt.DeviceCMAESNAM, dict(maximize=True)),
        "device-dqn": (rt.DeviceDQNNAM, {}),
        "device-bo": (rt.DeviceBONAM, {}),
        "device-cbas": (rt.DeviceCbASNAM, dict(algo="cbas")),
        "device-dbas": (rt.DeviceCbASNAM, dict(algo="dbas")),
        "device-ppo": (rt.DevicePPONAM, {}),
        "device-dynappo": (rt.DeviceDynaPPONAM,
                           dict(env_batch_size=16, density_metric=density_metric)),
    }
    if name in fused:
        cls, kw = fused[name]
        return cls(landscape, alphabet, rounds=rounds, sequences_batch_size=sequences_batch_size,
                   model_queries_per_batch=model_queries_per_batch, starting_sequence=start,
                   model="perfect", seed=0, device=device, **kw)
    raise ValueError(name)


def paper_starts(n_starts: int = 5, start_offset: int = 0) -> list:
    """The 3MSI registry's starts `start_offset` .. `start_offset + n_starts - 1`."""
    from flexs_tpu_torch.landscapes import rosetta

    starts = list(rosetta.registry()["3msi"]["starts"].values())
    return starts[start_offset:start_offset + n_starts]


def run_row(name: str, starts, rounds: int = 10, sequences_batch_size: int = 100,
            model_queries_per_batch: int = 2000, env_batch: int = 16,
            density_metric: str = "hamming", start_offset: int = 0, device=None) -> dict:
    """One table row: each start's run on a fresh landscape, its lines, and the row's JSON line."""
    import flexs_tpu_torch as flexs
    from flexs_tpu_torch.landscapes import rosetta

    device = resolve_device(device)
    problem = rosetta.registry()["3msi"]
    t0 = time.time()
    maxes = []
    for si, start in enumerate(starts):
        ts = time.time()
        landscape = rosetta.RosettaFolding(**problem["params"], device=device)
        model = flexs.LandscapeAsModel(landscape)
        explorer = make(name, model, landscape, start, rounds=rounds,
                        sequences_batch_size=sequences_batch_size,
                        model_queries_per_batch=model_queries_per_batch, env_batch=env_batch,
                        density_metric=density_metric, device=device)
        if name.startswith("device-"):
            df, _ = explorer.run(verbose=False)
        else:
            df, _ = explorer.run(landscape, verbose=False)
        maxes.append(float(df["true_score"].max()))
        # Incremental per-start line: a long row must not hold every datum
        # until the row completes.
        print(f"  {name} start {si + 1}/{len(starts)}: "
              f"max {maxes[-1]:.3f}  ({time.time() - ts:.0f}s)", flush=True)
    wall = time.time() - t0
    ref = REFERENCE[name]
    print(f"{name:<10} {np.mean(maxes):>8.3f}/{np.max(maxes):.3f} "
          f"{ref[0]:>10.3f}/{ref[1]:.3f}  {wall:>5.0f}s", flush=True)
    line = {"explorer": name, "starts": len(starts), "start_offset": start_offset,
            "rounds": rounds, "maxes": maxes, "mean": float(np.mean(maxes)),
            "best": float(np.max(maxes)), "reference": list(ref), "wall_s": wall,
            "card": card_string(device)}
    print(json.dumps(line), flush=True)
    return line


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--explorers", nargs="+", default=DEFAULT_EXPLORERS, choices=sorted(REFERENCE))
    p.add_argument("--starts", type=int, default=5)
    p.add_argument(
        "--start-offset", type=int, default=0,
        help="skip the first N reference starts (split one table row "
        "across processes: --start-offset 1 --starts 2 runs starts 2-3)",
    )
    p.add_argument("--rounds", type=int, default=10)
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    p.add_argument(
        "--env-batch", type=int, default=16,
        help="constructive-DynaPPO parallel episodes per collect step. Budget "
        "semantics are exact only when this divides both phase budgets (the "
        "experiment phase spends sequences_batch_size true queries, each model "
        "round model_queries_per_batch/num_model_rounds model queries); a "
        "non-divisor overshoots the budget by up to batch-1 queries on the "
        "final collect",
    )
    p.add_argument(
        "--density-metric", default="hamming", choices=["hamming", "edit"],
        help="fused device-dynappo density distance: 'hamming' (the "
        "documented fast deviation) or 'edit' (the reference's exact "
        "Levenshtein, environments/dyna_ppo.py:106-114)",
    )
    return p


def main(argv=None, device=None, **row_kw) -> int:
    """The table; `device` and `row_kw` (over `run_row`'s sizes) for tests."""
    args = parser().parse_args(argv)
    device = resolve_device("cpu" if args.cpu else device)
    starts = paper_starts(args.starts, args.start_offset)
    print(f"{'explorer':<10} {'ours mean/best':>16} {'reference':>16}  time", flush=True)
    for name in args.explorers:
        run_row(name, starts, rounds=args.rounds, env_batch=args.env_batch,
                density_metric=args.density_metric, start_offset=args.start_offset,
                device=device, **row_kw)
    return 0


if __name__ == "__main__":
    sys.exit(main())
