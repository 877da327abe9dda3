"""Fused trained-surrogate benchmark: the paper's CNN experiments on the card.

    python -m flexs_tpu_torch.bench_surrogate [--host] [--sweep] [--matrix] [--archs]

Counterpart of scripts/bench_surrogate.py, with its flags and benches:

  * Rosetta 3MSI + CNN surrogate + Adalead (reference
    paper_code/cloud/runs/rosetta_cnn/adalead_*_cnn.csv: mean max 0.905)
    at the paper config (10 rounds x batch 100 x 2000 queries), all 5
    registry starts, each run twice (first, steady);
  * TF-Bind-8 + 3xCNN ensemble + CMA-ES (reference runs/cmaes/*_cnn:
    mean max 0.995 over 27 runs), 2 landscapes x 2 starts;
  * with --host, one host-loop run (the port's CNN + host Adalead) for the
    fused-vs-host ratio;
  * --sweep: the 3MSI surrogate sweep (5 starts x 4 seeds), median of 3;
  * --matrix: the fused Random, DQN, PPO and CbAS runners in surrogate
    mode on TF-Bind-8 SIX6_REF_R1, 2 starts each;
  * --archs: Adalead with the mlp/gem/linear/gp surrogates and GPR_BO's
    GP Thompson, 2 starts each.

Each bench prints the JAX script's lines, then one JSON line of its
means and steady walls with the card's name and power limit.  Every wall
is `time.perf_counter()` around a run that ends in
`torch.cuda.synchronize()`.  `--cpu` runs on the CPU; otherwise it needs
a card.  Each bench function takes the sizes the script hard-codes as
keyword arguments, with its values as defaults, and `device`.
"""
import argparse
import json
import sys

import numpy as np

from flexs_tpu_torch.bench import card_string, timed
from flexs_tpu_torch.device import resolve_device

PAPER = dict(sequences_batch_size=100, model_queries_per_batch=2000)
TFBIND_CMAES_LANDSCAPES = ("SIX6_REF_R1", "VAX2_REF_R1")


def bench_line(bench: str, device, **readings) -> dict:
    """Print a bench's JSON line at once and return it."""
    line = {"bench": bench, **readings, "card": card_string(device)}
    print(json.dumps(line), flush=True)
    return line


def bench_rosetta_adalead(starts_n: int, rounds: int, repeat_timed: bool, device=None, **run_kw):
    import flexs_tpu_torch as flexs
    from flexs_tpu_torch.landscapes import rosetta
    from flexs_tpu_torch.runtime.jit_runner import DeviceAdaleadNAM
    from flexs_tpu_torch.runtime.surrogate import SurrogateSpec

    device = resolve_device(device)
    problem = rosetta.registry()["3msi"]
    landscape = rosetta.RosettaFolding(**problem["params"], device=device)
    starts = list(problem["starts"].items())[:starts_n]

    scores, times = [], []
    for name, seq in starts:
        explorer = DeviceAdaleadNAM(
            landscape,
            flexs.AAS,
            rounds=rounds,
            **{**PAPER, **run_kw},
            starting_sequence=seq,
            model="surrogate",
            surrogate_spec=SurrogateSpec(),  # CNN_hidden_size_100_num_filters_32
            device=device,
        )
        (df, _), first = timed(lambda: explorer.run(verbose=False), device)
        steady = first
        if repeat_timed:
            (df, _), steady = timed(lambda: explorer.run(verbose=False), device)
        top = df["true_score"].max()
        scores.append(top)
        times.append(steady)
        print(
            f"  rosetta-cnn-adalead {name}: max {top:.3f} "
            f"(first {first:.2f}s, steady {steady:.2f}s)"
        )
    print(
        f"rosetta-cnn-adalead mean {np.mean(scores):.3f} best {np.max(scores):.3f} "
        f"steady {np.mean(times):.2f}s/run  [ref 0.905; host-loop rebuild 0.956]"
    )
    bench_line("rosetta_adalead", device, rounds=rounds, runs=len(scores),
               mean_max=float(np.mean(scores)), best_max=float(np.max(scores)),
               steady_s_per_run=float(np.mean(times)), steady_s=[float(t) for t in times])
    return float(np.mean(scores)), float(np.mean(times))


def bench_tfbind_cmaes(rounds: int, landscapes=TFBIND_CMAES_LANDSCAPES, starts_n: int = 2,
                       device=None, **run_kw):
    import flexs_tpu_torch as flexs
    from flexs_tpu_torch.landscapes import tf_binding
    from flexs_tpu_torch.runtime.cmaes_runner import DeviceCMAESNAM
    from flexs_tpu_torch.runtime.surrogate import SurrogateSpec

    device = resolve_device(device)
    scores, times = [], []
    for lname in landscapes:
        landscape = flexs.landscapes.TFBinding(name=lname, device=device)
        for start in tf_binding.STARTS[:starts_n]:
            explorer = DeviceCMAESNAM(
                landscape,
                "TGCA",
                rounds=rounds,
                **{**PAPER, **run_kw},
                starting_sequence=start,
                maximize=True,
                model="surrogate",
                surrogate_spec=SurrogateSpec(ensemble_size=3),
                device=device,
            )
            (df, _), dt = timed(lambda: explorer.run(verbose=False), device)
            top = df["true_score"].max()
            scores.append(top)
            times.append(dt)
            print(f"  tfbind-cmaes-3cnn {lname} {start}: max {top:.3f} ({dt:.2f}s)")
    print(
        f"tfbind-cmaes-3cnn mean {np.mean(scores):.3f} "
        f"({np.mean(times):.2f}s/run)  [ref 0.995; host-loop rebuild 0.991]"
    )
    bench_line("tfbind_cmaes", device, rounds=rounds, runs=len(scores),
               mean_max=float(np.mean(scores)), s_per_run=float(np.mean(times)),
               s=[float(t) for t in times])
    return float(np.mean(scores)), float(np.mean(times))


def bench_host_rosetta(rounds: int, device=None, **run_kw):
    import flexs_tpu_torch as flexs
    from flexs_tpu_torch.baselines.models.cnn import CNN
    from flexs_tpu_torch.landscapes import rosetta

    device = resolve_device(device)
    problem = rosetta.registry()["3msi"]
    landscape = rosetta.RosettaFolding(**problem["params"], device=device)
    name, seq = list(problem["starts"].items())[0]
    model = CNN(len(seq), num_filters=32, hidden_size=100, alphabet=flexs.AAS, device=device)
    explorer = flexs.baselines.explorers.Adalead(
        model,
        rounds=rounds,
        **{**PAPER, **run_kw},
        starting_sequence=seq,
        alphabet=flexs.AAS,
        seed=0,
    )
    (df, _), dt = timed(lambda: explorer.run(landscape, verbose=False), device)
    print(
        f"host-loop rosetta-cnn-adalead {name}: max {df['true_score'].max():.3f} "
        f"({dt:.2f}s)"
    )
    bench_line("host_rosetta", device, rounds=rounds, max=float(df["true_score"].max()),
               s=dt)
    return dt


def bench_surrogate_sweep(rounds: int, device=None, seeds=(0, 1, 2, 3), starts_n: int = 5,
                          **run_kw):
    """Fused CNN-surrogate cells through the generic sweep, in its default cell mode."""
    import flexs_tpu_torch as flexs
    from flexs_tpu_torch.landscapes import rosetta
    from flexs_tpu_torch.parallel import run_landscape_robustness_sweep
    from flexs_tpu_torch.runtime.surrogate import SurrogateSpec

    device = resolve_device(device)
    problem = rosetta.registry()["3msi"]
    landscape = rosetta.RosettaFolding(**problem["params"], device=device)
    starts = list(problem["starts"].values())[:starts_n]
    kw = dict(
        signal_strengths=[1.0],
        seeds=list(seeds),
        rounds=rounds,
        **{**PAPER, **run_kw},
        model="surrogate",
        surrogate_spec=SurrogateSpec(),
        device=device,
    )
    # Warm with the same cells.
    _, warm = timed(lambda: run_landscape_robustness_sweep([landscape], flexs.AAS,
                                                           starts=starts, **kw), device)
    print(f"  (first run {warm:.1f}s)")
    walls = []
    for _ in range(3):
        df, wall = timed(lambda: run_landscape_robustness_sweep(
            [landscape], flexs.AAS, starts=starts, **kw), device)
        walls.append(wall)
    wall = float(np.median(walls))
    seqs = int(df["model_cost"].sum() + df["landscape_cost"].sum())
    print(
        f"surrogate sweep: {len(df)} Rosetta-CNN-Adalead cells in {wall:.1f}s "
        f"median-of-3 (spread {min(walls):.1f}-{max(walls):.1f}; "
        f"{seqs / wall:9.0f} seqs/s; mean max {df['max_fitness'].mean():.3f})"
    )
    bench_line("surrogate_sweep", device, rounds=rounds, cells=len(df), first_s=warm,
               wall_s=wall, wall_spread_s=[min(walls), max(walls)], seqs_per_sec=seqs / wall,
               mean_max=float(df["max_fitness"].mean()))


def rows_by_start(name: str, make, starts, device) -> dict:
    """Two runs of `make(start)` per start; prints the JAX script's rows and returns the means."""
    scores, times = [], []
    for start in starts:
        explorer = make(start)
        _, first = timed(lambda: explorer.run(verbose=False), device)
        (df, _), steady = timed(lambda: explorer.run(verbose=False), device)
        scores.append(df["true_score"].max())
        times.append(steady)
        print(
            f"  {name} {start}: max {scores[-1]:.3f} "
            f"(first {first:.1f}s, steady {steady:.2f}s)"
        )
    print(
        f"{name} mean {np.mean(scores):.3f} "
        f"steady {np.mean(times):.2f}s/run"
    )
    return {"mean_max": float(np.mean(scores)), "steady_s_per_run": float(np.mean(times)),
            "steady_s": [float(t) for t in times]}


def bench_matrix(rounds: int, device=None, starts_n: int = 2, **run_kw):
    """Quality/latency rows for the rest of the surrogate matrix.

    The paper config on TF-Bind-8 SIX6_REF_R1 for the fused runners with a
    surrogate mode beyond the headline pair (Random, DQN, PPO, CbAS).
    These combinations have no reference row (the paper's CNN experiments
    were Adalead and CMA-ES only): capability and in-band quality.
    """
    import flexs_tpu_torch as flexs
    from flexs_tpu_torch.landscapes import tf_binding
    from flexs_tpu_torch.runtime.cbas_runner import DeviceCbASNAM
    from flexs_tpu_torch.runtime.dqn_runner import DeviceDQNNAM
    from flexs_tpu_torch.runtime.ppo_runner import DevicePPONAM
    from flexs_tpu_torch.runtime.random_runner import DeviceRandomNAM
    from flexs_tpu_torch.runtime.surrogate import SurrogateSpec

    device = resolve_device(device)
    landscape = flexs.landscapes.TFBinding(name="SIX6_REF_R1", device=device)
    common = dict(
        rounds=rounds,
        **{**PAPER, **run_kw},
        model="surrogate",
        surrogate_spec=SurrogateSpec(),
        device=device,
    )
    runners = {"random": DeviceRandomNAM, "dqn": DeviceDQNNAM, "ppo": DevicePPONAM,
               "cbas": DeviceCbASNAM}
    rows = {}
    for name, cls in runners.items():
        rows[name] = rows_by_start(
            f"{name}-cnn", lambda start: cls(landscape, "TGCA", starting_sequence=start, **common),
            tf_binding.STARTS[:starts_n], device)
    bench_line("matrix", device, rounds=rounds, **rows)
    return rows


def bench_archs(rounds: int, device=None, starts_n: int = 2, **run_kw):
    """Quality/latency rows for the surrogate architectures beyond cnn.

    TF-Bind-8 SIX6_REF_R1, paper config: Adalead with the mlp / gem /
    linear / gp surrogates, and GPR_BO with arch="gp" Thompson (an
    acquisition over a real GP posterior, which the reference's GPR_BO
    never has: sigma identically 0, reference bo.py:319).  No reference
    rows exist for any of these: capability and in-band quality.
    """
    import flexs_tpu_torch as flexs
    from flexs_tpu_torch.landscapes import tf_binding
    from flexs_tpu_torch.runtime.gpr_bo_runner import DeviceGPRBONAM
    from flexs_tpu_torch.runtime.jit_runner import DeviceAdaleadNAM
    from flexs_tpu_torch.runtime.surrogate import SurrogateSpec

    device = resolve_device(device)
    landscape = flexs.landscapes.TFBinding(name="SIX6_REF_R1", device=device)
    common = dict(
        rounds=rounds,
        **{**PAPER, **run_kw},
        model="surrogate",
        device=device,
    )
    starts = tf_binding.STARTS[:starts_n]
    rows = {}
    for arch in ("mlp", "gem", "linear", "gp"):
        rows[f"adalead_{arch}"] = rows_by_start(
            f"adalead-{arch}",
            lambda start: DeviceAdaleadNAM(landscape, "TGCA", starting_sequence=start,
                                           surrogate_spec=SurrogateSpec(arch=arch), **common),
            starts, device)
    rows["gpr_bo_gp_thompson"] = rows_by_start(
        "gpr_bo-gp-thompson",
        lambda start: DeviceGPRBONAM(landscape, "TGCA", starting_sequence=start,
                                     method="Thompson", surrogate_spec=SurrogateSpec(arch="gp"),
                                     **common),
        starts, device)
    bench_line("archs", device, rounds=rounds, **rows)
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--starts", type=int, default=5)
    parser.add_argument("--rounds", type=int, default=10)
    parser.add_argument("--host", action="store_true", help="also time the host loop")
    parser.add_argument("--skip-cmaes", action="store_true")
    parser.add_argument("--sweep", action="store_true",
                        help="measure the fused-surrogate sweep throughput")
    parser.add_argument("--matrix", action="store_true",
                        help="quality rows for random/dqn/ppo/cbas surrogate modes")
    parser.add_argument("--archs", action="store_true",
                        help="quality rows for the mlp/gem/linear/gp archs")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = parser.parse_args(argv)

    device = resolve_device("cpu" if args.cpu else None)
    if args.archs:
        bench_archs(args.rounds, device)
        return 0
    if args.matrix:
        bench_matrix(args.rounds, device)
        return 0
    if args.sweep:
        bench_surrogate_sweep(args.rounds, device)
        return 0
    _, steady_r = bench_rosetta_adalead(args.starts, args.rounds, True, device)
    if not args.skip_cmaes:
        bench_tfbind_cmaes(args.rounds, device=device)
    if args.host:
        host_dt = bench_host_rosetta(args.rounds, device)
        print(f"fused vs host-loop speedup: {host_dt / steady_r:.1f}x")
    return 0


if __name__ == "__main__":
    sys.exit(main())
