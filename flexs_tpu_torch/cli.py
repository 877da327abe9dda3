"""Sweep CLI: the packaged replacement for the reference's cloud runners.

The reference scaled experiments by launching one cloud VM per sweep cell
with ad-hoc argparse scripts (reference paper_code/cloud/runner.py:90-126,
unpackaged).  Here the same grids run as lockstep batches of cells, split
over the ranks of a `torch.distributed` mesh:

    flexs-tpu-torch-sweep --landscapes SIX6_REF_R1 VAX2_REF_R1 \\
        --starts 4 --signal-strengths 0 0.5 0.75 0.9 1 \\
        --rounds 10 --batch 100 --queries 2000 --out results.csv

One process runs every cell on its card; under `torchrun --nproc-per-node
N` each rank runs its share (on card LOCAL_RANK modulo the cards it
sees, for `--device cuda`), every rank gathers the whole grid, and the
first rank writes `--out`.  Results are written as one summary CSV
(per-cell max fitness and costs: the quantities the reference's analysis
notebooks extract from per-run logs).  The flags are the JAX package's
`flexs-tpu-sweep`'s, plus `--device`.
"""
import argparse
import os
import sys
import time


def main(argv=None) -> int:
    """Entry point for the `flexs-tpu-torch-sweep` console script."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "--landscapes",
        nargs="+",
        default=["SIX6_REF_R1"],
        help="TF-binding landscape names (or 'all' for every packed table)",
    )
    parser.add_argument(
        "--starts", type=int, default=2, help="number of starting sequences"
    )
    parser.add_argument(
        "--signal-strengths",
        nargs="+",
        type=float,
        default=[0.0, 0.5, 0.75, 0.9, 1.0],
    )
    parser.add_argument("--seeds", nargs="+", type=int, default=[0])
    parser.add_argument("--rounds", type=int, default=10)
    parser.add_argument("--batch", type=int, default=100)
    parser.add_argument("--queries", type=int, default=2000)
    parser.add_argument("--out", default=None, help="summary CSV path")
    parser.add_argument(
        "--no-mesh", action="store_true",
        help="run unsharded (mesh=None: this process runs every cell)",
    )
    parser.add_argument(
        "--algorithm",
        default="adalead",
        choices=[
            "adalead", "random", "ga", "cmaes", "bo", "gpr_bo", "dqn",
            "ppo", "dynappo", "dynappo_mutative", "cbas", "dbas",
        ],
        help="fused explorer family (adalead uses the shared-table fast "
        "path; the rest go through the generic landscape sweep)",
    )
    parser.add_argument(
        "--model",
        default="nam",
        choices=["nam", "perfect", "surrogate"],
        help="fused model family; 'surrogate' trains a model in the run per "
        "cell (signal strengths are ignored) and routes through the "
        "generic landscape sweep",
    )
    parser.add_argument(
        "--surrogate-arch",
        default="cnn",
        choices=["cnn", "mlp", "gem", "linear", "gp"],
        help="in-run surrogate family for --model surrogate: SGD-fit "
        "nets (cnn/mlp/gem), closed-form OLS (linear), or an "
        "exact Gaussian-process posterior (gp: gives BO/GPR_BO "
        "acquisitions a real sigma)",
    )
    parser.add_argument(
        "--surrogate-ensemble",
        type=int,
        default=1,
        help="in-run surrogate ensemble size (ignored unless "
        "--model surrogate; must stay 1 for --surrogate-arch gp)",
    )
    parser.add_argument(
        "--chunk-size",
        type=int,
        default=None,
        help="cells per lockstep batch (bounds device memory on wide grids)",
    )
    parser.add_argument(
        "--checkpoint-dir",
        default=None,
        help="directory for per-chunk checkpoints; rerunning the same sweep "
        "resumes past completed chunks (use with --chunk-size)",
    )
    parser.add_argument(
        "--device",
        default="cuda",
        help="where this process's cells run: 'cuda' (the default), "
        "'cuda:N' or 'cpu'",
    )
    args = parser.parse_args(argv)

    import torch

    from flexs_tpu_torch.landscapes import tf_binding
    from flexs_tpu_torch.parallel import multihost, run_robustness_sweep

    names = args.landscapes
    if names == ["all"]:
        names = list(tf_binding.registry().keys())
    starts = tf_binding.STARTS[: args.starts]

    mesh, device = None, args.device
    if not args.no_mesh:
        mesh = multihost.multihost_sweep_mesh()
        cards = torch.cuda.device_count()
        if device == "cuda" and "LOCAL_RANK" in os.environ and cards > 1:
            device = f"cuda:{int(os.environ['LOCAL_RANK']) % cards}"
    n_devices = 1 if mesh is None else mesh.size()

    n_ss = 1 if args.model == "surrogate" else len(args.signal_strengths)
    n_cells = len(names) * len(starts) * n_ss * len(args.seeds)
    print(
        f"sweep: {len(names)} landscapes x {len(starts)} starts x "
        f"{n_ss} signal strengths x {len(args.seeds)} "
        f"seeds = {n_cells} cells on {n_devices} device(s)"
    )

    t0 = time.time()
    if (
        args.algorithm == "adalead"
        and args.model == "nam"
        and args.checkpoint_dir is None
    ):
        df = run_robustness_sweep(
            landscape_names=names,
            starts=starts,
            signal_strengths=args.signal_strengths,
            seeds=args.seeds,
            rounds=args.rounds,
            sequences_batch_size=args.batch,
            model_queries_per_batch=args.queries,
            mesh=mesh,
            chunk_size=args.chunk_size,
            device=device,
        )
    else:
        from flexs_tpu_torch.parallel.sweep import run_landscape_robustness_sweep

        surrogate_spec = None
        if args.model == "surrogate":
            from flexs_tpu_torch.runtime.surrogate import SurrogateSpec

            if args.surrogate_arch == "gp" and args.surrogate_ensemble != 1:
                parser.error(
                    "--surrogate-arch gp is an exact posterior; "
                    "--surrogate-ensemble must stay 1"
                )
            surrogate_spec = SurrogateSpec(
                arch=args.surrogate_arch,
                ensemble_size=args.surrogate_ensemble,
            )
        landscapes = []
        for n in names:
            land = tf_binding.TFBinding(**tf_binding.registry()[n]["params"], device=device)
            land.name = n
            landscapes.append(land)
        df = run_landscape_robustness_sweep(
            landscapes,
            "TGCA",
            starts=starts,
            signal_strengths=(
                [1.0] if args.model == "surrogate" else args.signal_strengths
            ),
            seeds=args.seeds,
            rounds=args.rounds,
            sequences_batch_size=args.batch,
            model_queries_per_batch=args.queries,
            mesh=mesh,
            chunk_size=args.chunk_size,
            algorithm=args.algorithm,
            model=args.model,
            surrogate_spec=surrogate_spec,
            checkpoint_dir=args.checkpoint_dir,
            device=device,
        )
    wall = time.time() - t0

    total_seqs = int(df["model_cost"].sum() + df["landscape_cost"].sum())
    print(
        f"done in {wall:.2f}s — {total_seqs} sequences scored "
        f"({total_seqs / wall:.0f}/s), mean max fitness "
        f"{df['max_fitness'].mean():.4f}"
    )
    if args.out and multihost.mesh_share(mesh)[0] == 0:
        df.to_csv(args.out, index=False)
        print(f"wrote {args.out}")
    elif args.out:
        print(f"{args.out} is written by the mesh's first rank")
    else:
        print(df.to_string(index=False, max_rows=20))
    return 0


if __name__ == "__main__":
    sys.exit(main())
