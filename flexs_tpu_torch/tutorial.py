"""flexs_tpu_torch tutorial: the reference's Tutorial.ipynb as a runnable module.

    python -m flexs_tpu_torch.tutorial [--cpu]

Counterpart of examples/tutorial.py, through the port's public names and
at its sizes.  It walks the reference tutorial's path:
1. pick a benchmark landscape from a registry,
2. wrap it in surrogate models of varying quality,
3. run explorers against it,
4. evaluate robustness to surrogate noise,
and adds the port's extras: the fused runners, which keep every round's
work on the card, and the sweeps, which run many experiments as lockstep
cells.  It runs on the card unless `--cpu` asks for the CPU; under
torchrun the sweeps split their cells over the ranks.
"""
import argparse
import sys
import tempfile

SIZES = {
    "adalead": dict(rounds=5, sequences_batch_size=50, model_queries_per_batch=500),
    "cmaes": dict(rounds=3, sequences_batch_size=20, model_queries_per_batch=200),
    "robustness": dict(rounds=2, sequences_batch_size=20, model_queries_per_batch=100),
    "fused": dict(rounds=5, sequences_batch_size=50, model_queries_per_batch=500),
    "fused_cnn": dict(rounds=3, sequences_batch_size=20, model_queries_per_batch=100),
    "sweep": dict(rounds=3, sequences_batch_size=20, model_queries_per_batch=100),
    "checkpointed": dict(rounds=2, sequences_batch_size=10, model_queries_per_batch=50),
}


def main(device=None, **sizes) -> dict:
    """The tutorial's five steps; `sizes` maps a step of SIZES to its sizes, for tests.

    Returns the readings the tutorial prints: the start's fitness, each
    run's frame and the sweeps' summaries.
    """
    import flexs_tpu_torch as flexs
    from flexs_tpu_torch.bench_sweep import sweep_mesh_and_device
    from flexs_tpu_torch.parallel import run_robustness_sweep
    from flexs_tpu_torch.runtime import DeviceAdaleadNAM
    from flexs_tpu_torch.runtime.surrogate import SurrogateSpec

    size = {k: {**v, **sizes.get(k, {})} for k, v in SIZES.items()}
    mesh, device = sweep_mesh_and_device(device)
    out = {}

    # -----------------------------------------------------------------------
    # 1. Landscapes come from per-module registries of benchmark problems.
    # -----------------------------------------------------------------------
    problem = flexs.landscapes.tf_binding.registry()["SIX6_REF_R1"]
    landscape = flexs.landscapes.TFBinding(**problem["params"], device=device)
    start = problem["starts"][0]
    out["start_fitness"] = float(landscape.get_fitness([start])[0])
    print(f"TF-Bind-8 SIX6_REF_R1; start {start} scores {out['start_fitness']:.4f}")

    # -----------------------------------------------------------------------
    # 2. Models: a tunable-noise wrapper around the truth, or trainable nets.
    # -----------------------------------------------------------------------
    noisy = flexs.baselines.models.NoisyAbstractModel(
        landscape, signal_strength=0.9, seed=0, device=device
    )
    cnn = flexs.baselines.models.CNN(
        seq_len=8, num_filters=16, hidden_size=32, alphabet=flexs.DNAA, epochs=5, device=device
    )
    out["ensemble"] = flexs.Ensemble([cnn])

    # -----------------------------------------------------------------------
    # 3. Explorers drive the propose -> measure -> retrain loop.
    # -----------------------------------------------------------------------
    explorer = flexs.baselines.explorers.Adalead(
        noisy, starting_sequence=start, alphabet=flexs.DNAA, seed=0, **size["adalead"]
    )
    df, _ = explorer.run(landscape, verbose=False)
    out["adalead"] = df
    print(f"Adalead+NAM: top fitness {df['true_score'].max():.4f} "
          f"after {df['round'].max()} rounds "
          f"({landscape.cost} landscape queries)")

    # Any other explorer plugs into the same loop:
    cmaes = flexs.baselines.explorers.CMAES(
        flexs.baselines.models.NoisyAbstractModel(landscape, 0.9, seed=1, device=device),
        starting_sequence=start, alphabet=flexs.DNAA, seed=0, device=device, **size["cmaes"],
    )
    df_cma, _ = cmaes.run(landscape, verbose=False)
    out["cmaes"] = df_cma
    print(f"CMAES: top fitness {df_cma['true_score'].max():.4f}")

    # -----------------------------------------------------------------------
    # 4. Evaluators: standardized sweeps over surrogate quality / budgets.
    # -----------------------------------------------------------------------
    results = flexs.evaluate.robustness(
        flexs.landscapes.TFBinding(**problem["params"], device=device),
        make_explorer=lambda model, ss: flexs.baselines.explorers.Random(
            model, starting_sequence=start, alphabet=flexs.DNAA, seed=0, **size["robustness"]
        ),
        signal_strengths=[0.5, 1.0],
        verbose=False,
    )
    out["robustness"] = results
    for ss, (res_df, _) in results:
        print(f"robustness ss={ss}: top {res_df['true_score'].max():.4f}")

    # -----------------------------------------------------------------------
    # 5. The port's extras: the fused runners and the sweeps.
    # -----------------------------------------------------------------------
    fused = DeviceAdaleadNAM(
        flexs.landscapes.TFBinding(**problem["params"], device=device), flexs.DNAA,
        starting_sequence=start, signal_strength=0.9, seed=0, device=device, **size["fused"],
    )
    df_fused, _ = fused.run(verbose=False)
    out["fused"] = df_fused
    print(f"fused device runner: top {df_fused['true_score'].max():.4f} "
          "(every round's work on the device)")

    # The fused runners also carry trained surrogates: a CNN (or an
    # ensemble) retrained on the measured set every round, the reference
    # paper's empirical-model experiment class.
    fused_cnn = DeviceAdaleadNAM(
        flexs.landscapes.TFBinding(**problem["params"], device=device), flexs.DNAA,
        starting_sequence=start,
        model="surrogate",  # a CNN trained in the run instead of NAM
        surrogate_spec=SurrogateSpec(num_filters=16, hidden_size=32, epochs=5),
        seed=0, device=device, **size["fused_cnn"],
    )
    df_cnn, _ = fused_cnn.run(verbose=False)
    out["fused_cnn"] = df_cnn
    print(f"fused CNN-surrogate runner: top {df_cnn['true_score'].max():.4f}")

    # One process runs every cell on its card; under torchrun the ranks
    # split each chunk of cells (parallel.multihost.multihost_sweep_mesh()).
    sweep = run_robustness_sweep(
        landscape_names=["SIX6_REF_R1"],
        starts=flexs.landscapes.tf_binding.STARTS[:2],
        signal_strengths=[0.0, 1.0],
        mesh=mesh,
        device=device,
        **size["sweep"],
    )
    out["sweep"] = sweep
    print("sweep summary:")
    print(sweep[["landscape", "start", "signal_strength", "max_fitness"]].to_string(index=False))

    # Every fused algorithm accepts every model mode ("nam"/"perfect"/
    # "surrogate"): adalead, random, ga, cmaes, bo, gpr_bo, dqn, ppo, cbas,
    # dbas, plus dynappo/dynappo_mutative (whose built-in r²-gated ensemble
    # replaces the surrogate mode).  SurrogateSpec(arch=...) picks the
    # model family trained in the run: "cnn"/"mlp"/"gem" (SGD-trained
    # nets), "linear" (closed-form OLS), or "gp", an exact Gaussian-process
    # posterior whose sigma powers BO/GPR_BO acquisitions.  Pick the
    # explorer with `algorithm=` and, for long sweeps, make them
    # preemption-safe with `chunk_size` + `checkpoint_dir` (each completed
    # chunk is written to disk; rerunning the same sweep resumes past it).
    # The same matrix is exposed on the command line:
    #   flexs-tpu-torch-sweep --algorithm cbas --model surrogate \
    #       --chunk-size 64 --checkpoint-dir my_sweep
    with tempfile.TemporaryDirectory() as ckpt:
        sweep_kw = dict(
            landscape_names=["SIX6_REF_R1"],
            starts=flexs.landscapes.tf_binding.STARTS[:2],
            signal_strengths=[1.0],
            algorithm="ga",
            algorithm_kwargs={"population_size": 20},
            model="perfect",
            chunk_size=1,
            checkpoint_dir=ckpt,
            mesh=mesh,
            device=device,
            **size["checkpointed"],
        )
        out["checkpointed"] = run_robustness_sweep(**sweep_kw)  # computes + checkpoints
        resumed = run_robustness_sweep(**sweep_kw)  # loads every chunk
    out["resumed"] = resumed
    print("checkpointed GA sweep (resumed):")
    print(resumed[["landscape", "start", "max_fitness"]].to_string(index=False))
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    main(device="cpu" if p.parse_args().cpu else None)
    sys.exit(0)
