"""The port's sweep engine on the CPU, at the size of tests/test_sweep.py.

A cell's result depends only on its own (landscape, start, signal
strength, seed), so the sweep is held exactly: a cell equals the
standalone fused run, chunking and `cell_mode` change nothing.  The JAX
sweep draws from `jax.random`, so against it only the summary's schema and
cell order are compared.
"""
import os

import numpy as np
import pandas as pd
import pytest
import torch

import flexs_tpu_torch as flexs
from flexs_tpu_torch.landscapes import tf_binding
from flexs_tpu_torch.parallel import sweep
from flexs_tpu_torch.runtime import DeviceAdaleadNAM, VAEConfig
from flexs_tpu_torch.runtime.jit_runner import AdaleadConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel worker processes."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


GRID = dict(
    landscape_names=["SIX6_REF_R1"],
    starts=tf_binding.STARTS[:2],
    signal_strengths=[0.0, 1.0],
    rounds=2,
    sequences_batch_size=5,
    model_queries_per_batch=20,
)


def _sweep(**kw):
    return sweep.run_robustness_sweep(**{**GRID, "device": "cpu", **kw})


def _flat_cells(names, starts, signal_strengths, seeds):
    """The arguments of `sweep_adalead_nam` for a grid, in the sweep's cell order."""
    all_names, _ = tf_binding._packed_tables()
    cells = [(n, s, ss, sd) for n in names for s in starts for ss in signal_strengths
             for sd in seeds]
    return (
        np.array([all_names.index(c[0]) for c in cells]),
        flexs.Alphabet(flexs.DNAA).encode([c[1] for c in cells]),
        np.array([c[2] for c in cells], np.float32),
        np.array([c[3] for c in cells]),
    )


def _engine(chunk_size=None, cell_mode="vmap", **kw):
    args = _flat_cells(
        ["SIX6_REF_R1", "ARX_L343Q_R1"], tf_binding.STARTS[:2], [0.5, 1.0], [3]
    )
    cfg = AdaleadConfig(rounds=2, sequences_batch_size=5, model_queries_per_batch=20,
                        alphabet_size=4)
    tables = tf_binding._device_tables(torch.device("cpu"))[1]
    return sweep.sweep_adalead_nam(tables, *args, cfg, None, chunk_size, device="cpu",
                                   cell_mode=cell_mode, **kw)


@pytest.fixture(scope="module")
def unchunked():
    return _engine()


def test_sweep_invariants():
    df = _sweep()
    assert len(df) == 4
    assert (df["max_fitness"] >= df["start_fitness"]).all()
    assert (df["model_cost"] > 0).all()


@pytest.mark.parametrize("signal_strength,seed", [(0.9, 7), (0.0, 0)])
def test_sweep_cell_equals_standalone_runner(signal_strength, seed):
    """Exact: same landscape, start, signal strength and seed, same program."""
    df = _sweep(signal_strengths=[signal_strength], starts=tf_binding.STARTS[:1],
                seeds=[seed])
    landscape = flexs.landscapes.TFBinding(name="SIX6_REF_R1", device="cpu")
    single, _ = DeviceAdaleadNAM(
        landscape, flexs.DNAA, rounds=2, sequences_batch_size=5,
        model_queries_per_batch=20, starting_sequence=tf_binding.STARTS[0],
        signal_strength=signal_strength, seed=seed, device="cpu",
    ).run(verbose=False)
    row = df.iloc[0]
    assert row["max_fitness"] == single["true_score"].max()
    assert row["start_fitness"] == single["true_score"].iloc[0]
    assert row["model_cost"] == single["model_cost"].iloc[-1]
    assert row["landscape_cost"] == landscape.cost


def test_engine_cell_equals_standalone_run_result(unchunked):
    """Every RunResult field of a sweep cell equals the standalone run's, exactly."""
    from flexs_tpu_torch.runtime.jit_runner import run_adalead_nam

    landscape = flexs.landscapes.TFBinding(name="ARX_L343Q_R1", device="cpu")
    gen = torch.Generator()
    gen.manual_seed(3)
    cfg = AdaleadConfig(rounds=2, sequences_batch_size=5, model_queries_per_batch=20,
                        alphabet_size=4)
    start = torch.as_tensor(flexs.Alphabet(flexs.DNAA).encode_one(tf_binding.STARTS[1]))
    single = run_adalead_nam(*landscape.device_fitness(), start, cfg, 1.0, gen)
    cell = 7  # ARX_L343Q_R1, STARTS[1], ss 1.0
    for name, got, want in zip(single._fields, unchunked, single):
        np.testing.assert_array_equal(got[cell], want.numpy(), err_msg=name)


@pytest.mark.parametrize("chunk_size", [3, 8])
def test_chunking_equals_unchunked(unchunked, chunk_size):
    """chunk_size=3 pads the tail chunk; every field must still be equal."""
    chunked = _engine(chunk_size=chunk_size)
    for name, a, b in zip(unchunked._fields, unchunked, chunked):
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_cell_mode_map_equals_vmap(unchunked):
    mapped = _engine(cell_mode="map")
    for name, a, b in zip(unchunked._fields, unchunked, mapped):
        np.testing.assert_array_equal(a, b, err_msg=name)
    a = _sweep(cell_mode="vmap")
    b = _sweep(cell_mode="map")
    pd.testing.assert_frame_equal(a, b)


def test_run_counts_count_chunks_syncs_and_draws():
    from flexs_tpu_torch.runtime import jit_runner

    jit_runner.reset_run_counts()
    _engine(chunk_size=3)
    counts = dict(jit_runner.run_counts)
    assert counts["runs"] == 3
    assert counts["syncs"] > 0 and counts["draw_calls"] > 0
    jit_runner.reset_run_counts()
    _engine(chunk_size=3, cell_mode="map")
    assert jit_runner.run_counts["runs"] == 9  # 8 cells, padded to 9


def test_summary_schema_and_order_equal_jax():
    """Same grid through both packages: columns, dtypes and cell order."""
    import flexs_tpu.parallel.sweep as jax_sweep

    grid = {**GRID, "seeds": [0, 1]}
    got = _sweep(**grid)
    want = jax_sweep.run_robustness_sweep(**grid)
    assert list(got.columns) == list(want.columns)
    assert got.dtypes.to_dict() == want.dtypes.to_dict()
    keys = ["landscape", "start", "signal_strength", "seed"]
    pd.testing.assert_frame_equal(got[keys], want[keys])


def test_summary_df_equals_jax_on_one_result(unchunked):
    """Both packages' `_summary_df` on one RunResult give the same frame."""
    import flexs_tpu.parallel.sweep as jax_sweep

    cells = [(n, s, ss, 3) for n in ["SIX6_REF_R1", "ARX_L343Q_R1"]
             for s in tf_binding.STARTS[:2] for ss in [0.5, 1.0]]
    pd.testing.assert_frame_equal(
        sweep._summary_df(unchunked, cells), jax_sweep._summary_df(unchunked, cells)
    )


def test_efficiency_sweep_budget_grid():
    df = sweep.run_efficiency_sweep(
        landscape_names=["SIX6_REF_R1"],
        starts=tf_binding.STARTS[:1],
        budgets=[(5, 20), (10, 30)],
        rounds=2,
        device="cpu",
    )
    assert len(df) == 2
    assert set(df["sequences_batch_size"]) == {5, 10}
    # Bigger measurement budget measures more sequences.
    small = df[df["sequences_batch_size"] == 5]["landscape_cost"].iloc[0]
    big = df[df["sequences_batch_size"] == 10]["landscape_cost"].iloc[0]
    assert big > small


def test_adaptivity_sweep_round_splits():
    df = sweep.run_adaptivity_sweep(
        landscape_names=["SIX6_REF_R1"],
        starts=tf_binding.STARTS[:1],
        num_rounds=[1, 2],
        total_ground_truth_measurements=10,
        total_model_queries=40,
        device="cpu",
    )
    assert set(df["rounds"]) == {1, 2}
    assert (df["max_fitness"] >= df["start_fitness"]).all()


def test_checkpoint_resume(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    first = _sweep(chunk_size=3, checkpoint_dir=ckpt)
    chunks = sorted(f for f in os.listdir(ckpt) if f.startswith("chunk_"))
    assert chunks == ["chunk_00000.npz", "chunk_00001.npz"]
    assert os.path.exists(os.path.join(ckpt, "manifest.json"))
    os.remove(os.path.join(ckpt, chunks[1]))
    from flexs_tpu_torch.runtime import jit_runner

    jit_runner.reset_run_counts()
    resumed = _sweep(chunk_size=3, checkpoint_dir=ckpt)
    assert jit_runner.run_counts["runs"] == 1  # the deleted chunk only
    pd.testing.assert_frame_equal(first, resumed)
    with pytest.raises(ValueError, match="DIFFERENT sweep"):
        _sweep(chunk_size=3, checkpoint_dir=ckpt, signal_strengths=[0.0, 0.5])


@pytest.mark.parametrize(
    "kw,item",
    [
        ({"mesh": object()}, "DeviceMesh"),
        ({"mesh": object(), "algorithm": "dqn"}, "DeviceMesh"),
        ({"mesh": object(), "algorithm": "ppo", "algorithm_kwargs": {"train_epochs": 2}},
         "DeviceMesh"),
    ],
)
def test_unported_options_raise(kw, item):
    """`mesh=` is ported (ROADMAP item 17); a mesh that is not a DeviceMesh raises at once."""
    with pytest.raises(TypeError, match=item):
        _sweep(**kw)
    with pytest.raises(TypeError, match=item):
        sweep.run_efficiency_sweep(["SIX6_REF_R1"], tf_binding.STARTS[:1], device="cpu", **kw)


def test_bad_model_and_cell_mode_raise():
    with pytest.raises(ValueError, match="model must be"):
        _sweep(model="bogus")
    with pytest.raises(ValueError, match="cell_mode"):
        _sweep(cell_mode="bogus")


def test_default_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sweep.run_robustness_sweep(**GRID)


# Each ported family at a tiny size, its hyperparameters cut to fit.
SMALL_ALGORITHMS = {
    "random": {"batch": 8},
    "ga": {"population_size": 10, "children_proportion": 0.5},
    "cmaes": {"population_size": 8},
    "bo": {"num_chains": 3},
    "gpr_bo": {},
    "cbas": {"cycle_batch_size": 20, "vae_cfg": VAEConfig(intermediate_dim=32, epochs=3)},
    "dbas": {"cycle_batch_size": 20, "vae_cfg": VAEConfig(intermediate_dim=32, epochs=3)},
    "dqn": {"memory_size": 64, "train_epochs": 3},
    "ppo": {"train_epochs": 2},
    "dynappo": {"env_batch_size": 4, "train_epochs": 2},
    "dynappo_mutative": {"env_batch_size": 4, "episode_len": 4, "train_epochs": 2},
}
FAMILY_RUNNERS = {
    "random": "DeviceRandomNAM", "ga": "DeviceGeneticAlgorithmNAM", "cmaes": "DeviceCMAESNAM",
    "bo": "DeviceBONAM", "gpr_bo": "DeviceGPRBONAM", "cbas": "DeviceCbASNAM",
    "dbas": "DeviceCbASNAM", "dqn": "DeviceDQNNAM", "ppo": "DevicePPONAM",
    "dynappo": "DeviceDynaPPONAM", "dynappo_mutative": "DeviceDynaPPOMutativeNAM",
}
SMALL_RUN = dict(rounds=2, sequences_batch_size=6, model_queries_per_batch=40)


@pytest.mark.parametrize("algorithm", list(SMALL_ALGORITHMS))
def test_family_sweep_cell_equals_standalone_run(algorithm):
    """A 4-cell lockstep chunk over two landscapes: its last cell equals the standalone run."""
    from flexs_tpu_torch import runtime

    names = ["SIX6_REF_R1", "ARX_L343Q_R1"]
    lands = [flexs.landscapes.TFBinding(name=n, device="cpu") for n in names]
    kw = SMALL_ALGORITHMS[algorithm]
    df = sweep.run_landscape_robustness_sweep(
        lands, flexs.DNAA, starts=tf_binding.STARTS[:2], signal_strengths=[0.9],
        seeds=[2], algorithm=algorithm, algorithm_kwargs=kw, device="cpu", **SMALL_RUN)
    assert len(df) == 4 and (df["max_fitness"] >= df["start_fitness"]).all()
    land = flexs.landscapes.TFBinding(name=names[1], device="cpu")
    extra = {"algo": algorithm} if algorithm in ("cbas", "dbas") else {}
    single, _ = getattr(runtime, FAMILY_RUNNERS[algorithm])(
        land, flexs.DNAA, starting_sequence=tf_binding.STARTS[1], signal_strength=0.9,
        seed=2, device="cpu", **SMALL_RUN, **kw, **extra).run(verbose=False)
    row = df.iloc[-1]
    assert row["max_fitness"] == single["true_score"].max()
    assert row["model_cost"] == single["model_cost"].iloc[-1]
    assert row["landscape_cost"] == land.cost


@pytest.mark.parametrize("algorithm", ["dynappo", "dynappo_mutative"])
def test_dynappo_families_reject_a_surrogate(algorithm):
    """DynaPPO's runners take no trained surrogate, through the class and both sweeps."""
    from flexs_tpu_torch import runtime

    kw = dict(signal_strengths=[1.0], algorithm=algorithm, model="surrogate", device="cpu",
              **SMALL_RUN)
    with pytest.raises(ValueError, match="model='surrogate' does not apply"):
        sweep.run_robustness_sweep(["SIX6_REF_R1"], tf_binding.STARTS[:1], **kw)
    land = flexs.landscapes.TFBinding(name="SIX6_REF_R1", device="cpu")
    with pytest.raises(ValueError, match="model='surrogate' does not apply"):
        sweep.run_landscape_robustness_sweep([land], flexs.DNAA, tf_binding.STARTS[:1], **kw)
    with pytest.raises(ValueError, match="model must be 'nam' or 'perfect'"):
        getattr(runtime, FAMILY_RUNNERS[algorithm])(
            land, flexs.DNAA, starting_sequence=tf_binding.STARTS[0], model="surrogate",
            device="cpu", **SMALL_RUN)


def test_robustness_sweep_routes_other_algorithms():
    """`run_robustness_sweep(algorithm="ga")` equals the landscape sweep of the same grid."""
    grid = dict(starts=tf_binding.STARTS[:1], signal_strengths=[0.5, 0.9], seeds=[0, 1],
                algorithm="ga", algorithm_kwargs=SMALL_ALGORITHMS["ga"], device="cpu",
                **SMALL_RUN)
    got = sweep.run_robustness_sweep(["SIX6_REF_R1"], **grid)
    land = flexs.landscapes.TFBinding(name="SIX6_REF_R1", device="cpu")
    land.name = "SIX6_REF_R1"
    want = sweep.run_landscape_robustness_sweep([land], flexs.DNAA, **grid)
    pd.testing.assert_frame_equal(got, want)


def test_gpr_bo_perfect_sweep_equals_jax():
    """No randomness reaches a perfect GPR_BO run: the summary equals the JAX sweep's."""
    import flexs_tpu
    import flexs_tpu.parallel.sweep as jax_sweep

    grid = dict(starts=tf_binding.STARTS[:2], signal_strengths=[1.0], seeds=[0, 1],
                algorithm="gpr_bo", model="perfect", **SMALL_RUN)
    names = ["SIX6_REF_R1", "ARX_L343Q_R1"]
    lands = [flexs.landscapes.TFBinding(name=n, device="cpu") for n in names]
    jax_lands = [flexs_tpu.landscapes.TFBinding(
        **flexs_tpu.landscapes.tf_binding.registry()[n]["params"]) for n in names]
    for ours, theirs in zip(lands, jax_lands):
        ours.name = theirs.name = "TF_Binding"
    got = sweep.run_landscape_robustness_sweep(lands, flexs.DNAA, device="cpu", **grid)
    want = jax_sweep.run_landscape_robustness_sweep(jax_lands, flexs.DNAA, **grid)
    pd.testing.assert_frame_equal(got, want)


def test_checkpoint_signature_depends_on_algorithm_and_kwargs(tmp_path):
    """Chunks of an Adalead sweep, or of a GA sweep with other kwargs, are refused."""
    land = flexs.landscapes.TFBinding(name="SIX6_REF_R1", device="cpu")
    grid = dict(starts=tf_binding.STARTS[:2], signal_strengths=[0.9], seeds=[0],
                chunk_size=1, device="cpu", **SMALL_RUN)
    ga = dict(algorithm="ga", algorithm_kwargs=SMALL_ALGORITHMS["ga"])
    adalead_dir, ga_dir = str(tmp_path / "adalead"), str(tmp_path / "ga")
    sweep.run_landscape_robustness_sweep([land], flexs.DNAA, checkpoint_dir=adalead_dir, **grid)
    with pytest.raises(ValueError, match="DIFFERENT sweep"):
        sweep.run_landscape_robustness_sweep([land], flexs.DNAA, checkpoint_dir=adalead_dir,
                                             **grid, **ga)
    first = sweep.run_landscape_robustness_sweep([land], flexs.DNAA, checkpoint_dir=ga_dir,
                                                 **grid, **ga)
    pd.testing.assert_frame_equal(first, sweep.run_landscape_robustness_sweep(
        [land], flexs.DNAA, checkpoint_dir=ga_dir, **grid, **ga))
    other = dict(algorithm="ga", algorithm_kwargs={**SMALL_ALGORITHMS["ga"], "beta": 0.1})
    with pytest.raises(ValueError, match="DIFFERENT sweep"):
        sweep.run_landscape_robustness_sweep([land], flexs.DNAA, checkpoint_dir=ga_dir,
                                             **grid, **other)


def test_unknown_algorithm_raises():
    with pytest.raises(ValueError, match="unknown fused algorithm"):
        _sweep(algorithm="simulated_annealing")
