"""The trained-surrogate path of the port: the fused runner, the host models, the sweeps.

Runs draw from torch generators, which cannot replay the JAX package's
`jax.random` streams, so they are held to the invariants of
tests/test_surrogate_runner.py, tests/test_flax_models.py and
tests/test_generic_sweep.py, and exactly to themselves: a sweep cell
equals its standalone run, in every cell mode and chunking.
"""
import os

import numpy as np
import pandas as pd
import pytest
import torch

import flexs_tpu_torch as flexs
from flexs_tpu_torch.baselines import models
from flexs_tpu_torch.landscapes import additive_aav_packaging as aav
from flexs_tpu_torch.landscapes import rna, rosetta, tf_binding
from flexs_tpu_torch.parallel import sweep
from flexs_tpu_torch.runtime import DeviceAdaleadNAM, jit_runner
from flexs_tpu_torch.runtime.surrogate import SurrogateSpec
from flexs_tpu_torch.utils import sequence_utils

TINY = SurrogateSpec(num_filters=8, hidden_size=16, epochs=3, batch_size=64)
GP = SurrogateSpec(arch="gp", gp_opt_steps=15)  # tests/test_surrogate_runner.py:157's
DNA = flexs.DNAA


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel worker processes."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


@pytest.fixture(scope="module")
def landscape():
    return flexs.landscapes.TFBinding(name="SIX6_REF_R1", device="cpu")


def _run(landscape, spec=TINY, alphabet=DNA, start=tf_binding.STARTS[0], **kw):
    kw.setdefault("rounds", 3)
    kw.setdefault("sequences_batch_size", 8)
    kw.setdefault("model_queries_per_batch", 40)
    runner = DeviceAdaleadNAM(
        landscape, alphabet, starting_sequence=start, model="surrogate", surrogate_spec=spec,
        device="cpu", **kw,
    )
    cost_before = landscape.cost
    df, meta = runner.run(verbose=False)
    return df, meta, landscape.cost - cost_before


def _check_invariants(df, landscape, landscape_cost, batch):
    assert df["true_score"].max() >= df["true_score"].iloc[0]
    # The landscape pays only for measurements (start + proposals), never
    # for model queries.
    assert df["measurement_cost"].max() == len(df) == landscape_cost
    assert (df[df["round"] > 0]["model_cost"] > 0).all()
    assert df["sequence"].is_unique
    for r in range(1, df["round"].max() + 1):
        assert 0 < (df["round"] == r).sum() <= batch
    assert np.isfinite(df["model_score"].to_numpy()[1:]).all()
    np.testing.assert_array_equal(
        df["true_score"].to_numpy(), landscape.get_fitness(df["sequence"].tolist())
    )


def test_device_adalead_surrogate(landscape):
    df, meta, cost = _run(landscape)
    assert meta["model_name"] == "CNN_hidden_size_16_num_filters_8"
    _check_invariants(df, landscape, cost, 8)


@pytest.mark.parametrize("spec", [
    TINY._replace(arch="gem"), TINY._replace(arch="mlp"), SurrogateSpec(arch="linear"),
    TINY._replace(ensemble_size=2), TINY._replace(ensemble_size=2, adaptive=True), GP,
], ids=["gem", "mlp", "linear", "ensemble", "adaptive", "gp"])
def test_other_archs_and_ensembles_run_fused(landscape, spec):
    df, meta, cost = _run(landscape, spec, rounds=2)
    _check_invariants(df, landscape, cost, 8)
    assert meta["model_name"] == spec.model_name


def test_ensemble_model_names(landscape):
    assert TINY._replace(ensemble_size=2).model_name == (
        "Ens(CNN_hidden_size_16_num_filters_8|CNN_hidden_size_16_num_filters_8)"
    )
    assert TINY._replace(ensemble_size=2, adaptive=True).model_name.startswith("AdaptiveEns(")
    assert SurrogateSpec().model_name == "CNN_hidden_size_100_num_filters_32"


def test_surrogate_run_is_seeded(landscape):
    a, _, _ = _run(landscape, seed=3)
    b, _, _ = _run(landscape, seed=3)
    c, _, _ = _run(landscape, seed=4)
    pd.testing.assert_frame_equal(a, b)
    assert not a["sequence"].equals(c["sequence"])


def test_model_queries_never_reach_the_oracle(landscape):
    """The oracle scores the start and each round's proposals only: one call each."""
    fn, params = landscape.device_fitness()
    calls = []
    cfg = jit_runner.AdaleadConfig(rounds=3, sequences_batch_size=8, model_queries_per_batch=40,
                                   alphabet_size=4, surrogate=TINY)

    def counted(p, tokens):
        calls.append(tokens.shape[0])
        return fn(p, tokens)

    start = torch.as_tensor(flexs.Alphabet(DNA).encode_one(tf_binding.STARTS[0]))
    result = jit_runner.run_adalead_nam(counted, params, start, cfg, 1.0, torch.Generator())
    assert calls == [1] + [8] * 3
    assert result.landscape_cost.tolist() == [1 + 8 * r for r in (1, 2, 3)]
    assert (result.model_cost > 0).all()


def test_default_spec_is_the_papers_cnn(landscape):
    runner = DeviceAdaleadNAM(landscape, DNA, rounds=1, sequences_batch_size=5,
                              model_queries_per_batch=20, starting_sequence=tf_binding.STARTS[0],
                              model="surrogate", device="cpu")
    assert runner.cfg.surrogate == SurrogateSpec()
    assert runner.model_name == "CNN_hidden_size_100_num_filters_32"


@pytest.mark.parametrize("spec", [
    TINY, TINY._replace(ensemble_size=2), TINY._replace(arch="gem"), SurrogateSpec(arch="linear"),
    TINY._replace(arch="mlp", ensemble_size=2, adaptive=True), GP,
], ids=["cnn", "ensemble", "gem", "linear", "adaptive", "gp"])
def test_lockstep_cells_equal_single_runs(landscape, spec):
    """Three surrogate cells in lockstep equal three single runs, field for field."""
    cfg = jit_runner.AdaleadConfig(rounds=3, sequences_batch_size=8, model_queries_per_batch=40,
                                   alphabet_size=4, surrogate=spec)
    fn, params = landscape.device_fitness()
    tokens = torch.as_tensor(flexs.Alphabet(DNA).encode(tf_binding.STARTS[:3]))

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    cells = jit_runner.run_adalead_nam_cells(
        jit_runner.cell_axis_oracle(fn), params, tokens, cfg, [1.0] * 3, [gen(s) for s in range(3)]
    )
    for c in range(3):
        single = jit_runner.run_adalead_nam(fn, params, tokens[c], cfg, 1.0, gen(c))
        for name, got, want in zip(single._fields, cells, single):
            assert torch.equal(got[c], want), (c, name)


# --- host models (tests/test_flax_models.py) --------------------------------


def _dataset(n=64, length=8, seed=0):
    rng = np.random.default_rng(seed)
    seqs = list(dict.fromkeys(sequence_utils.generate_random_sequences(length, n, DNA, rng=rng)))
    labels = np.array([sum(c == "A" for c in s) / len(s) for s in seqs])
    return seqs, labels


@pytest.mark.parametrize("make", [
    lambda: models.CNN(8, num_filters=8, hidden_size=16, alphabet=DNA, device="cpu"),
    lambda: models.MLP(8, hidden_size=16, alphabet=DNA, device="cpu"),
    lambda: models.GlobalEpistasisModel(8, hidden_size=16, alphabet=DNA, device="cpu"),
], ids=["cnn", "mlp", "gem"])
def test_torch_models_smoke(make):
    model = make()
    seqs, labels = _dataset(32)
    model.train(seqs, labels)
    preds = model.get_fitness(seqs)
    assert preds.shape == (len(seqs),) and preds.dtype == np.float64
    assert np.isfinite(preds).all()
    assert model.cost == len(seqs)


def test_model_names_keep_the_reference_strings():
    assert models.CNN(8, 32, 100, DNA, device="cpu").name == "CNN_hidden_size_100_num_filters_32"
    assert models.MLP(8, 16, DNA, device="cpu").name == "MLP_hidden_size_16"
    assert models.GlobalEpistasisModel(8, 16, DNA, device="cpu").name == "MLP_hidden_size_16"


def test_mlp_learns_additive_signal():
    model = models.MLP(8, hidden_size=32, alphabet=DNA, epochs=80, seed=0, device="cpu")
    seqs, labels = _dataset(200, seed=1)
    model.train(seqs, labels)
    assert np.corrcoef(model.get_fitness(seqs), labels)[0, 1] > 0.9


def test_warm_start_progresses():
    model = models.MLP(8, hidden_size=16, alphabet=DNA, epochs=5, seed=0, device="cpu")
    seqs, labels = _dataset(64)
    model.train(seqs, labels)
    first = np.mean((model.get_fitness(seqs) - labels) ** 2)
    for _ in range(5):
        model.train(seqs, labels)
    assert np.mean((model.get_fitness(seqs) - labels) ** 2) < first


def test_odd_batch_sizes_no_error():
    model = models.MLP(8, hidden_size=8, alphabet=DNA, epochs=1, batch_size=16, device="cpu")
    seqs, labels = _dataset(37)
    model.train(seqs, labels)
    assert model.get_fitness(seqs[:5]).shape == (5,)
    assert model.get_fitness(seqs[:1]).shape == (1,)


def test_padding_only_minibatch_still_moves_the_host_model():
    """Three rows at batch 1 pad to four: every epoch has one minibatch of padding only,
    and the host fit (Keras semantics through the JAX package) still applies it."""
    model = models.MLP(8, hidden_size=8, alphabet=DNA, epochs=2, batch_size=1, device="cpu")
    seqs, labels = _dataset(3)
    model.train(seqs, labels)
    assert int(model._state.count[0]) == 2 * 4


def test_custom_train_and_predict_functions():
    calls = {"train": 0}

    def custom_train(one_hots, labels):
        calls["train"] += 1
        assert one_hots.ndim == 3 and len(labels) == one_hots.shape[0]

    def custom_predict(one_hots):
        return np.full(one_hots.shape[0], 0.25)

    model = models.TorchModel(
        module=None, alphabet=DNA, name="custom", custom_train_function=custom_train,
        custom_predict_function=custom_predict, device="cpu",
    )
    seqs, labels = _dataset(8)
    model.train(seqs, labels)
    assert calls["train"] == 1
    np.testing.assert_allclose(model.get_fitness(seqs[:3]), [0.25] * 3)


def test_mesh_is_not_ported():
    """`mesh=` is ported (ROADMAP item 17); a mesh that is not a DeviceMesh raises at once."""
    with pytest.raises(TypeError, match="DeviceMesh"):
        models.MLP(8, hidden_size=8, alphabet=DNA, mesh=object(), device="cpu")


def test_host_adalead_with_a_cnn(landscape):
    """The host loop: Adalead asks a CNN retrained every round (3 rounds, seeded)."""

    def run():
        model = models.CNN(8, 8, 16, DNA, epochs=3, batch_size=32, device="cpu")
        explorer = flexs.baselines.explorers.Adalead(
            model, rounds=3, sequences_batch_size=8, model_queries_per_batch=40,
            starting_sequence=tf_binding.STARTS[0], alphabet=DNA, seed=0,
        )
        return explorer.run(landscape, verbose=False)

    df, meta = run()
    again, _ = run()
    assert meta["model_name"] == "CNN_hidden_size_16_num_filters_8"
    assert df["round"].max() == 3 and df["sequence"].is_unique
    assert (df[df["round"] > 0]["model_cost"] > 0).all()
    pd.testing.assert_frame_equal(df, again)


# --- the generic sweep (tests/test_generic_sweep.py) --------------------------


@pytest.fixture(scope="module")
def rna_family():
    reg = rna.registry()
    lands = [rna.RNABinding(**reg[f"L14_RNA{i}"]["params"], device="cpu") for i in (1, 2, 3, 4)]
    return lands, [reg["L14_RNA1"]["starts"][k] for k in (1, 2)]


SMALL = dict(rounds=2, sequences_batch_size=5, model_queries_per_batch=20, device="cpu")


def test_rna_family_sweep_cell_equals_standalone(rna_family):
    lands, starts = rna_family
    df = sweep.run_landscape_robustness_sweep(lands, flexs.RNAA, starts, [0.9], seeds=[2],
                                              **SMALL)
    assert len(df) == 8 and (df["max_fitness"] >= df["start_fitness"]).all()
    assert df["landscape"].tolist() == [land.name for land in lands for _ in starts]
    for i in (0, 7):
        row = df.iloc[i]
        land = rna.RNABinding(**rna.registry()[f"L14_RNA{1 + i // 2}"]["params"], device="cpu")
        single, _ = DeviceAdaleadNAM(
            land, flexs.RNAA, starting_sequence=row["start"], signal_strength=0.9, seed=2,
            **SMALL,
        ).run(verbose=False)
        assert row["max_fitness"] == single["true_score"].max()
        assert row["model_cost"] == single["model_cost"].iloc[-1]
        assert row["landscape_cost"] == land.cost


def test_rna_family_map_equals_vmap_and_chunks(rna_family):
    lands, starts = rna_family
    kw = dict(signal_strengths=[0.5, 1.0], **SMALL)
    vmapped = sweep.run_landscape_robustness_sweep(lands[:2], flexs.RNAA, starts, **kw)
    mapped = sweep.run_landscape_robustness_sweep(lands[:2], flexs.RNAA, starts, cell_mode="map",
                                                  **kw)
    chunked = sweep.run_landscape_robustness_sweep(lands[:2], flexs.RNAA, starts, chunk_size=3,
                                                   **kw)
    pd.testing.assert_frame_equal(vmapped, mapped)
    pd.testing.assert_frame_equal(vmapped, chunked)


def test_grouped_oracle_scores_each_cell_on_its_landscape(rna_family):
    lands, _ = rna_family
    fns = [land.device_fitness() for land in lands]
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, 4, (5, 6, 14)))
    groups = [(2, torch.tensor([0, 3])), (0, torch.tensor([1])), (3, torch.tensor([2, 4]))]
    got = sweep._grouped_fitness((fns[0][0], [p for _, p in fns], groups), tokens)
    for li, cells in groups:
        for c in cells.tolist():
            assert torch.equal(got[c], lands[li].fitness_from_tokens(tokens[c]))


def test_generic_sweep_rejects_mixed_families():
    l_rna = rna.RNABinding(**rna.registry()["L14_RNA1"]["params"], device="cpu")
    l_aav = aav.AdditiveAAVPackaging(phenotype="heart", start=450, end=540, device="cpu")
    with pytest.raises(ValueError, match="one device fitness fn"):
        sweep.run_landscape_robustness_sweep([l_rna, l_aav], flexs.RNAA, ["A" * 14], **SMALL)


@pytest.fixture(scope="module")
def aav_pair():
    return [aav.AdditiveAAVPackaging(phenotype=p, start=450, end=540, device="cpu")
            for p in ("heart", "lung")]


def test_aav_nam_sweep(aav_pair):
    kw = dict(alphabet=flexs.AAS, starts=[aav_pair[0].wild_type], signal_strengths=[1.0, 0.5],
              **SMALL)
    a = sweep.run_landscape_robustness_sweep(aav_pair, **kw)
    b = sweep.run_landscape_robustness_sweep(aav_pair, chunk_size=3, **kw)
    pd.testing.assert_frame_equal(a, b)
    assert len(a) == 4 and (a["model_cost"] > 0).all()
    assert (a["max_fitness"] >= a["start_fitness"]).all()
    assert a["landscape"].tolist()[::2] == [land.name for land in aav_pair]


def test_generic_checkpoint_resume(aav_pair, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    kw = dict(alphabet=flexs.AAS, starts=[aav_pair[0].wild_type], signal_strengths=[0.9],
              seeds=[0, 1], chunk_size=3, checkpoint_dir=ckpt, **SMALL)
    first = sweep.run_landscape_robustness_sweep(aav_pair, **kw)
    chunks = sorted(f for f in os.listdir(ckpt) if f.startswith("chunk_"))
    assert chunks == ["chunk_00000.npz", "chunk_00001.npz"]
    os.remove(os.path.join(ckpt, chunks[1]))
    jit_runner.reset_run_counts()
    resumed = sweep.run_landscape_robustness_sweep(aav_pair, **kw)
    assert jit_runner.run_counts["runs"] == 1  # the deleted chunk only
    pd.testing.assert_frame_equal(first, resumed)
    with pytest.raises(ValueError, match="DIFFERENT sweep"):
        sweep.run_landscape_robustness_sweep(aav_pair, **{**kw, "seeds": [5, 6]})
    # Another phenotype under the same name: the content fingerprint differs.
    other = aav.AdditiveAAVPackaging(phenotype="liver", start=450, end=540, device="cpu")
    other.name = aav_pair[1].name
    with pytest.raises(ValueError, match="DIFFERENT sweep"):
        sweep.run_landscape_robustness_sweep([aav_pair[0], other], **kw)
    with pytest.raises(ValueError, match="DIFFERENT sweep"):
        sweep.run_landscape_robustness_sweep(aav_pair, model="surrogate", surrogate_spec=TINY,
                                             **kw)


def test_surrogate_sweep_cells_equal_standalone_runs():
    """bench.py's surrogate sweep shape at a tiny size: Rosetta 3msi, starts x seeds."""
    problem = rosetta.registry()["3msi"]
    land = rosetta.RosettaFolding(**problem["params"], device="cpu")
    starts = [problem["starts"][k] for k in ("ed_3_wt", "ed_12_wt")]
    kw = dict(signal_strengths=[1.0], seeds=[0, 1], model="surrogate", surrogate_spec=TINY, **SMALL)
    df = sweep.run_landscape_robustness_sweep([land], flexs.AAS, starts, **kw)
    assert len(df) == 4 and (df["model_cost"] > 0).all()
    assert (df["landscape_cost"] == 1 + 2 * 5).all()
    pd.testing.assert_frame_equal(
        df, sweep.run_landscape_robustness_sweep([land], flexs.AAS, starts, cell_mode="vmap", **kw)
    )
    for i in (0, 3):
        row = df.iloc[i]
        single, _, cost = _run(land, TINY, flexs.AAS, row["start"], seed=int(row["seed"]),
                               rounds=2, sequences_batch_size=5, model_queries_per_batch=20)
        assert row["max_fitness"] == single["true_score"].max()
        assert row["model_cost"] == single["model_cost"].iloc[-1]
        assert row["landscape_cost"] == cost


def test_robustness_sweep_routes_surrogates_through_the_generic_sweep():
    grid = dict(landscape_names=["SIX6_REF_R1", "ARX_L343Q_R1"], starts=tf_binding.STARTS[:1],
                signal_strengths=[1.0], seeds=[0], rounds=2, sequences_batch_size=5,
                model_queries_per_batch=20, device="cpu")
    got = sweep.run_robustness_sweep(**grid, model="surrogate", surrogate_spec=TINY)
    lands = []
    for name in grid["landscape_names"]:
        land = tf_binding.TFBinding(name=name, device="cpu")
        land.name = name
        lands.append(land)
    want = sweep.run_landscape_robustness_sweep(
        lands, DNA, tf_binding.STARTS[:1], [1.0], rounds=2, sequences_batch_size=5,
        model_queries_per_batch=20, model="surrogate", surrogate_spec=TINY, device="cpu",
    )
    pd.testing.assert_frame_equal(got, want)
    assert got["landscape"].tolist() == grid["landscape_names"]


def test_efficiency_and_adaptivity_with_a_surrogate():
    eff = sweep.run_efficiency_sweep(["SIX6_REF_R1"], tf_binding.STARTS[:1], budgets=[(5, 20)],
                                     rounds=2, model="surrogate", surrogate_spec=TINY,
                                     device="cpu")
    assert len(eff) == 1 and eff["landscape_cost"].iloc[0] == 1 + 2 * 5
    ada = sweep.run_adaptivity_sweep(["SIX6_REF_R1"], tf_binding.STARTS[:1], num_rounds=[1, 2],
                                     total_ground_truth_measurements=10, total_model_queries=40,
                                     model="surrogate", surrogate_spec=TINY, device="cpu")
    assert set(ada["rounds"]) == {1, 2}
    assert (ada["max_fitness"] >= ada["start_fitness"]).all() and (ada["model_cost"] > 0).all()


@pytest.mark.parametrize("kw,item", [({"mesh": object()}, "DeviceMesh"),
                                     ({"mesh": object(), "algorithm": "dynappo"}, "DeviceMesh")])
def test_generic_sweep_unported_options_raise(aav_pair, kw, item):
    """`mesh=` is ported (ROADMAP item 17); a mesh that is not a DeviceMesh raises at once."""
    with pytest.raises(TypeError, match=item):
        sweep.run_landscape_robustness_sweep(aav_pair, flexs.AAS, [aav_pair[0].wild_type], **kw,
                                             **SMALL)


def test_gp_surrogate_sweep_cells_equal_standalone_runs():
    """The GP surrogate through the generic sweep on RNABinding: "map" (the
    "auto" default for a surrogate) equals "vmap", and cells equal their
    standalone runs."""
    reg = rna.registry()
    land = rna.RNABinding(**reg["L14_RNA1"]["params"], device="cpu")
    starts = [reg["L14_RNA1"]["starts"][k] for k in (1, 2, 3)]
    kw = dict(signal_strengths=[1.0], seeds=[0], rounds=2, sequences_batch_size=5,
              model_queries_per_batch=20, model="surrogate", surrogate_spec=GP, device="cpu")
    df = sweep.run_landscape_robustness_sweep([land], flexs.RNAA, starts, **kw)
    assert len(df) == 3 and (df["model_cost"] > 0).all()
    pd.testing.assert_frame_equal(
        df, sweep.run_landscape_robustness_sweep([land], flexs.RNAA, starts, cell_mode="vmap",
                                                 **kw))
    for i in (0, 2):
        row = df.iloc[i]
        single, meta, cost = _run(land, GP, flexs.RNAA, row["start"], rounds=2,
                                  sequences_batch_size=5, model_queries_per_batch=20)
        assert meta["model_name"] == "gaussian_process"
        assert row["max_fitness"] == single["true_score"].max()
        assert row["model_cost"] == single["model_cost"].iloc[-1]
        assert row["landscape_cost"] == cost
