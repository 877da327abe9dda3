"""The CUDA duplex kernels held against their plain version, and the port on the card.

These tests need a CUDA card and the CUDA toolkit; elsewhere they skip.
They import nothing of JAX, so on a machine without it they run as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from flexs_tpu_torch import profile_duplex_rowcost
from flexs_tpu_torch.landscapes import rna
from flexs_tpu_torch.ops import cuda_duplex
from flexs_tpu_torch.ops import rna_duplex as rd

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _tokens(rng, shape, dev):
    return torch.as_tensor(rng.integers(0, 4, shape), device=dev)


@pytest.mark.parametrize(
    "b,l1,n_t,l2,maxloop",
    [
        (7, 37, 1, 37, 16),  # L2 not a multiple of the warp
        (3, 20, 3, 300, 16),  # > 48 KB of shared memory, three targets
        (2, 12, 1, 600, 16),  # too wide for the compile-time window's blocks
        (16, 30, 2, 25, 3),  # the smallest window the kernel takes
        (16, 40, 1, 40, 7),
        (1, 1, 1, 1, 16),  # one cell
    ],
)
def test_kernel_equals_plain(card, b, l1, n_t, l2, maxloop):
    rng = np.random.default_rng(b * 1000 + l2)
    params = rd.DuplexParams.calibrated() if maxloop == 16 else rd.DuplexParams(maxloop=maxloop)
    em = params.energy_model(card)
    tokens = _tokens(rng, (b, l1), card)
    targets_rev = _tokens(rng, (n_t, l2), card)
    before = cuda_duplex.launches
    got = cuda_duplex.duplex_energies(tokens, targets_rev, em, maxloop)
    assert cuda_duplex.launches == before + 1
    want = cuda_duplex.duplex_energies_plain(tokens, targets_rev, em, maxloop)
    torch.cuda.synchronize()
    assert got.shape == (b, n_t) and got.device == tokens.device
    assert torch.equal(got, want), float((got - want).abs().max())


def test_empty_batch_launches_nothing(card):
    em = rd.DuplexParams.calibrated().energy_model(card)
    before = cuda_duplex.launches
    out = cuda_duplex.duplex_energies(
        torch.zeros((0, 10), dtype=torch.long, device=card),
        torch.zeros((1, 10), dtype=torch.long, device=card), em, 16,
    )
    assert out.shape == (0, 1) and cuda_duplex.launches == before


def test_wrapper_rejects_bad_inputs(card):
    em = rd.DuplexParams.calibrated().energy_model(card)
    tokens = torch.zeros((2, 10), dtype=torch.long, device=card)
    with pytest.raises(TypeError):
        cuda_duplex.duplex_energies(tokens.float(), tokens[:1], em, 16)
    with pytest.raises(ValueError, match="unsupported shapes"):
        cuda_duplex.duplex_energies(tokens, torch.zeros((1, 1025), device=card).long(), em, 16)
    with pytest.raises(ValueError, match="expected"):
        cuda_duplex.duplex_energies(tokens, tokens[:1], em, 12)
    with pytest.raises(ValueError, match="is on cpu"):
        cuda_duplex.duplex_energies(tokens, tokens[:1].cpu(), em, 16)


def test_landscape_on_card_equals_cpu(card):
    params = rna.registry()["L50_RNA2+3"]["params"]
    tokens = np.random.default_rng(3).integers(0, 4, (40, 50))
    on_card = rna.RNABinding(**params, device=card)
    on_cpu = rna.RNABinding(**params, device="cpu")
    np.testing.assert_array_equal(on_card.norm_values, on_cpu.norm_values)
    before = cuda_duplex.launches
    got = on_card.fitness_from_tokens(tokens)
    assert cuda_duplex.launches == before + 1
    assert torch.equal(got.cpu(), on_cpu.fitness_from_tokens(tokens))


def test_duplex_energy_batch_launches_the_kernel(card):
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, 4, (32, 50))
    target = rng.integers(0, 4, 60)
    before = cuda_duplex.launches
    got = rd.duplex_energy_batch(tokens, target, device=card)
    assert cuda_duplex.launches == before + 1
    want = rd.duplex_energy_batch(tokens, target, device="cpu")
    assert got.shape == (32,) and got.device == card
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("b,l1,l2", [(64, 100, 100), (7, 37, 37)])
def test_rowcost_baseline_equals_plain(card, b, l1, l2):
    rng = np.random.default_rng(b + l1)
    em = rd.DuplexParams.calibrated().energy_model(card)
    tokens = _tokens(rng, (b, l1), card)
    target_rev = _tokens(rng, (l2,), card)
    before = cuda_duplex.rowcost_launches["baseline"]
    got = profile_duplex_rowcost.run_variant(tokens, target_rev, em, 16, "baseline")
    assert cuda_duplex.rowcost_launches["baseline"] == before + 1
    want = cuda_duplex.duplex_energies_plain(tokens, target_rev[None], em, 16)[:, 0]
    assert torch.equal(got, want), float((got - want).abs().max())


@pytest.mark.parametrize("b", [100, 4096])
@pytest.mark.parametrize("variant", cuda_duplex.EXACT_VARIANTS)
def test_rowcost_exact_build_equals_plain(card, variant, b):
    tokens, target_rev, em, maxloop = profile_duplex_rowcost.seeded_inputs(card)
    tokens = tokens[:b]
    before = cuda_duplex.rowcost_launches[variant]
    got = profile_duplex_rowcost.run_variant(tokens, target_rev, em, maxloop, variant)
    assert cuda_duplex.rowcost_launches[variant] == before + 1
    want = cuda_duplex.duplex_energies_plain(tokens, target_rev[None], em, maxloop)[:, 0]
    assert torch.equal(got, want), float((got - want).abs().max())


@pytest.mark.parametrize(
    "variant", [v for v in cuda_duplex.ROWCOST_BUILDS if v not in cuda_duplex.EXACT_VARIANTS])
def test_rowcost_knockout_returns_finite_energies(card, variant):
    tokens, target_rev, em, maxloop = profile_duplex_rowcost.seeded_inputs(card)
    tokens = tokens[:128]
    before = cuda_duplex.launch_counts()
    got = profile_duplex_rowcost.run_variant(tokens, target_rev, em, maxloop, variant)
    torch.cuda.synchronize()
    after = cuda_duplex.launch_counts()
    assert after[variant] == before[variant] + 1
    assert all(after[v] == before[v] for v in after if v != variant)
    assert got.shape == (128,) and got.dtype == torch.float32
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("b", [1, 100])
def test_clocked_stamps_are_monotone_per_warp_and_row(card, b):
    tokens, target_rev, em, maxloop = profile_duplex_rowcost.seeded_inputs(card)
    tokens = tokens[:b]
    plan = cuda_duplex.make_plan(target_rev[None], em, maxloop)
    stamps, timer = cuda_duplex.clock_buffers(tokens.shape[1], plan.l2, card)
    got = cuda_duplex.launch_variant(plan, tokens, "clocked", (stamps, timer))[:, 0]
    want = cuda_duplex.duplex_energies_plain(tokens, target_rev[None], em, maxloop)[:, 0]
    assert torch.equal(got, want), float((got - want).abs().max())
    s = stamps.cpu().numpy()
    if b == 1:
        assert not s[1].any()  # one block: it is the first, and no last one stamps
    written = s[:1] if b == 1 else s
    assert (written > 0).all()
    rows =written.reshape(written.shape[0], written.shape[1], -1)  # stamps in row order
    assert (np.diff(rows, axis=-1) > 0).all()
    parts = profile_duplex_rowcost.clock_parts(s, timer.cpu().numpy())
    assert 500 < parts["sm_clock_mhz"] < 2500 and parts["row_cycles"] > 0


def _calibrated(card):
    params = rd.DuplexParams.calibrated()
    return params.energy_model(card), params.maxloop


@pytest.mark.parametrize("b", [100, 512, 4096])
def test_kernel_equals_plain_at_main_path_width(card, b):
    rng = np.random.default_rng(b)
    em, maxloop = _calibrated(card)
    tokens = _tokens(rng, (b, 100), card)
    targets_rev = _tokens(rng, (1, 100), card)
    got = cuda_duplex.duplex_energies(tokens, targets_rev, em, maxloop)
    want = cuda_duplex.duplex_energies_plain(tokens, targets_rev, em, maxloop)
    assert torch.equal(got, want), float((got - want).abs().max())


@pytest.mark.parametrize("b,l1,n_t,l2", [
    (100, 100, 1, 100),  # the main path's shape
    (9, 37, 2, 37),  # L2 not a multiple of the warp, two targets
    (5, 1, 1, 128),  # one row
    (6, 20, 1, 1),  # one column
    (100, 100, 1, 32),  # a short target: one warp per block
    (4, 30, 1, 512),  # the widest target of the compile-time window
    (4, 30, 1, 513),  # the narrowest of the runtime window at maxloop 16
])
def test_plan_kernel_equals_plain(card, b, l1, n_t, l2):
    rng = np.random.default_rng(b * 1000 + l2)
    em, maxloop = _calibrated(card)
    tokens = _tokens(rng, (b, l1), card)
    targets_rev = _tokens(rng, (n_t, l2), card)
    plan = cuda_duplex.make_plan(targets_rev, em, maxloop)
    got = cuda_duplex.launch_plan(plan, tokens)
    want = cuda_duplex.duplex_energies_plain(tokens, targets_rev, em, maxloop)
    torch.cuda.synchronize()
    assert torch.equal(got, want), float((got - want).abs().max())


def test_plan_call_launches_once(card):
    rng = np.random.default_rng(7)
    em, maxloop = _calibrated(card)
    targets_rev = _tokens(rng, (2, 100), card)
    plan = cuda_duplex.make_plan(targets_rev, em, maxloop)
    tokens = _tokens(rng, (100, 100), card).to(torch.int32)
    before = cuda_duplex.launch_counts()
    got = cuda_duplex.duplex_energies(tokens, targets_rev, em, maxloop, plan=plan)
    after = cuda_duplex.launch_counts()
    assert after[cuda_duplex.MAIN] == before[cuda_duplex.MAIN] + 1
    assert all(after[v] == before[v] for v in cuda_duplex.ROWCOST_BUILDS)
    want = cuda_duplex.duplex_energies_plain(tokens, targets_rev, em, maxloop)
    assert torch.equal(got, want), float((got - want).abs().max())
    with pytest.raises(ValueError, match="plan was made for other"):
        cuda_duplex.duplex_energies(tokens, targets_rev.clone(), em, maxloop, plan=plan)


def test_token_outside_the_alphabet_scores_nan(card):
    em, maxloop = _calibrated(card)
    tokens = torch.full((3, 30), 2, dtype=torch.long, device=card)
    tokens[1, 7] = 4
    targets_rev = torch.full((1, 30), 1, dtype=torch.long, device=card)
    got = cuda_duplex.duplex_energies(tokens, targets_rev, em, maxloop).cpu()
    assert torch.isnan(got[1, 0]) and torch.isfinite(got[[0, 2], 0]).all()


def test_tf_binding_oracle_on_card_equals_cpu(card):
    from flexs_tpu_torch.landscapes import tf_binding

    tokens = np.random.default_rng(8).integers(0, 4, (1024, 8))
    for name in tf_binding.registry():
        got = tf_binding.TFBinding(name=name, device=card).fitness_from_tokens(tokens)
        want = tf_binding.TFBinding(name=name, device="cpu").fitness_from_tokens(tokens)
        assert got.device == card and torch.equal(got.cpu(), want), name


def test_sweep_cells_on_card_equal_standalone_runs(card):
    """A 4-cell lockstep sweep on the card: each cell equals its standalone run."""
    import flexs_tpu_torch as flexs
    from flexs_tpu_torch.landscapes import tf_binding
    from flexs_tpu_torch.parallel import run_robustness_sweep

    kw = dict(rounds=3, sequences_batch_size=20, model_queries_per_batch=100)
    df = run_robustness_sweep(
        ["SIX6_REF_R1", "ARX_L343Q_R1"], tf_binding.STARTS[:1], [0.5, 1.0], seeds=[4],
        device=card, **kw,
    )
    assert len(df) == 4
    for row in df.itertuples():
        landscape = tf_binding.TFBinding(name=row.landscape, device=card)
        single, _ = flexs.runtime.DeviceAdaleadNAM(
            landscape, flexs.DNAA, starting_sequence=row.start,
            signal_strength=row.signal_strength, seed=row.seed, device=card, **kw,
        ).run(verbose=False)
        assert row.max_fitness == single["true_score"].max()
        assert row.model_cost == single["model_cost"].iloc[-1]
        assert row.landscape_cost == landscape.cost


def test_rosetta_and_aav_oracles_on_card_within_1e5_of_cpu(card):
    from flexs_tpu_torch.landscapes import additive_aav_packaging as aav
    from flexs_tpu_torch.landscapes import rosetta

    params = rosetta.registry()["3msi"]["params"]
    tokens = np.random.default_rng(9).integers(0, 20, (4096, 66))
    got = rosetta.RosettaFolding(**params, device=card).fitness_from_tokens(tokens)
    want = rosetta.RosettaFolding(**params, device="cpu").fitness_from_tokens(tokens)
    assert got.device == card and float((got.cpu() - want).abs().max()) <= 1e-5
    tokens = np.random.default_rng(10).integers(0, 20, (1024, 90))
    for phenotype, problem in aav.registry().items():
        got = aav.AdditiveAAVPackaging(**problem["params"], device=card).fitness_from_tokens(tokens)
        want = aav.AdditiveAAVPackaging(**problem["params"], device="cpu").fitness_from_tokens(tokens)
        assert float((got.cpu() - want).abs().max()) <= 1e-5, phenotype


def test_surrogate_run_is_deterministic_on_the_card(card):
    import pandas as pd

    import flexs_tpu_torch as flexs
    from flexs_tpu_torch.landscapes import rosetta
    from flexs_tpu_torch.runtime import SurrogateSpec

    problem = rosetta.registry()["3msi"]
    land = rosetta.RosettaFolding(**problem["params"], device=card)
    spec = SurrogateSpec(num_filters=8, hidden_size=16, epochs=3, batch_size=64)

    def run():
        cost = land.cost
        df, _ = flexs.runtime.DeviceAdaleadNAM(
            land, flexs.AAS, rounds=3, sequences_batch_size=20, model_queries_per_batch=100,
            starting_sequence=problem["starts"]["ed_3_wt"], model="surrogate",
            surrogate_spec=spec, seed=1, device=card,
        ).run(verbose=False)
        assert df["measurement_cost"].max() == len(df) == land.cost - cost
        return df

    first = run()
    pd.testing.assert_frame_equal(first, run())
    assert (first[first["round"] > 0]["model_cost"] > 0).all()


def test_rna_generic_sweep_launches_the_kernel_and_equals_standalone(card):
    import flexs_tpu_torch as flexs
    from flexs_tpu_torch.parallel import run_landscape_robustness_sweep

    reg = rna.registry()
    lands = [rna.RNABinding(**reg[f"L14_RNA{i}"]["params"], device=card) for i in (1, 2)]
    kw = dict(rounds=2, sequences_batch_size=5, model_queries_per_batch=20, device=card)
    before = cuda_duplex.launches
    df = run_landscape_robustness_sweep(lands, flexs.RNAA, [reg["L14_RNA1"]["starts"][1]], [0.9],
                                        seeds=[3], cell_mode="vmap", **kw)
    assert cuda_duplex.launches > before
    for i, row in enumerate(df.itertuples()):
        land = rna.RNABinding(**reg[f"L14_RNA{i + 1}"]["params"], device=card)
        single, _ = flexs.runtime.DeviceAdaleadNAM(
            land, flexs.RNAA, starting_sequence=row.start, signal_strength=0.9, seed=3, **kw,
        ).run(verbose=False)
        assert row.max_fitness == single["true_score"].max()
        assert row.model_cost == single["model_cost"].iloc[-1]
        assert row.landscape_cost == land.cost


@pytest.mark.parametrize("length", [14, 50, 100])
def test_fold_on_card_equals_cpu(card, length):
    from flexs_tpu_torch.ops import rna_fold

    tokens = np.random.default_rng(length).integers(0, 4, (32, length))
    on_card = rna_fold.zuker_mfe_batch(
        torch.as_tensor(tokens, device=card), rna_fold.fold_energy_model(device=card))
    on_cpu = rna_fold.zuker_mfe_batch(torch.as_tensor(tokens),
                                      rna_fold.fold_energy_model(device="cpu"))
    assert on_card.device == card
    assert torch.equal(on_card.cpu(), on_cpu), float((on_card.cpu() - on_cpu).abs().max())


def test_gfp_oracle_on_card_within_1e4_of_cpu(card):
    import warnings

    from flexs_tpu_torch.landscapes import bert_gfp

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        lands = [bert_gfp.BertGFPBrightness(hidden=128, layers=2, seed=1, device=d)
                 for d in (card, "cpu")]
    seqs = [bert_gfp.BertGFPBrightness.gfp_wt_sequence, *bert_gfp.BertGFPBrightness.starts.values()]
    on_card, on_cpu = (land.get_fitness(seqs) for land in lands)
    assert np.isfinite(on_card).all()
    np.testing.assert_allclose(on_card, on_cpu, rtol=1e-4, atol=1e-4)


def _regression_data(length=20, rows=121, queries=200):
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, 4, (rows, length))
    labels = (tokens == 1).sum(1) / length + 0.05 * rng.normal(size=rows)
    mutants = tokens[rng.integers(0, rows, queries // 2)].copy()
    mutants[np.arange(len(mutants)), rng.integers(0, length, len(mutants))] = rng.integers(
        0, 4, len(mutants))
    q = np.concatenate([rng.integers(0, 4, (queries - len(mutants), length)), mutants])
    import flexs_tpu_torch as flexs

    return flexs.Alphabet(flexs.RNAA).decode(tokens), labels, q


@pytest.mark.parametrize("name,tolerance", [
    ("TorchRidgeRegression", 1e-4), ("TorchLasso", 1e-4), ("TorchBayesianRidge", 1e-4),
    ("TorchGaussianProcessRegressor", 2e-3), ("TorchKNNRegressor", 0.0),
    ("TorchRandomForest", None), ("TorchGradientBoosting", None), ("TorchExtraTree", None),
])
def test_regressor_on_card_against_cpu(card, name, tolerance):
    """chip_smoke.py phase 10a's tolerances: exact k-NN, 1e-4 linear, 2e-3 fitted GP,
    trees by agreement when fitted and bitwise when carried across."""
    import flexs_tpu_torch as flexs
    from flexs_tpu_torch.baselines import models

    seqs, labels, queries = _regression_data()
    on_card, on_cpu = (getattr(models, name)(flexs.RNAA, device=d) for d in (card, "cpu"))
    for m in (on_card, on_cpu):
        m.train(seqs, labels)
    got, want = on_card.fitness_from_tokens(queries), on_cpu.fitness_from_tokens(queries)
    assert np.isfinite(got).all()
    if tolerance is not None:
        assert np.abs(got - want).max() <= tolerance
        return
    assert np.corrcoef(got, want)[0, 1] >= (0.9 if name == "TorchExtraTree" else 0.99)
    on_card._state = tuple(t.to(card) for t in on_cpu._state)
    assert np.array_equal(on_card.fitness_from_tokens(queries), want)


def test_gp_surrogate_cells_on_card_equal_standalone_runs(card):
    """Two GP cells in lockstep equal their two single runs, every field (the
    batched-factorization trap: cells factorize one by one)."""
    import flexs_tpu_torch as flexs
    from flexs_tpu_torch.runtime import SurrogateSpec, jit_runner

    reg = rna.registry()
    land = rna.RNABinding(**reg["L14_RNA1"]["params"], device=card)
    cfg = jit_runner.AdaleadConfig(rounds=3, sequences_batch_size=10, model_queries_per_batch=60,
                                   alphabet_size=4, surrogate=SurrogateSpec(arch="gp"))
    fn, params = land.device_fitness()
    tokens = torch.as_tensor(flexs.Alphabet(flexs.RNAA).encode(
        [reg["L14_RNA1"]["starts"][k] for k in (1, 2)]), device=card)

    def gen(seed):
        return torch.Generator(device=card).manual_seed(seed)

    cells = jit_runner.run_adalead_nam_cells(
        jit_runner.cell_axis_oracle(fn), params, tokens, cfg, [1.0] * 2, [gen(0), gen(1)])
    for c in range(2):
        single = jit_runner.run_adalead_nam(fn, params, tokens[c], cfg, 1.0, gen(c))
        for field, got, want in zip(single._fields, cells, single):
            assert torch.equal(got[c], want), (c, field)


# -- The host explorers' components (chip_smoke.py phase 11a, at small widths).


def test_cmaes_tell_on_card_against_cpu(card):
    from flexs_tpu_torch.ops import cmaes

    rng = np.random.default_rng(0)
    n, popsize = 96, 12
    state = cmaes.init(rng.normal(size=n).astype(np.float32), 0.4, device="cpu")
    for count in (0, cmaes.lazy_gap(n, popsize) - 1):  # the second tell refreshes eigh
        state = state._replace(count=count)
        sols = rng.normal(size=(popsize, n)).astype(np.float32)
        fits = rng.random(popsize).astype(np.float32)
        on_card = cmaes.tell_numpy(
            type(state)(*(t.to(card) if torch.is_tensor(t) else t for t in state)), sols, fits)
        state = cmaes.tell_numpy(state, sols, fits)
        for got, want in ((on_card.mean, state.mean), (on_card.sigma, state.sigma),
                          (on_card.cov, state.cov),
                          (cmaes.covariance(on_card), cmaes.covariance(state))):
            assert torch.allclose(got.cpu(), want, rtol=1e-4, atol=1e-4)


def test_vae_on_card_against_cpu(card):
    import flexs_tpu_torch as flexs
    from flexs_tpu_torch.utils.vae import VAE

    rng = np.random.default_rng(1)
    seqs = flexs.Alphabet(flexs.AAS).decode(rng.integers(0, 20, (60, 12)))
    on_cpu = VAE(12, flexs.AAS, intermediate_dim=64, epochs=1, verbose=False, device="cpu")
    on_cpu.train_model(seqs, np.ones(len(seqs)))
    on_card = VAE(12, flexs.AAS, intermediate_dim=64, verbose=False, device=card)
    on_card.set_weights({k: v.to(card) for k, v in on_cpu.get_weights().items()})
    z = rng.standard_normal((8, 2)).astype(np.float32)
    assert np.abs(on_card.decode_numpy(z) - on_cpu.decode_numpy(z)).max() <= 1e-5
    got, want = (v.calculate_log_probability(seqs) for v in (on_card, on_cpu))
    assert np.abs(got - want).max() <= 1e-5
    assert on_card.generate(10, seqs) == on_cpu.generate(10, seqs)
    # Training on the card: the CUDA-graph steps equal eager steps bitwise.
    graphed, eager = (VAE(12, flexs.AAS, intermediate_dim=64, epochs=2, verbose=False,
                          device=card) for _ in range(2))
    eager.cuda_graph = False
    for vae in (graphed, eager):
        vae.train_model(seqs, np.linspace(0.5, 1.0, len(seqs)))
    for a, b in zip(graphed.get_weights().values(), eager.get_weights().values()):
        assert torch.equal(a, b)


def test_q_network_on_card_against_cpu(card):
    import flexs_tpu_torch as flexs

    dqns = [flexs.baselines.explorers.DQN(
        None, rounds=1, sequences_batch_size=8, model_queries_per_batch=8,
        starting_sequence="MAQASVVANQ", alphabet=flexs.AAS, train_epochs=3, seed=0, device=d)
        for d in ("cpu", card)]
    for dqn in dqns:
        dqn.initialize_data_structures()
    dqns[1].q_network.load_state_dict(dqns[0].q_network.state_dict())
    rng = np.random.default_rng(2)
    eye = np.eye(20, dtype=np.float32)
    states = eye[rng.integers(0, 20, (3, 10))].reshape(3, -1)
    want, got = (d.all_action_q(states) for d in dqns)
    assert np.abs(got - want).max() <= 1e-5
    obs = eye[rng.integers(0, 20, (3, 8, 10))].reshape(3, 8, -1)
    nxt = eye[rng.integers(0, 20, (3, 8, 10))].reshape(3, 8, -1)
    batch = (obs, nxt * (1 - obs), rng.random((3, 8)).astype(np.float32), nxt)
    for d in dqns:
        d._train(*(torch.as_tensor(a, device=d.device) for a in batch))
    vec = [torch.nn.utils.parameters_to_vector(d.q_network.parameters()).cpu() for d in dqns]
    assert torch.allclose(vec[1], vec[0], rtol=1e-4, atol=1e-4)


def test_actor_critic_on_card_against_cpu(card):
    from flexs_tpu_torch.rl import PPOAgent

    agents = [PPOAgent(42, 6, seed=0, device=d) for d in ("cpu", card)]
    agents[1].net.load_state_dict(agents[0].net.state_dict())
    rng = np.random.default_rng(3)
    t = 40
    batch = {"obs": rng.random((t, 42)).astype(np.float32), "actions": rng.integers(0, 6, t),
             "logprobs": np.full(t, -np.log(6)), "rewards": rng.random(t),
             "dones": np.arange(t) % 8 == 7, "values": rng.random(t),
             "masks": rng.random((t, 6)) < 0.8}
    batch["masks"][np.arange(t), batch["actions"]] = True
    with torch.no_grad():
        (lc, vc), (lg, vg) = (a.net(torch.as_tensor(batch["obs"], device=a.device))
                              for a in agents)
    assert torch.allclose(lg.cpu(), lc, atol=1e-5) and torch.allclose(vg.cpu(), vc, atol=1e-5)
    losses = [a.train(batch) for a in agents]
    assert abs(losses[0] - losses[1]) <= 1e-4
    vec = [torch.nn.utils.parameters_to_vector(a.net.parameters()).cpu() for a in agents]
    assert torch.allclose(vec[1], vec[0], rtol=1e-4, atol=1e-4)


def test_dynappo_density_on_card_equals_cpu(card):
    import flexs_tpu_torch as flexs
    from flexs_tpu_torch.baselines.explorers.environments.dyna_ppo import DynaPPOEnvironment

    rng = np.random.default_rng(4)
    alphabet = flexs.Alphabet(flexs.AAS)
    base = rng.integers(0, 20, 20)
    cache = np.repeat(base[None], 300, axis=0)
    for row in cache:
        pos = rng.choice(20, rng.integers(1, 4), replace=False)
        row[pos] = rng.integers(0, 20, len(pos))
    shifted = np.roll(cache[:20], 1, axis=1)
    seqs = alphabet.decode(np.concatenate([cache, shifted]))
    fitness = rng.random(len(seqs))
    queries = seqs[:8] + alphabet.decode(base[None])
    densities = []
    for d in ("cpu", card):
        env = DynaPPOEnvironment(flexs.AAS, 20, None, None, 8, device=d)
        env._density.update(seqs, fitness)
        densities.append(env._density.densities(queries))
    assert np.array_equal(densities[0], densities[1]) and (densities[0] > 0).all()
