"""The port's fused CbAS/DbAS runner on the CPU, against the JAX package's.

The runner draws from torch Generators, which cannot replay `jax.random`,
so it is held to the invariants of the JAX package's cases
(tests/test_cbas_runner.py), to its cell-axis entry point (C = 3)
equalling three single runs bitwise (one VAE per cell), and to the JAX
runner's mean top over the same four seeds within a stated band.  Its
deterministic pieces are held to the JAX runner's: `_masked_percentile`
exactly, and the weighted VAE loss and the log probability to the
formulas of flexs_tpu/runtime/cbas_runner.py:139-159 and :230-240 within
1e-5, on Flax variables carried across by `convert.vae_variables_from_flax`.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexs_tpu
import flexs_tpu.runtime as jax_runtime
import flexs_tpu_torch as flexs
from flexs_tpu.runtime import cbas_runner as jax_cbas
from flexs_tpu.utils import vae as jax_vae
from flexs_tpu_torch.baselines.models.convert import vae_variables_from_flax
from flexs_tpu_torch.landscapes import tf_binding
from flexs_tpu_torch.runtime import DeviceCbASNAM, VAEConfig, cbas_runner
from flexs_tpu_torch.runtime.jit_runner import AdaleadConfig, cell_axis_oracle
from flexs_tpu_torch.utils.vae import VAETrainer

START = tf_binding.STARTS[0]
SEEDS = (0, 1, 2, 3)
BAND = 0.15  # |port - JAX| of the mean top over SEEDS
TOL = 1e-5
SMALL_VAE = dict(intermediate_dim=32, epochs=3)
RUN = dict(rounds=2, sequences_batch_size=8, model_queries_per_batch=40, cycle_batch_size=20)


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


@pytest.fixture(scope="module")
def jax_landscape():
    problem = flexs_tpu.landscapes.tf_binding.registry()["SIX6_REF_R1"]
    return flexs_tpu.landscapes.TFBinding(**problem["params"])


def _run(landscape, **kw):
    kw = {**RUN, "signal_strength": 0.9, "seed": 0, "vae_cfg": VAEConfig(**SMALL_VAE), **kw}
    return DeviceCbASNAM(landscape, flexs.DNAA, starting_sequence=START, device="cpu",
                         **kw).run(verbose=False)


def _gen(seed):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return gen


def test_schema_and_costs(landscape):
    df, meta = _run(landscape)
    assert df["round"].max() == 2
    # Round 1 = batch-size queries; round 2 = 2 cycles of 20.
    assert df["model_cost"].max() == 8 + 40
    assert meta["exp_name"] == "Devicecbas_Q=0.7"
    # A round's proposals are novel among themselves (round 1 may hold the
    # start, a mutant with no change, as in the host explorer and JAX).
    for r in (1, 2):
        rows = df[df["round"] == r]
        assert len(rows) == 8 and rows["sequence"].is_unique


def test_true_scores_match_both_landscapes(landscape, jax_landscape):
    df, _ = _run(landscape)
    seqs = df["sequence"].tolist()
    np.testing.assert_array_equal(df["true_score"].to_numpy(), landscape.get_fitness(seqs))
    np.testing.assert_allclose(df["true_score"].to_numpy(), jax_landscape.get_fitness(seqs),
                               atol=1e-6)


def test_dbas_mode_runs(landscape):
    df, meta = _run(landscape, algo="dbas")
    assert df["round"].max() == 2 and meta["exp_name"] == "Devicedbas_Q=0.7"
    assert df[df["round"] == 2]["sequence"].is_unique
    with pytest.raises(ValueError, match="algo"):
        _run(landscape, algo="xbas")


def test_climbs_with_budget(landscape):
    df, _ = _run(landscape, rounds=3, sequences_batch_size=16, model_queries_per_batch=60,
                 signal_strength=1.0)
    assert df["true_score"].max() > df[df["round"] == 0]["true_score"].max()
    assert df["true_score"].max() > 0.6


def test_seed_determinism(landscape):
    a, _ = _run(landscape, seed=3)
    b, _ = _run(landscape, seed=3)
    assert a["sequence"].tolist() == b["sequence"].tolist()
    np.testing.assert_array_equal(a["model_score"].to_numpy()[1:], b["model_score"].to_numpy()[1:])


@pytest.mark.parametrize("algo", ["cbas", "dbas"])
def test_cells_equal_single_runs(landscape, algo):
    """Three cells in lockstep (other starts, signal strengths, seeds) equal three single runs."""
    fn, params = landscape.device_fitness()
    cfg = AdaleadConfig(rounds=2, sequences_batch_size=8, model_queries_per_batch=40,
                        alphabet_size=4)
    kw = dict(vae_cfg=VAEConfig(**SMALL_VAE), algo=algo, cycle_batch_size=20)
    starts = torch.as_tensor(flexs.Alphabet(flexs.DNAA).encode(tf_binding.STARTS[:3]))
    ss, seeds = [0.5, 0.9, 1.0], [3, 4, 5]
    cells = cbas_runner.run_cbas_nam_cells(cell_axis_oracle(fn), params, starts, cfg, ss,
                                           [_gen(s) for s in seeds], **kw)
    for c in range(3):
        single = cbas_runner.run_cbas_nam(fn, params, starts[c], cfg, ss[c], _gen(seeds[c]),
                                          **kw)
        for name, got, want in zip(single._fields, cells, single):
            assert torch.equal(got[c], want), (c, name)


def test_masked_percentile_equals_jax():
    rng = np.random.default_rng(0)
    for n, q in ((1, 0.7), (7, 0.7), (20, 0.5), (33, 0.95), (8, 0.0)):
        vals = rng.normal(size=40).astype(np.float32)
        mask = np.zeros(40, bool)
        mask[rng.choice(40, n, replace=False)] = True
        got = cbas_runner._masked_percentile(torch.tensor(vals), torch.tensor(mask), q)
        want = jax_cbas._masked_percentile(jnp.asarray(vals), jnp.asarray(mask), q)
        assert float(got) == float(want), (n, q)
        np.testing.assert_allclose(float(got), np.percentile(vals[mask], 100 * q), rtol=1e-6)
    # A cell axis: each row its own percentile.
    vals = rng.normal(size=(3, 10)).astype(np.float32)
    mask = rng.random((3, 10)) < 0.6
    got = cbas_runner._masked_percentile(torch.tensor(vals), torch.tensor(mask), 0.7)
    for c in range(3):
        want = jax_cbas._masked_percentile(jnp.asarray(vals[c]), jnp.asarray(mask[c]), 0.7)
        assert float(got[c]) == float(want)


@pytest.fixture(scope="module")
def carried():
    """(Flax module, variables with seeded BatchNorm statistics, trainer holding them)."""
    ref = jax_vae.VAE(seq_length=8, alphabet=flexs.DNAA, batch_size=10, latent_dim=2,
                      intermediate_dim=32, verbose=False, seed=0)
    variables = jax.device_get(ref.variables)
    rng = np.random.default_rng(1)
    stats = variables["batch_stats"]["enc_bn"]
    variables["batch_stats"]["enc_bn"] = {
        "mean": rng.normal(size=stats["mean"].shape).astype(np.float32),
        "var": (rng.random(stats["var"].shape) + 0.5).astype(np.float32),
    }
    trainer = VAETrainer(32, 32, 2, 10, 1.0, _gen(0))
    trainer.set_weights(vae_variables_from_flax(variables))
    return ref.module, variables, trainer


def _batch(seed=2):
    rng = np.random.default_rng(seed)
    x = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (10, 8))].reshape(10, 32)
    w = rng.random(10).astype(np.float32) * (rng.random(10) < 0.7)
    enc = rng.random((10, 32)) < 0.7
    dec = rng.random((10, 32)) < 0.7
    eps = rng.normal(size=(10, 2)).astype(np.float32)
    return x, w, enc, dec, eps


def test_weighted_vae_loss_matches_the_jax_formula(carried):
    module, variables, trainer = carried
    x, w, enc, dec, eps = _batch()
    before = trainer.get_weights()
    got = trainer.loss(*(torch.tensor(a) for a in (x, w, enc, dec, eps))).detach()
    trainer.set_weights(before)  # the train-mode step moved the BatchNorm statistics
    # cbas_runner.py:139-159, the Flax layers applied with the same dropout masks.
    m = module.bind(variables, mutable=["batch_stats"])
    h = fnn.elu(m.enc1(x))
    h = fnn.elu(m.enc2(jnp.where(enc, h / 0.7, 0.0)))
    h = fnn.elu(m.enc3(m.enc_bn(h, use_running_average=False)))
    z_mean, z_log_var = m.z_mean_layer(h), m.z_log_var_layer(h)
    z = z_mean + jnp.exp(0.5 * z_log_var) * eps
    d = fnn.elu(m.dec2(fnn.elu(m.dec1(z))))
    recon = fnn.sigmoid(m.dec_out(fnn.elu(m.dec3(jnp.where(dec, d / 0.7, 0.0)))))
    bce = -(x * jnp.log(recon + 1e-7) + (1 - x) * jnp.log(1 - recon + 1e-7)).mean(axis=1)
    denom = jnp.sum(w) + 1e-9
    kl = -0.5 * (1 + z_log_var - jnp.square(z_mean) - jnp.exp(z_log_var))
    want = 32 * jnp.sum(bce * w) / denom + 1.0 * jnp.sum(kl.mean(axis=1) * w) / denom
    np.testing.assert_allclose(float(got), float(want), rtol=TOL, atol=TOL)


def test_log_probability_matches_the_jax_formula(carried):
    module, variables, trainer = carried
    x = _batch(seed=3)[0]
    got = cbas_runner.log_probability(trainer, torch.tensor(x), 8, 4)
    # cbas_runner.py:230-240.
    z_mean, _ = module.apply(variables, x, train=False, method=jax_vae.VAEModule.encode)
    decoded = module.apply(variables, z_mean, train=False,
                           method=jax_vae.VAEModule.decode).reshape(-1, 8, 4)
    per_res = jnp.sum(decoded * x.reshape(-1, 8, 4), axis=2) / jnp.sum(decoded, axis=2)
    want = jnp.nan_to_num(jnp.sum(jnp.log(1e-9 + per_res), axis=1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    # A snapshot stands in for the current weights (the CbAS vae_0).
    fresh = VAETrainer(32, 32, 2, 10, 1.0, _gen(9))
    np.testing.assert_array_equal(
        cbas_runner.log_probability(fresh, torch.tensor(x), 8, 4, trainer.get_weights()).numpy(),
        got.numpy())


@pytest.fixture(scope="module")
def mean_tops(landscape, jax_landscape):
    """(port, JAX) mean top over SEEDS at the JAX cases' size, NAM at 0.9."""
    port = [_run(landscape, seed=s)[0]["true_score"].max() for s in SEEDS]
    ref = [jax_runtime.DeviceCbASNAM(
        jax_landscape, flexs.DNAA, starting_sequence=START, signal_strength=0.9, seed=s,
        vae_cfg=jax_runtime.VAEConfig(**SMALL_VAE), **RUN).run(verbose=False)[0]["true_score"].max()
        for s in SEEDS]
    return np.mean(port), np.mean(ref)


def test_quality_matches_jax(mean_tops):
    port, ref = mean_tops
    assert abs(port - ref) <= BAND, (port, ref)


def test_default_device_without_card_raises(landscape):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceCbASNAM(landscape, flexs.DNAA, starting_sequence=START, rounds=1,
                      sequences_batch_size=8, model_queries_per_batch=40)
