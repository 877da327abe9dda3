"""The port's VAE against the JAX package's, with the Flax variables carried across,
and the CbAS/DbAS explorer.

The JAX VAE is trained for two epochs first, so that its BatchNorm
statistics are not the initial ones; `convert.vae_variables_from_flax`
carries them and the weights.  Inference (encode, decode, the log
probability) must agree within 1e-5, `generate` (numpy draws over the
decoded PWM) exactly; the train-mode BatchNorm update is held to Flax's
(momentum 0.99, biased variance) within 1e-6.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexs_tpu
import flexs_tpu_torch
from flexs_tpu.utils import vae as jax_vae
from flexs_tpu_torch.baselines.models.convert import vae_variables_from_flax
from flexs_tpu_torch.baselines.models.torch_model import BatchNorm
from flexs_tpu_torch.utils import vae

TOL = 1e-5
START = "TTGCAGCA"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel worker processes."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def _samples(n=60, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 4, (n, 8))
    return list(dict.fromkeys(flexs_tpu.Alphabet(flexs_tpu.DNAA).decode(tokens)))


KW = dict(seq_length=8, alphabet=flexs_tpu.DNAA, batch_size=10, latent_dim=2,
          intermediate_dim=32, epochs=2, verbose=False, seed=0)


@pytest.fixture(scope="module")
def carried():
    """(JAX VAE trained 2 epochs, port VAE holding its variables)."""
    ref = jax_vae.VAE(**KW)
    samples = _samples()
    ref.train_model(samples, np.linspace(0.2, 1.0, len(samples)))
    port = vae.VAE(**KW, device="cpu")
    port.set_weights(vae_variables_from_flax(jax.device_get(ref.variables)))
    return ref, port


def test_carried_state_is_nontrivial(carried):
    ref, port = carried
    stats = ref.variables["batch_stats"]["enc_bn"]
    assert not np.allclose(np.asarray(stats["mean"]), 0)
    np.testing.assert_array_equal(port.module.enc_bn.var.numpy(), np.asarray(stats["var"]))


def test_encode_and_decode_match_flax(carried):
    ref, port = carried
    x = ref._one_hot(_samples(20, seed=1))
    z_mean, z_log_var = ref.module.apply(ref.variables, jnp.asarray(x), method="encode")
    with torch.no_grad():
        got_mean, got_log_var = port.module.encode(torch.tensor(x))
    np.testing.assert_allclose(got_mean.numpy(), np.asarray(z_mean), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_log_var.numpy(), np.asarray(z_log_var), rtol=TOL, atol=TOL)
    z = np.random.default_rng(2).standard_normal((5, 2)).astype(np.float32)
    want = np.asarray(ref._decode_one(ref.variables, jnp.asarray(z)))
    np.testing.assert_allclose(port.decode_numpy(z), want, rtol=TOL, atol=TOL)


def test_log_probability_matches_flax(carried):
    ref, port = carried
    seqs = _samples(30, seed=3)
    want = ref.calculate_log_probability(seqs)
    np.testing.assert_allclose(port.calculate_log_probability(seqs), want, rtol=TOL, atol=TOL)
    # A snapshot is used in place of the current weights (the CbAS vae_0).
    snapshot = port.get_weights()
    initial = vae.VAE(**KW, device="cpu")
    np.testing.assert_allclose(initial.calculate_log_probability(seqs, vae=snapshot), want,
                               rtol=TOL, atol=TOL)
    assert not np.allclose(initial.calculate_log_probability(seqs), want)


def test_generate_matches_flax(carried):
    ref, port = carried
    existing = _samples()
    # Both generators' numpy streams are untouched by training; draw twice.
    for _ in range(2):
        assert port.generate(20, existing) == ref.generate(20, existing)


def test_batch_norm_train_update_matches_flax():
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(10, 6)) * 3 + 1).astype(np.float32)
    mean0 = rng.normal(size=6).astype(np.float32)
    var0 = rng.random(6).astype(np.float32) + 0.5
    scale = rng.random(6).astype(np.float32) + 0.5
    bias = rng.normal(size=6).astype(np.float32)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    want, updates = fnn.BatchNorm(use_running_average=False).apply(
        variables, jnp.asarray(x), mutable=["batch_stats"])
    bn = BatchNorm(6)
    bn.load_state_dict({k: torch.tensor(v) for k, v in
                        (("scale", scale), ("bias", bias), ("mean", mean0), ("var", var0))})
    got = bn(torch.tensor(x), train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    for name in ("mean", "var"):
        np.testing.assert_allclose(getattr(bn, name).numpy(),
                                   np.asarray(updates["batch_stats"][name]), rtol=1e-6, atol=1e-6)
    # Biased variance: torch's unbiased running update would differ.
    assert not np.allclose(bn.var.numpy(), 0.99 * var0 + 0.01 * x.var(axis=0, ddof=1))


def test_pwm_to_boltzmann_weights_exact():
    pwm = np.random.default_rng(0).random((4, 8))
    for temp in (0.5, 1e-3):
        np.testing.assert_array_equal(vae.pwm_to_boltzmann_weights(pwm, temp),
                                      jax_vae.pwm_to_boltzmann_weights(pwm, temp))


def test_training_lowers_the_loss_and_keeps_real_statistics():
    model = vae.VAE(**{**KW, "epochs": 6}, device="cpu")
    samples = _samples()
    before = model.calculate_log_probability(samples).mean()
    model.train_model(samples, np.ones(len(samples)))
    assert model.calculate_log_probability(samples).mean() > before
    assert (model.module.enc_bn.var > 0).all() and not torch.equal(
        model.module.enc_bn.mean, torch.zeros(32))
    proposals = model.generate(20, samples)
    assert len(set(proposals)) == 20 and not set(proposals) & set(samples)


class _FakeModel(flexs_tpu_torch.Model):
    def __init__(self):
        super().__init__(name="FakeModel")
        self.rng = np.random.default_rng(1)

    def train(self, *args):
        pass

    def _fitness_function(self, sequences):
        return self.rng.random(size=len(sequences))


class _FakeLandscape(flexs_tpu_torch.Landscape):
    def __init__(self):
        super().__init__(name="FakeLandscape")
        self.rng = np.random.default_rng(0)

    def _fitness_function(self, sequences):
        return self.rng.random(size=len(sequences))


def _cbas(algo):
    return flexs_tpu_torch.baselines.explorers.CbAS(
        _FakeModel(), vae.VAE(**{**KW, "epochs": 3}, device="cpu"), rounds=3,
        starting_sequence=START, sequences_batch_size=5, model_queries_per_batch=20,
        alphabet=flexs_tpu.DNAA, algo=algo, cycle_batch_size=10, seed=0,
    )


@pytest.mark.parametrize("algo", ["cbas", "dbas"])
def test_cbas_dbas_run_invariants(algo):
    """The JAX package's smoke invariants (3 rounds, batch 5, 20 queries)."""
    explorer = _cbas(algo)
    df, _ = explorer.run(_FakeLandscape(), verbose=False)
    assert df["round"].max() == 3
    for r in range(1, 4):
        assert 0 < len(df[df["round"] == r]) <= 5
    costs = df.groupby("round")["model_cost"].first().to_numpy()
    assert (np.diff(costs) >= 0).all()
    assert explorer.name == f"{algo}_Q=0.7_generator=VAE_latent_dim=2_intermediate_dim=32"


def test_cbas_invalid_algo_raises():
    with pytest.raises(ValueError):
        _cbas("bogus")
