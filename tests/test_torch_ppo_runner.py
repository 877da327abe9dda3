"""The port's fused PPO runner on the CPU, against the JAX package's.

The runner draws from torch Generators, which cannot replay `jax.random`,
so it is held to the invariants of the JAX package's cases
(tests/test_ppo_runner.py), to its cell-axis entry point (C = 3) equalling
three single runs bitwise, and to the JAX runner's mean top over the same
four seeds within a stated band.  `rl.ppo`'s cell-axis pieces are held to
the JAX runner's formulas (flexs_tpu/runtime/ppo_runner.py:128-144 and
:453-507): GAE with episode cuts, the advantage normalization and the
masked Welford merge within 1e-6, and one clipped-surrogate epoch under
Adam(3e-4) on `ActorCritic` params carried across by
`convert.actor_critic_params_from_flax` within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import flexs_tpu
import flexs_tpu.runtime as jax_runtime
import flexs_tpu_torch as flexs
from flexs_tpu.rl.ppo import ActorCritic as JaxActorCritic
from flexs_tpu_torch.baselines.models.convert import actor_critic_params_from_flax
from flexs_tpu_torch.baselines.models.torch_model import adam_init, flatten_parameters
from flexs_tpu_torch.landscapes import tf_binding
from flexs_tpu_torch.rl import ppo
from flexs_tpu_torch.runtime import DevicePPONAM, SurrogateSpec, ppo_runner
from flexs_tpu_torch.runtime.jit_runner import AdaleadConfig, cell_axis_oracle

START = tf_binding.STARTS[0]
SEEDS = (0, 1, 2, 3)
BAND = 0.15  # |port - JAX| of the mean top over SEEDS
EXACT = 1e-6  # GAE, advantage normalization, Welford: the same float32 arithmetic
TOL = 1e-5  # one PPO epoch (summation orders of the matmuls differ)
RUN = dict(rounds=2, sequences_batch_size=8, model_queries_per_batch=50)
TINY = SurrogateSpec(num_filters=8, hidden_size=16, epochs=3, batch_size=64)


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
    kw = {**RUN, "signal_strength": 0.9, "seed": 0, **kw}
    return DevicePPONAM(landscape, flexs.DNAA, starting_sequence=START, device="cpu",
                        **kw).run(verbose=False)


def _gen(seed):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return gen


def test_schema_and_costs(landscape):
    df, meta = _run(landscape)
    assert df["round"].max() == 2
    assert df["sequence"].is_unique  # proposals novelty-filtered vs measured
    # The budget is spent; a round may overshoot by one query when a reset
    # and a scored step land in the same step (ppo.py:92-109).
    assert 2 * 50 <= df["model_cost"].max() <= 2 * 51
    assert meta["exp_name"] == "DevicePPO_Agent"


@pytest.mark.parametrize("model", ["nam", "perfect", "surrogate"])
def test_truth_matches_both_landscapes(landscape, jax_landscape, model):
    df, _ = _run(landscape, model=model, surrogate_spec=TINY)
    seqs = df["sequence"].tolist()
    np.testing.assert_array_equal(df["true_score"].to_numpy(), landscape.get_fitness(seqs))
    np.testing.assert_allclose(df["true_score"].to_numpy(), jax_landscape.get_fitness(seqs),
                               atol=1e-6)


def test_ppo_climbs_with_budget(landscape):
    df, _ = _run(landscape, rounds=3, sequences_batch_size=16, model_queries_per_batch=100,
                 signal_strength=1.0)
    assert df["true_score"].max() > 0.85


def test_seed_determinism(landscape):
    a, _ = _run(landscape, seed=5)
    b, _ = _run(landscape, seed=5)
    assert a["sequence"].tolist() == b["sequence"].tolist()
    c, _ = _run(landscape, seed=6)
    assert a["sequence"].tolist() != c["sequence"].tolist()


def test_cells_equal_single_runs(landscape):
    """Three cells in lockstep (other starts, signal strengths, seeds) equal three single runs.

    The cells take different numbers of steps a round (no-op steps are
    free), so the check covers a finished cell changing nothing.
    """
    fn, params = landscape.device_fitness()
    cfg = AdaleadConfig(**RUN, alphabet_size=4)
    kw = dict(train_epochs=3)
    starts = torch.as_tensor(flexs.Alphabet(flexs.DNAA).encode(tf_binding.STARTS[:3]))
    ss, seeds = [0.5, 0.9, 1.0], [3, 4, 5]
    cells = ppo_runner.run_ppo_nam_cells(cell_axis_oracle(fn), params, starts, cfg, ss,
                                         [_gen(s) for s in seeds], **kw)
    for c in range(3):
        single = ppo_runner.run_ppo_nam(fn, params, starts[c], cfg, ss[c], _gen(seeds[c]), **kw)
        for name, got, want in zip(single._fields, cells, single):
            assert torch.equal(got[c], want), (c, name)


@pytest.fixture(scope="module")
def mean_tops(landscape, jax_landscape):
    """(port, JAX) mean top over SEEDS at the JAX cases' size, NAM at 0.9."""
    port = [_run(landscape, seed=s)[0]["true_score"].max() for s in SEEDS]
    ref = [jax_runtime.DevicePPONAM(
        jax_landscape, flexs.DNAA, starting_sequence=START, signal_strength=0.9, seed=s,
        **RUN).run(verbose=False)[0]["true_score"].max() for s in SEEDS]
    return np.mean(port), np.mean(ref)


def test_quality_matches_jax(mean_tops):
    port, ref = mean_tops
    assert abs(port - ref) <= BAND, (port, ref)


def _trajectory(rng, cells=3, steps=23):
    rewards = rng.normal(size=(cells, steps)).astype(np.float32)
    values = rng.normal(size=(cells, steps)).astype(np.float32)
    dones = rng.random((cells, steps)) < 0.25
    valid = np.arange(steps)[None, :] < np.array([[23], [17], [9]])
    return rewards, values, dones, valid


def _jax_gae(rewards, values, dones, valid, gamma=0.99, gae_lambda=0.95):
    """The JAX runner's GAE and normalization of one trajectory (`ppo_runner.py:453-475`)."""
    rewards = jnp.where(valid, rewards, 0.0)
    values = jnp.where(valid, values, 0.0)
    dones = jnp.where(valid, dones, True)

    def gae_step(carry, x):
        last_adv, next_value = carry
        reward, value, done = x
        nonterminal = 1.0 - done.astype(jnp.float32)
        delta = reward + gamma * next_value * nonterminal - value
        last_adv = delta + gamma * gae_lambda * nonterminal * last_adv
        return (last_adv, value), last_adv

    _, adv = jax.lax.scan(gae_step, (jnp.float32(0.0), jnp.float32(0.0)),
                          (rewards, values, dones), reverse=True)
    n_valid = jnp.maximum(jnp.sum(valid), 1)
    mean = jnp.sum(jnp.where(valid, adv, 0.0)) / n_valid
    var = jnp.sum(jnp.where(valid, jnp.square(adv - mean), 0.0)) / n_valid
    return np.asarray(adv), np.asarray((adv - mean) / (jnp.sqrt(var) + 1e-8))


def test_gae_and_advantage_normalization_match_jax():
    rewards, values, dones, valid = _trajectory(np.random.default_rng(0))
    t = [torch.as_tensor(x) for x in (rewards, values, dones, valid)]
    rew, val = (torch.where(t[3], x, 0.0) for x in t[:2])
    adv = ppo.gae(rew, val, torch.where(t[3], t[2], True), 0.99, 0.95)
    norm = ppo.normalize_advantages(adv, t[3])
    for c in range(3):
        want_adv, want_norm = _jax_gae(rewards[c], values[c], dones[c], valid[c])
        np.testing.assert_allclose(adv[c].numpy(), want_adv, rtol=EXACT, atol=EXACT)
        np.testing.assert_allclose(norm[c].numpy(), want_norm, rtol=EXACT, atol=EXACT)
    # The cell axis changes nothing: each cell alone gives the same bits.
    for c in range(3):
        alone = ppo.gae(rew[c:c + 1], val[c:c + 1], torch.where(t[3], t[2], True)[c:c + 1],
                        0.99, 0.95)
        assert torch.equal(alone[0], adv[c])


def test_welford_merge_matches_jax():
    """The masked merge of `ppo_runner.py:133-144` and `normalize` (:128-131)."""
    rng = np.random.default_rng(1)
    cells, n, d = 2, 11, 6
    obs = rng.normal(size=(cells, n, d)).astype(np.float32)
    valid = rng.random((cells, n)) < 0.7
    stats = ppo.init_obs_stats(cells, d, "cpu")
    stats = ppo.welford_merge(stats, torch.as_tensor(obs), torch.as_tensor(valid))
    stats = ppo.welford_merge(stats, torch.as_tensor(obs[:, ::-1].copy()), torch.as_tensor(valid))
    normed = ppo.normalize_obs(stats, torch.as_tensor(obs))
    for c in range(cells):
        count, mean, m2 = jnp.float32(1e-4), jnp.zeros(d), jnp.ones(d)
        for rows in (obs[c], obs[c][::-1]):
            mask = jnp.asarray(valid[c])
            n_b = jnp.sum(mask)
            w = mask.astype(jnp.float32)[:, None]
            mean_b = jnp.sum(rows * w, axis=0) / jnp.maximum(n_b, 1)
            m2_b = jnp.sum(jnp.square(rows - mean_b) * w, axis=0)
            delta = mean_b - mean
            tot = count + n_b
            mean, m2, count = (mean + delta * n_b / tot,
                               m2 + m2_b + jnp.square(delta) * count * n_b / tot, tot)
        var = m2 / jnp.maximum(count, 1.0)
        want = (obs[c] - mean) / jnp.sqrt(var + 1e-8)
        np.testing.assert_allclose(float(stats.count[c]), float(count), rtol=EXACT)
        np.testing.assert_allclose(stats.mean[c].numpy(), np.asarray(mean), rtol=EXACT, atol=EXACT)
        np.testing.assert_allclose(stats.m2[c].numpy(), np.asarray(m2), rtol=EXACT, atol=EXACT)
        np.testing.assert_allclose(normed[c].numpy(), np.asarray(want), rtol=EXACT, atol=EXACT)


def test_one_ppo_epoch_matches_jax():
    """One clipped-surrogate epoch, invalid rows weighing 0 (`ppo_runner.py:477-507`)."""
    rng = np.random.default_rng(2)
    n, obs_dim, actions = 14, 12, 12
    net = JaxActorCritic(actions, (16,))
    params = jax.device_get(net.init(jax.random.PRNGKey(3), jnp.zeros((1, obs_dim))))
    obs = rng.normal(size=(n, obs_dim)).astype(np.float32)
    act = rng.integers(0, actions, n)
    old_logp = (np.log(rng.random(n)) - 1.0).astype(np.float32)
    adv = rng.normal(size=n).astype(np.float32)
    returns = rng.normal(size=n).astype(np.float32)
    valid = np.arange(n) < 11
    n_valid = valid.sum()

    def loss_fn(p):
        logits, vals = net.apply(p, obs)
        logps = jax.nn.log_softmax(logits)
        ratio = jnp.exp(logps[jnp.arange(n), act] - old_logp)
        clipped = jnp.clip(ratio, 0.8, 1.2)
        w = valid.astype(jnp.float32)
        policy_loss = -jnp.sum(jnp.minimum(ratio * adv, clipped * adv) * w) / n_valid
        value_loss = jnp.sum(jnp.square(vals - returns) * w) / n_valid
        entropy = -jnp.sum(jnp.sum(jnp.exp(logps) * logps, axis=1) * w) / n_valid
        return policy_loss + 0.5 * value_loss - 0.01 * entropy

    tx = optax.adam(3e-4)
    loss, grads = jax.value_and_grad(loss_fn)(params)
    updates, _ = tx.update(grads, tx.init(params), params)
    want = actor_critic_params_from_flax(jax.device_get(optax.apply_updates(params, updates)))

    port = ppo.ActorCritic(obs_dim, actions, (16,), torch.Generator())
    port.load_state_dict(actor_critic_params_from_flax(params))
    opt_state = adam_init(flatten_parameters(port)[None])
    valid_t = torch.as_tensor(valid)
    batch = (torch.as_tensor(obs), torch.as_tensor(act), torch.as_tensor(old_logp),
             torch.as_tensor(adv), torch.as_tensor(returns),
             valid_t.float() / valid_t.sum().float())
    (got_loss,) = ppo.ppo_update(port, opt_state, lambda i: batch, 1,
                                 ppo.PPOConfig(train_epochs=1))
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=TOL, atol=TOL)
    after = port.state_dict()
    for name, value in want.items():
        np.testing.assert_allclose(after[name].numpy(), value.numpy(), rtol=TOL, atol=TOL,
                                   err_msg=name)


def test_ppo_in_generic_sweep(landscape):
    """PPO through `run_landscape_robustness_sweep`: the cell equals its standalone run."""
    from flexs_tpu_torch.parallel import run_landscape_robustness_sweep

    df = run_landscape_robustness_sweep(
        [landscape], flexs.DNAA, starts=[START], signal_strengths=[1.0], seeds=[0],
        rounds=2, sequences_batch_size=8, model_queries_per_batch=50, algorithm="ppo",
        device="cpu")
    single, _ = _run(landscape, signal_strength=1.0)
    assert len(df) == 1
    assert df["max_fitness"].iloc[0] >= df["start_fitness"].iloc[0]
    assert 2 * 50 <= df["model_cost"].iloc[0] <= 2 * 51
    assert df["max_fitness"].iloc[0] == single["true_score"].max()
    assert df["model_cost"].iloc[0] == single["model_cost"].iloc[-1]


def test_default_device_without_card_raises(landscape):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DevicePPONAM(landscape, flexs.DNAA, starting_sequence=START, **RUN)
