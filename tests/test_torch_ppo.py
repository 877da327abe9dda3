"""The port's PPO agent and mutation-walk environment against the JAX package's.

The JAX agent's actor-critic is carried across
(`convert.actor_critic_params_from_flax`); logits, values and one `train`
call (10 full-batch epochs, masks with False entries) must agree within
1e-5.  GAE and the Welford observation statistics are the same float
arithmetic in both packages and must agree exactly.
"""
import jax
import numpy as np
import pytest
import torch

import flexs_tpu
import flexs_tpu_torch
from flexs_tpu.baselines.explorers.environments.ppo import PPOEnvironment as JaxPPOEnvironment
from flexs_tpu.rl.ppo import PPOAgent as JaxPPOAgent
from flexs_tpu_torch.baselines.explorers.environments.ppo import PPOEnvironment
from flexs_tpu_torch.baselines.models.convert import actor_critic_params_from_flax
from flexs_tpu_torch.rl.ppo import PPOAgent

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel worker processes."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def _pair(obs_dim=12, num_actions=5, fc_layers=(16,), **kw):
    ref = JaxPPOAgent(obs_dim, num_actions, fc_layers=fc_layers, seed=0, **kw)
    port = PPOAgent(obs_dim, num_actions, fc_layers=fc_layers, seed=0, device="cpu", **kw)
    port.net.load_state_dict(actor_critic_params_from_flax(jax.device_get(ref.params)))
    return ref, port


@pytest.mark.parametrize("fc_layers", [(16,), (16, 8)])
def test_actor_critic_matches_flax(fc_layers):
    ref, port = _pair(fc_layers=fc_layers)
    obs = np.random.default_rng(0).normal(size=(7, 12)).astype(np.float32)
    logits, values = ref._net.apply(ref.params, obs)
    with torch.no_grad():
        got_logits, got_values = port.net(torch.tensor(obs))
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(logits), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_values.numpy(), np.asarray(values), rtol=TOL, atol=TOL)


def test_gae_and_observation_statistics_exact():
    ref, port = _pair()
    rng = np.random.default_rng(1)
    rewards = rng.random(9).astype(np.float32)
    values = rng.random(9).astype(np.float32)
    dones = np.array([0, 0, 1, 0, 1, 0, 0, 0, 1], bool)
    for got, want in zip(port.compute_gae(rewards, values, dones),
                         ref.compute_gae(rewards, values, dones)):
        np.testing.assert_array_equal(got, want)
    for _ in range(3):
        obs = rng.normal(size=(6, 12))
        ref._update_obs_stats(obs)
        port._update_obs_stats(obs)
    np.testing.assert_array_equal(port._obs_mean, ref._obs_mean)
    np.testing.assert_array_equal(port._obs_m2, ref._obs_m2)
    assert port._obs_count == ref._obs_count
    obs = rng.normal(size=(4, 12))
    np.testing.assert_array_equal(port._normalize(obs), ref._normalize(obs))


def test_train_matches_flax_with_masks():
    ref, port = _pair()
    rng = np.random.default_rng(2)
    t = 24
    masks = rng.random((t, 5)) < 0.7
    masks[:, 0] = True
    actions = np.array([rng.choice(np.flatnonzero(m)) for m in masks])
    assert not masks.all()
    batch = {
        "obs": rng.normal(size=(t, 12)).astype(np.float32),
        "actions": actions,
        "logprobs": np.log(rng.random(t) * 0.5 + 0.2).astype(np.float32),
        "rewards": rng.random(t).astype(np.float32),
        "dones": rng.random(t) < 0.3,
        "values": rng.random(t).astype(np.float32),
        "masks": masks,
    }
    want_loss = ref.train(batch)
    got_loss = port.train(batch)
    assert np.isfinite(got_loss)
    np.testing.assert_allclose(got_loss, want_loss, rtol=TOL, atol=TOL)
    want = actor_critic_params_from_flax(jax.device_get(ref.params))
    got = port.net.state_dict()
    for name, value in want.items():
        assert torch.isfinite(got[name]).all()
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), rtol=TOL, atol=TOL,
                                   err_msg=name)
    np.testing.assert_array_equal(port._obs_mean, ref._obs_mean)


def test_act_respects_masks_and_the_generator():
    _, port = _pair()
    obs = np.random.default_rng(3).normal(size=(200, 12)).astype(np.float32)
    masks = np.zeros((200, 5), bool)
    masks[:, [1, 3]] = True
    actions, logprobs, values = port.act(obs, masks)
    assert set(actions.tolist()) == {1, 3}
    assert (logprobs <= 0).all() and np.isfinite(values).all()
    again = PPOAgent(12, 5, fc_layers=(16,), seed=0, device="cpu")
    again.net.load_state_dict(port.net.state_dict())
    np.testing.assert_array_equal(again.act(obs, masks)[0], actions)


def test_agent_learns_bandit():
    """The JAX package's bandit case: the agent must come to prefer the rewarded action."""
    agent = PPOAgent(obs_dim=4, num_actions=3, learning_rate=3e-3, train_epochs=5, seed=0,
                     device="cpu")
    obs = np.ones((64, 4), np.float32)
    for _ in range(30):
        actions, logprobs, values = agent.act(obs)
        agent.train({"obs": obs, "actions": actions, "logprobs": logprobs,
                     "rewards": (actions == 2).astype(np.float32),
                     "dones": np.ones(64, bool), "values": values})
    actions, _, _ = agent.act(obs)
    assert (actions == 2).mean() > 0.8


class _CountT:
    """Deterministic smooth fitness (fraction of 'T's), as a model of either package."""

    @staticmethod
    def make(pkg):
        class CountT(pkg.Model):
            def __init__(self):
                super().__init__(name="CountT")

            def train(self, *args):
                pass

            def _fitness_function(self, sequences):
                return np.array([s.count("T") / len(s) for s in sequences])

        return CountT()


def test_ppo_environment_steps_like_jax():
    envs = [cls(flexs_tpu.DNAA, "TTGCAGCA", _CountT.make(pkg), max_num_steps=6)
            for cls, pkg in ((PPOEnvironment, flexs_tpu_torch), (JaxPPOEnvironment, flexs_tpu))]
    rng = np.random.default_rng(4)
    for _ in range(4):
        obs = [env.reset() for env in envs]
        np.testing.assert_array_equal(*obs)
        done = False
        while not done:
            action = int(rng.integers(32))
            (o1, r1, d1), (o2, r2, d2) = (env.step(action) for env in envs)
            np.testing.assert_array_equal(o1, o2)
            assert (r1, d1) == (r2, d2)
            done = d1
        assert envs[0].get_state_string() == envs[1].get_state_string()
        assert envs[0].model.cost == envs[1].model.cost


class _FakeLandscape(flexs_tpu_torch.Landscape):
    def __init__(self):
        super().__init__(name="FakeLandscape")
        self.rng = np.random.default_rng(0)

    def _fitness_function(self, sequences):
        return self.rng.random(size=len(sequences))


def test_ppo_explorer_run_invariants():
    """The JAX package's PPO smoke invariants (2 rounds, batch 5, 20 queries)."""
    model = _CountT.make(flexs_tpu_torch)
    explorer = flexs_tpu_torch.baselines.explorers.PPO(
        model, rounds=2, sequences_batch_size=5, model_queries_per_batch=20,
        starting_sequence="TTGC", alphabet=flexs_tpu.DNAA, seed=0, device="cpu")
    df, _ = explorer.run(_FakeLandscape(), verbose=False)
    assert df["round"].max() == 2
    for r in (1, 2):
        assert 0 < len(df[df["round"] == r]) <= 5
    costs = df.groupby("round")["model_cost"].first().to_numpy()
    assert (np.diff(costs) > 0).all()
