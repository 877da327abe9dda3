"""The port's DQN Q network and training step against the JAX package's, and the PER buffer.

The JAX explorer's Q network is carried across with its BatchNorm
statistics perturbed away from (0, 1), so that the normalization is not a
no-op.  One `train_actor`-sized call (20 Adam steps on stacked PER
batches) must land on the same variables within 1e-5: the BatchNorm means
and variances included, which Adam trains as weights in the JAX package,
with the L1 clip spanning their gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexs_tpu
import flexs_tpu_torch
from flexs_tpu.utils import replay_buffers as jax_buffers
from flexs_tpu_torch.baselines.models.convert import qnetwork_variables_from_flax
from flexs_tpu_torch.baselines.models.torch_model import flat_grad
from flexs_tpu_torch.utils import replay_buffers

TOL = 1e-5
START = "TTGCAGCA"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel worker processes."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def _explorer(pkg, **device):
    return pkg.baselines.explorers.DQN(
        None, rounds=2, sequences_batch_size=16, model_queries_per_batch=64,
        starting_sequence=START, alphabet=pkg.DNAA, seed=0, **device)


@pytest.fixture(scope="module")
def pair():
    """(JAX explorer, port explorer) holding the same perturbed Q network."""
    ref = _explorer(flexs_tpu)
    ref.initialize_data_structures()
    rng = np.random.default_rng(0)
    stats = jax.device_get(ref._params["batch_stats"])
    for layer in stats.values():
        layer["mean"] = rng.normal(size=layer["mean"].shape).astype(np.float32) * 0.1
        layer["var"] = rng.random(layer["var"].shape).astype(np.float32) + 0.5
    ref._params = {"params": ref._params["params"], "batch_stats": stats}
    port = _explorer(flexs_tpu_torch, device="cpu")
    port.initialize_data_structures()
    port.q_network.load_state_dict(qnetwork_variables_from_flax(ref._params))
    return ref, port


def _states(rng, b, length=8, a=4):
    tokens = rng.integers(0, a, (b, length))
    return np.eye(a, dtype=np.float32)[tokens].reshape(b, -1)


def test_all_action_q_matches_flax(pair):
    ref, port = pair
    states = _states(np.random.default_rng(1), 5)
    want = np.asarray(ref._all_action_q(ref._params, jnp.asarray(states)))
    got = port.all_action_q(states)
    assert got.shape == (5, 32)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # The single-row forward equals the all-action table.
    action = np.eye(32, dtype=np.float32)[[3]]
    with torch.no_grad():
        q = port.q_network(torch.tensor(np.concatenate([states[:1], action], axis=1)))
    np.testing.assert_allclose(q.numpy(), got[0, 3:4], rtol=TOL, atol=TOL)


def _batches(seed=2, epochs=20, b=16):
    rng = np.random.default_rng(seed)
    obs = np.stack([_states(rng, b) for _ in range(epochs)])
    nxt = np.stack([_states(rng, b) for _ in range(epochs)])
    acts = nxt * (1 - obs)
    rews = rng.random((epochs, b)).astype(np.float32)
    return obs, acts, rews, nxt


def test_train_step_matches_flax(pair):
    ref, port = pair
    obs, acts, rews, nxt = _batches()
    state = port.q_network.state_dict()
    before = {k: v.clone() for k, v in state.items()}

    # The clip is active on the first step: the gradient's L1 norm is > 1.
    t = [torch.tensor(a) for a in (obs, acts, rews, nxt)]
    q_sa = port.q_network(torch.cat([t[0][0], t[1][0]], dim=1))
    with torch.no_grad():
        target = port.q_network.all_actions(t[3][0]).amax(dim=1) * port.gamma + t[2][0]
    grads = flat_grad(torch.mean(torch.square(q_sa - target)), port.q_network)
    assert float(grads.abs().sum()) > 1.0

    params, loss = ref._train(
        ref._params, *(jnp.asarray(a) for a in (obs, acts, rews, nxt)),
        jnp.ones(rews.shape, jnp.float32))
    got_loss = port._train(*t)
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=TOL, atol=TOL)
    want = qnetwork_variables_from_flax(jax.device_get(params))
    after = port.q_network.state_dict()
    assert sorted(want) == sorted(after)
    for name, value in want.items():
        np.testing.assert_allclose(after[name].numpy(), value.numpy(), rtol=TOL, atol=TOL,
                                   err_msg=name)
    for name in ("BatchNorm_0.mean", "BatchNorm_0.var", "BatchNorm_1.mean", "BatchNorm_1.var"):
        assert not torch.equal(after[name], before[name]), f"{name} was not trained"


def test_per_sampling_matches_jax():
    bufs = [pkg.PrioritizedReplayBuffer(obs_dim=3, size=40, batch_size=8, alpha=0.6, seed=5)
            for pkg in (replay_buffers, jax_buffers)]
    rng = np.random.default_rng(0)
    for i in range(50):  # wraps the ring
        row = rng.random(3)
        for buf in bufs:
            buf.store(row, row * 2, float(i), row + 1)
    for buf in bufs:
        buf.update_priorities(np.arange(0, 40, 3), np.linspace(0.1, 5, 14))
    for _ in range(3):
        got, want = (buf.sample_batch(beta=0.5) for buf in bufs)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    plain = [pkg.ReplayBuffer(obs_dim=3, size=8, batch_size=4, seed=1)
             for pkg in (replay_buffers, jax_buffers)]
    for i in range(12):
        for buf in plain:
            buf.store(np.full(3, i), np.zeros(3), float(i), np.full(3, i + 1))
    got, want = (buf.sample_batch() for buf in plain)
    np.testing.assert_array_equal(got["rews"], want["rews"])
    assert got["rews"].min() >= 4 and len(plain[0]) == 8


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


def test_dqn_run_invariants():
    """The JAX package's DQN smoke invariants (3 rounds, batch 5, 20 queries)."""
    model = _FakeModel()
    explorer = flexs_tpu_torch.baselines.explorers.DQN(
        model, rounds=3, sequences_batch_size=5, model_queries_per_batch=20,
        starting_sequence=START, alphabet=flexs_tpu.DNAA, seed=0, device="cpu")
    df, _ = explorer.run(_FakeLandscape(), verbose=False)
    assert df["round"].max() == 3
    for r in range(1, 4):
        assert 0 < len(df[df["round"] == r]) <= 5
    assert model.cost == 3 * 20
    assert explorer.num_actions == 3 * 20


STALL_SEEDS = 200


def _jax_init_moves(seeds):
    """Nonzero masked moves at TF-Bind's STARTS[0] of fresh JAX Q nets, one per seed.

    Each net is initialised as the fused JAX runner does
    (`flexs_tpu/runtime/dqn_runner.py`: the run's key split, `init` on the
    second half), and the moves are its `all_action_q` masked by 1 - state.
    """
    from flexs_tpu.baselines.explorers.dqn import QNetwork
    from flexs_tpu.landscapes import tf_binding

    L, A = 8, 4
    dim = L * A
    q_module = QNetwork(seq_len=L, alphabet_len=A)
    tokens = flexs_tpu.alphabet.as_alphabet("TGCA").encode_one(tf_binding.STARTS[0])
    state = jax.nn.one_hot(jnp.asarray(tokens), A, dtype=jnp.float32).reshape(dim)
    x = jnp.concatenate([jnp.broadcast_to(state, (dim, dim)), jnp.eye(dim)], axis=1)

    @jax.jit
    def moves(seed):
        _, init_key = jax.random.split(jax.random.PRNGKey(seed))
        params = q_module.init(init_key, jnp.zeros((1, 2 * dim), jnp.float32))
        return jnp.sum((q_module.apply(params, x).reshape(dim) * (1 - state)) != 0)

    return np.array([int(moves(s)) for s in seeds])


def test_fresh_q_net_moves_match_jax_over_seeds():
    """The share of fresh Q nets with no nonzero move at the start, with at most two,
    and the mean count: port (CPU generator) and JAX over 200 seeds each.

    Few nonzero moves let the masked walk stall (PERF.md, the north-star DQN
    row).  The inits draw from different streams, so each statistic is held
    to three standard errors of the difference of two 200-seed estimates.
    """
    from flexs_tpu_torch import dqn_stall

    seeds = range(STALL_SEEDS)
    port = np.array(dqn_stall.init_moves(seeds, "cpu")["counts"])
    ref = _jax_init_moves(seeds)
    n = STALL_SEEDS
    for name, p, q in (("none", port == 0, ref == 0), ("at most 2", port <= 2, ref <= 2)):
        a, b = p.mean(), q.mean()
        se = np.sqrt(a * (1 - a) / n + b * (1 - b) / n)
        assert abs(a - b) <= 3 * se, (name, a, b, se)
    se = np.sqrt(port.var(ddof=1) / n + ref.var(ddof=1) / n)
    assert abs(port.mean() - ref.mean()) <= 3 * se, (port.mean(), ref.mean(), se)


def test_dqn_stall_lines_on_the_cpu():
    """`python -m flexs_tpu_torch.dqn_stall --cpu` at a small budget: its three lines.

    On one device the replay must never part from the run it replays.
    """
    import contextlib
    import io
    import json

    from flexs_tpu_torch import dqn_stall

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        dqn_stall.main(["--cpu"], init_seeds=8, grid_seeds=2, grid_rounds=1,
                       run=dict(sequences_batch_size=10, model_queries_per_batch=40))
    init, replay, grid = (json.loads(line) for line in out.getvalue().splitlines())
    assert [init["part"], replay["part"], grid["part"]] == ["init", "replay", "grid"]
    assert all(line["card"] == "cpu" for line in (init, replay, grid))
    counts = init["on_device"]["counts"]
    assert counts == dqn_stall.init_moves(range(8), "cpu")["counts"] and len(counts) == 8
    assert all(0 <= c <= 24 for c in counts)
    assert replay["steps_compared"] == 40 and replay["first_part"] is None, replay
    assert replay["nonzero_moves_first_40"][0] == counts[0]
    assert grid["cells"] == 2 and grid["stalled"] == len(grid["stalled_seeds"])
    assert all(c < dqn_stall.STALL_COST for c in grid["stalled_landscape_costs"])
