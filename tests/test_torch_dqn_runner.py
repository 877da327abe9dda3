"""The port's fused DQN runner on the CPU, against the JAX package's.

The runner draws from torch Generators, which cannot replay `jax.random`,
so it is held to the invariants of the JAX package's cases
(tests/test_dqn_runner.py), to its cell-axis entry point (C = 3) equalling
three single runs bitwise, and to the JAX runner's mean top over the same
four seeds within a stated band.  Its deterministic pieces are held to the
JAX runner's formulas (flexs_tpu/runtime/dqn_runner.py:183-226): the
stratified PER indices exactly, and one burst step at fixed sample indices
(TD loss, the L1 clip over every gradient, the BatchNorm statistics' too,
and Adam(1e-3)) within 1e-5 on Q-network variables carried across by
`convert.qnetwork_variables_from_flax`.
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
from flexs_tpu.baselines.explorers import dqn as jax_dqn
from flexs_tpu_torch.baselines.explorers.dqn import QNetwork, train_step
from flexs_tpu_torch.baselines.models.convert import qnetwork_variables_from_flax
from flexs_tpu_torch.baselines.models.torch_model import (
    adam_init,
    adam_step_,
    flat_grad,
    flatten_parameters,
)
from flexs_tpu_torch.landscapes import tf_binding
from flexs_tpu_torch.runtime import DeviceDQNNAM, SurrogateSpec, dqn_runner
from flexs_tpu_torch.runtime.jit_runner import AdaleadConfig, cell_axis_oracle

START = tf_binding.STARTS[0]
SEEDS = (0, 1, 2, 3)
BAND = 0.15  # |port - JAX| of the mean top over SEEDS
TOL = 1e-5
RUN = dict(rounds=2, sequences_batch_size=5, model_queries_per_batch=25, memory_size=128)
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
    return DeviceDQNNAM(landscape, flexs.DNAA, starting_sequence=START, device="cpu",
                        **kw).run(verbose=False)


def _gen(seed):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return gen


def test_schema_and_rounds(landscape):
    df, meta = _run(landscape)
    assert df["round"].max() == 2
    for r in range(1, 3):
        sub = df[df["round"] == r]
        assert 0 < len(sub) <= 5
        assert sub["sequence"].is_unique  # across rounds re-proposals are allowed
    assert np.isnan(df["model_score"].iloc[0])
    # Every step charges one model query.
    assert df.groupby("round")["model_cost"].first().tolist() == [0, 25, 50]
    assert meta["exp_name"] == "DeviceDQN_Explorer"


@pytest.mark.parametrize("model", ["nam", "perfect", "surrogate"])
def test_truth_matches_both_landscapes(landscape, jax_landscape, model):
    df, meta = _run(landscape, model=model, surrogate_spec=TINY)
    seqs = df["sequence"].tolist()
    np.testing.assert_array_equal(df["true_score"].to_numpy(), landscape.get_fitness(seqs))
    np.testing.assert_allclose(df["true_score"].to_numpy(), jax_landscape.get_fitness(seqs),
                               atol=1e-6)
    if model == "perfect":
        # A perfect model's queries never charge the landscape.
        assert landscape.cost >= len(df)


def test_dqn_climbs_with_budget(landscape):
    df, _ = _run(landscape, rounds=4, sequences_batch_size=20, model_queries_per_batch=200,
                 memory_size=1024, signal_strength=1.0)
    assert df["true_score"].max() > 0.85


def test_seed_determinism(landscape):
    a, _ = _run(landscape, seed=9)
    b, _ = _run(landscape, seed=9)
    assert a["sequence"].tolist() == b["sequence"].tolist()
    c, _ = _run(landscape, seed=10)
    assert a["sequence"].tolist() != c["sequence"].tolist()


def test_cells_equal_single_runs(landscape):
    """Three cells in lockstep (other starts, signal strengths, seeds) equal three single runs."""
    fn, params = landscape.device_fitness()
    cfg = AdaleadConfig(rounds=2, sequences_batch_size=5, model_queries_per_batch=25,
                        alphabet_size=4)
    kw = dict(memory_size=128, train_epochs=4)
    starts = torch.as_tensor(flexs.Alphabet(flexs.DNAA).encode(tf_binding.STARTS[:3]))
    ss, seeds = [0.5, 0.9, 1.0], [3, 4, 5]
    cells = dqn_runner.run_dqn_nam_cells(cell_axis_oracle(fn), params, starts, cfg, ss,
                                         [_gen(s) for s in seeds], **kw)
    for c in range(3):
        single = dqn_runner.run_dqn_nam(fn, params, starts[c], cfg, ss[c], _gen(seeds[c]), **kw)
        for name, got, want in zip(single._fields, cells, single):
            assert torch.equal(got[c], want), (c, name)


@pytest.fixture(scope="module")
def mean_tops(landscape, jax_landscape):
    """(port, JAX) mean top over SEEDS at the JAX cases' size, NAM at 0.9."""
    port = [_run(landscape, seed=s)[0]["true_score"].max() for s in SEEDS]
    ref = [jax_runtime.DeviceDQNNAM(
        jax_landscape, flexs.DNAA, starting_sequence=START, signal_strength=0.9, seed=s,
        **RUN).run(verbose=False)[0]["true_score"].max() for s in SEEDS]
    return np.mean(port), np.mean(ref)


def test_quality_matches_jax(mean_tops):
    port, ref = mean_tops
    assert abs(port - ref) <= BAND, (port, ref)


def test_per_indices_equal_jax():
    """The stratified PER draw of `dqn_runner.py:188-198` for given offsets u."""
    rng = np.random.default_rng(0)
    size, batch = 40, 8
    for n, prio in ((40, rng.random(size)), (13, np.ones(size)), (3, rng.random(size) + 0.5)):
        prio = prio.astype(np.float32)
        u = rng.random(batch).astype(np.float32)
        p = jnp.where(jnp.arange(size) < n, jnp.asarray(prio), 0.0)
        cum = jnp.cumsum(p)
        bounds = cum[-1] / batch * (jnp.arange(batch) + jnp.asarray(u))
        want = np.asarray(jnp.clip(jnp.searchsorted(cum, bounds, side="right"), 0, size - 1))
        got = dqn_runner.per_indices(torch.tensor(prio), torch.tensor(n), torch.tensor(u))
        np.testing.assert_array_equal(got.numpy(), want)


L, A = 8, 4
DIM = L * A


STEPS = 20  # a burst's length; Adam's first step alone is blind to the clip's scale


@pytest.fixture(scope="module")
def burst_case():
    """JAX Q-network variables (statistics perturbed), STEPS PER batches of tokens, JAX's result."""
    module = jax_dqn.QNetwork(L, A)
    variables = jax.device_get(module.init(jax.random.PRNGKey(0), jnp.zeros((1, 2 * DIM))))
    rng = np.random.default_rng(1)
    stats = variables["batch_stats"]
    for layer in stats.values():
        layer["mean"] = rng.normal(size=layer["mean"].shape).astype(np.float32) * 0.1
        layer["var"] = rng.random(layer["var"].shape).astype(np.float32) + 0.5
    params = variables["params"]
    # A positive output bias keeps the last ReLU open, so every layer has a gradient.
    params["Dense_2"]["bias"] = np.ones_like(params["Dense_2"]["bias"])
    variables = {"params": params, "batch_stats": stats}
    b = 6
    batches = [dict(obs=rng.integers(0, A, (b, L)), nxt=rng.integers(0, A, (b, L)),
                    act=rng.integers(0, DIM, b),
                    act_val=rng.random(b).astype(np.float32) + 0.5,
                    rew=rng.random(b).astype(np.float32)) for _ in range(STEPS)]
    return variables, batches, _jax_burst(module, variables, batches)


def _jax_burst(module, variables, batches, gamma=0.9):
    """(losses, variables) after the JAX runner's burst steps (`dqn_runner.py:183-226`)."""

    def all_action_q(p, tokens):
        state = jax.nn.one_hot(tokens, A, dtype=jnp.float32).reshape(DIM)
        x = jnp.concatenate([jnp.broadcast_to(state, (DIM, DIM)), jnp.eye(DIM)], axis=1)
        return module.apply(p, x).reshape(L, A)

    def loss_fn(p, batch):
        b = batch["rew"].shape[0]
        obs = jax.nn.one_hot(batch["obs"], A, dtype=jnp.float32).reshape(b, DIM)
        acts = jax.nn.one_hot(batch["act"], DIM, dtype=jnp.float32) * batch["act_val"][:, None]
        q_sa = module.apply(p, jnp.concatenate([obs, acts], axis=1)).reshape(-1)
        next_q = jax.vmap(lambda t: all_action_q(p, t))(jnp.asarray(batch["nxt"]))
        target = jax.lax.stop_gradient(jnp.max(next_q.reshape(b, DIM), axis=1) * gamma
                                       + batch["rew"])
        return jnp.mean(jnp.square(q_sa - target))

    tx = optax.chain(jax_dqn._clip_by_l1_norm(1.0), optax.adam(1e-3))

    @jax.jit
    def step(variables, opt_state, batch):
        loss, grads = jax.value_and_grad(loss_fn)(variables, batch)
        updates, opt_state = tx.update(grads, opt_state, variables)
        return optax.apply_updates(variables, updates), opt_state, loss

    opt_state, losses = tx.init(variables), []
    for batch in batches:
        variables, opt_state, loss = step(variables, opt_state, batch)
        losses.append(float(loss))
    return losses, jax.device_get(variables)


def _port_net(variables):
    gen = torch.Generator()
    net = QNetwork(L, A, gen)
    net.load_state_dict(qnetwork_variables_from_flax(variables))
    return net, flatten_parameters(net)


def _port_batch(batch):
    def hot(tokens, width):
        return torch.nn.functional.one_hot(torch.as_tensor(tokens), width).float()

    obs = hot(batch["obs"], A).reshape(-1, DIM)
    nxt = hot(batch["nxt"], A).reshape(-1, DIM)
    acts = hot(batch["act"], DIM) * torch.as_tensor(batch["act_val"])[:, None]
    return obs, acts, torch.as_tensor(batch["rew"]), nxt


def _td_grads(net, obs, acts, rews, nxt):
    q_sa = net(torch.cat([obs, acts], dim=1))
    with torch.no_grad():
        target = net.all_actions(nxt).amax(dim=1) * 0.9 + rews
    return flat_grad(torch.mean(torch.square(q_sa - target)), net)


def _worst(net, want):
    after = net.state_dict()
    return max(float(np.abs(after[name].numpy() - value.numpy()).max())
               for name, value in qnetwork_variables_from_flax(want).items())


def test_burst_steps_match_jax(burst_case):
    """A burst's steps at fixed indices: TD losses, clipped Adam updates, moved statistics."""
    variables, batches, (want_losses, want) = burst_case
    net, flat = _port_net(variables)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    opt_state = adam_init(flat[None])
    for batch, want_loss in zip(batches, want_losses):
        args = _port_batch(batch)
        # The clip is active: the gradient's L1 norm exceeds 1.
        assert float(_td_grads(net, *args).abs().sum()) > 1.0
        loss = train_step(net, opt_state, *args, 0.9)
        np.testing.assert_allclose(float(loss), want_loss, rtol=TOL, atol=TOL)
    after = net.state_dict()
    for name, value in qnetwork_variables_from_flax(want).items():
        np.testing.assert_allclose(after[name].numpy(), value.numpy(), rtol=TOL, atol=TOL,
                                   err_msg=name)
    for name in ("BatchNorm_0.mean", "BatchNorm_0.var", "BatchNorm_1.mean", "BatchNorm_1.var"):
        assert not torch.equal(after[name], before[name]), f"{name} did not move"


def test_burst_steps_fail_without_statistics_in_the_clip(burst_case):
    """Mutation check: leaving the statistics' gradients out of the L1 norm misses JAX."""
    variables, batches, (_, want) = burst_case
    net, flat = _port_net(variables)
    stat = torch.cat([torch.full((p.numel(),), name.endswith((".mean", ".var")))
                      for name, p in net.named_parameters()])
    opt_state = adam_init(flat[None])
    for batch in batches:
        grads = _td_grads(net, *_port_batch(batch))
        norm = torch.sum(torch.abs(grads[~stat]))
        adam_step_(opt_state, (grads * torch.clamp(1.0 / (norm + 1e-12), max=1.0))[None], 1e-3)
    assert _worst(net, want) > 10 * TOL, _worst(net, want)


def test_generic_sweep_cell_equals_standalone(landscape):
    """DQN through `run_landscape_robustness_sweep`: the cell equals its standalone run."""
    from flexs_tpu_torch.parallel import run_landscape_robustness_sweep

    df = run_landscape_robustness_sweep(
        [landscape], flexs.DNAA, starts=[START], signal_strengths=[1.0], seeds=[0], rounds=2,
        sequences_batch_size=5, model_queries_per_batch=25, algorithm="dqn",
        algorithm_kwargs={"memory_size": 128}, device="cpu")
    single, _ = _run(landscape, signal_strength=1.0)
    assert len(df) == 1 and df["max_fitness"].iloc[0] == single["true_score"].max()
    assert df["model_cost"].iloc[0] == 50


def test_default_device_without_card_raises(landscape):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceDQNNAM(landscape, flexs.DNAA, starting_sequence=START, **RUN)
