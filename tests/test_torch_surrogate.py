"""The port's nets, optimizer and runtime surrogate against the JAX package.

Weights go across with `convert.params_from_flax`, so the same nets run in
both packages on the same numpy-seeded inputs.  Tolerances: forward passes
1e-5 (f32 sums in another order), gradients 1e-4 relative, one Adam step
1e-7 (elementwise f32 arithmetic on the same inputs), the closed-form
linear fit 2e-3 in its fitted values (an f64 eigh here, XLA's f32 eigh
there), the exact GP 2e-3 when each package fits and 1e-6 from JAX's
fitted state.  Training draws from a torch generator, which cannot replay
`jax.random`, so a fit is held to what it must do, not to JAX's numbers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen

from flexs_tpu.baselines.models import cnn as jax_cnn
from flexs_tpu.baselines.models import global_epistasis_model as jax_gem
from flexs_tpu.baselines.models import mlp as jax_mlp
from flexs_tpu.runtime import surrogate as jax_surrogate

from flexs_tpu_torch.baselines.models import CNNModule, GlobalEpistasisModule, MLPModule
from flexs_tpu_torch.baselines.models import torch_model
from flexs_tpu_torch.baselines.models.convert import params_from_flax, surrogate_state_from_flax
from flexs_tpu_torch.runtime import surrogate

L = 10
TINY = surrogate.SurrogateSpec(num_filters=8, hidden_size=16, epochs=3, batch_size=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel worker processes."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def _nets(arch, alphabet_size):
    """(JAX module, the port's module) of one arch at the tests' widths."""
    if arch == "cnn":
        return (jax_cnn.CNNModule(8, 16, alphabet_size),
                CNNModule(8, 16, alphabet_size, device="meta"))
    if arch == "mlp":
        return jax_mlp.MLPModule(16), MLPModule(16, L, alphabet_size, device="meta")
    return (jax_gem.GlobalEpistasisModule(16),
            GlobalEpistasisModule(16, L, alphabet_size, device="meta"))


def _flax_params(module, x, seed, **kwargs):
    """Flax init, with every bias moved off zero so that biases are checked too."""
    tree = module.init({"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(1)},
                       jnp.asarray(x[:1]), **kwargs)
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.normal(size=a.shape).astype(np.float32),
                        tree)


def _one_hot(rng, n, alphabet_size):
    return np.eye(alphabet_size, dtype=np.float32)[rng.integers(0, alphabet_size, (n, L))]


@pytest.mark.parametrize("alphabet_size", [4, 5, 20])
@pytest.mark.parametrize("arch", ["cnn", "mlp", "gem"])
def test_forward_equals_flax_apply(arch, alphabet_size):
    """A = 5 gives the third conv an even width, where SAME pads one more on the right."""
    rng = np.random.default_rng(alphabet_size)
    x = _one_hot(rng, 13, alphabet_size)
    jax_net, net = _nets(arch, alphabet_size)
    tree = _flax_params(jax_net, x, alphabet_size, train=False)
    want = np.asarray(jax_net.apply(tree, jnp.asarray(x), train=False)).reshape(-1)
    flat = params_from_flax(arch, tree)
    assert flat.shape == (1, sum(torch_model.param_layout(net)[2]))
    got = torch_model.forward_flat(net, flat, torch.as_tensor(x)[None])[0]
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kernel_size,padding", [(4, "SAME"), (5, "SAME"), (3, "VALID")])
def test_conv_layer_equals_flax_conv(kernel_size, padding):
    rng = np.random.default_rng(kernel_size)
    x = rng.normal(size=(3, 11, 6)).astype(np.float32)
    flax_conv = linen.Conv(7, (kernel_size,), padding=padding)
    tree = _flax_params(flax_conv, x, kernel_size)
    want = np.asarray(flax_conv.apply(tree, jnp.asarray(x)))
    conv = torch_model.Conv(6, 7, kernel_size, padding, device="meta")
    views = {k: torch.as_tensor(v)[None] for k, v in tree["params"].items()}
    got = torch.func.functional_call(conv, views, (torch.as_tensor(x)[None],))[0]
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["cnn", "mlp", "gem"])
def test_loss_gradient_equals_jax_grad(arch):
    """The weighted batch loss of the fit, dropout off."""
    rng = np.random.default_rng(7)
    x = _one_hot(rng, 24, 4)
    y = rng.normal(size=24).astype(np.float32)
    w = (rng.random(24) < 0.7).astype(np.float32)
    jax_net, net = _nets(arch, 4)
    tree = _flax_params(jax_net, x, 3, train=False)

    def batch_loss(p):
        preds = jax_net.apply(p, jnp.asarray(x), train=False).reshape(-1)
        return jnp.sum(jnp.square(preds - y) * w) / (jnp.sum(w) + 1e-9)

    want = params_from_flax(arch, jax.tree.map(np.asarray, jax.grad(batch_loss)(tree))).numpy()
    params = params_from_flax(arch, tree).requires_grad_()
    preds = torch_model.forward_flat(net, params, torch.as_tensor(x)[None])
    wt = torch.as_tensor(w)[None]
    loss = (torch_model.mse_loss(preds, torch.as_tensor(y)[None]) * wt).sum(1) / (wt.sum(1) + 1e-9)
    (got,) = torch.autograd.grad(loss.sum(), params)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-7)


def _optax_steps(params0, grads_seq):
    """optax.adam(1e-3) over each net (row) separately: [(params, mu, nu, count)] per step."""
    tx = optax.adam(1e-3)
    states = [(jnp.asarray(p), tx.init(jnp.asarray(p))) for p in params0]
    out = []
    for grads in grads_seq:
        new = []
        for (p, st), g in zip(states, grads):
            updates, st = tx.update(jnp.asarray(g), st, p)
            new.append((optax.apply_updates(p, updates), st))
        states = new
        out.append([
            np.stack([np.asarray(p) for p, _ in states]),
            np.stack([np.asarray(st[0].mu) for _, st in states]),
            np.stack([np.asarray(st[0].nu) for _, st in states]),
            np.array([int(st[0].count) for _, st in states]),
        ])
    return out


def test_adam_steps_equal_optax_and_the_noop_keeps_everything():
    rng = np.random.default_rng(0)
    params0 = (0.1 * rng.normal(size=(2, 301))).astype(np.float32)
    grads_seq = [rng.normal(size=(2, 301)).astype(np.float32) for _ in range(4)]
    want = _optax_steps(params0, grads_seq)
    state = torch_model.adam_init(torch.as_tensor(params0))
    for step, grads in enumerate(grads_seq[:3]):
        state = torch_model.adam_step(state, torch.as_tensor(grads), 1e-3)
        for got, ref in zip(state, want[step]):
            np.testing.assert_allclose(got.numpy(), ref, atol=1e-7, rtol=0)
    # Net 1's minibatch is all padding: a true no-op, its count included.
    kept = torch_model.adam_step(state, torch.as_tensor(grads_seq[3]), 1e-3,
                                 keep=torch.tensor([True, False]))
    for got, before, ref in zip(kept, state, want[3]):
        np.testing.assert_allclose(got[0].numpy(), ref[0], atol=1e-7, rtol=0)
        assert torch.equal(got[1], before[1])
    assert kept.count.tolist() == [4, 3]


def test_padding_only_minibatch_noop_vs_host_semantics():
    """surrogate.train skips an all-padding minibatch; TorchModel's fit applies it."""
    net = MLPModule(8, L, 4, device="meta")
    gen = torch.Generator().manual_seed(0)
    state = torch_model.adam_init(torch_model.init_flat(net, 2, gen))
    rng = np.random.default_rng(1)
    x = torch.as_tensor(_one_hot(rng, 16, 4))[None].expand(2, -1, -1, -1)
    y = torch.as_tensor(rng.normal(size=(2, 16)).astype(np.float32))
    w = torch.ones(2, 16)
    state, _ = torch_model.minibatch_step(net, state, x, y, w, 1e-3, skip_empty=True)
    w0 = torch.tensor([[1.0] * 16, [0.0] * 16])
    skipped, _ = torch_model.minibatch_step(net, state, x, y, w0, 1e-3, skip_empty=True)
    for a, b in zip(skipped, state):
        assert torch.equal(a[1], b[1])  # net 1: nothing moved
        assert not torch.equal(a[0], b[0])  # net 0 trained
    applied, _ = torch_model.minibatch_step(net, state, x, y, w0, 1e-3, skip_empty=False)
    assert not torch.equal(applied.params[1], state.params[1])  # momentum moves it
    assert torch.equal(applied.mu[1], 0.9 * state.mu[1])  # zero gradient
    assert applied.count.tolist() == [2, 2]


def test_training_step_from_a_carried_jax_state():
    """surrogate_state_from_flax carries weights, moments and count; one step agrees."""
    spec = TINY._replace(ensemble_size=2)
    A = 4
    jax_state = jax_surrogate.init_state(spec, A, L, jax.random.PRNGKey(5))
    module = jax_surrogate._module(spec, A)
    tx = optax.adam(spec.learning_rate)
    rng = np.random.default_rng(2)
    x = _one_hot(rng, 32, A)
    y = rng.normal(size=32).astype(np.float32)
    w = np.ones(32, np.float32)
    w[-5:] = 0

    def step(params, opt_state):
        def batch_loss(p):
            preds = module.apply(p, jnp.asarray(x), train=False).reshape(-1)
            return jnp.sum(jnp.square(preds - y) * w) / (jnp.sum(w) + 1e-9)

        updates, opt_state = tx.update(jax.grad(batch_loss)(params), opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    members_step = jax.jit(jax.vmap(step))
    for _ in range(2):  # nonzero moments and count before the compared step
        params, opt = members_step(jax_state.params, jax_state.opt_state)
        jax_state = jax_state._replace(params=params, opt_state=opt)
    state = surrogate_state_from_flax(spec, jax.tree.map(np.asarray, jax_state))
    assert state.nets.count.tolist() == [2, 2] and state.weight.shape == (1, 2)
    tokens = rng.integers(0, A, (9, L))
    np.testing.assert_allclose(
        surrogate.predict(spec, A, state, torch.as_tensor(tokens)).numpy(),
        np.asarray(jax_surrogate.predict(spec, A, jax_state, jnp.asarray(tokens))),
        rtol=1e-5, atol=1e-5,
    )

    params, opt = members_step(jax_state.params, jax_state.opt_state)
    net = surrogate.module(spec, A, L)
    xb = torch.as_tensor(x)[None].expand(2, -1, -1, -1)
    new, _ = torch_model.minibatch_step(
        net, state.nets, xb, torch.as_tensor(y)[None].expand(2, -1),
        torch.as_tensor(w)[None].expand(2, -1), spec.learning_rate, skip_empty=True,
    )
    want = surrogate_state_from_flax(
        spec, jax.tree.map(np.asarray, jax_state._replace(params=params, opt_state=opt))
    )
    for got, ref in zip(new, want.nets):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-6)


def test_linear_arch_equals_jax_train():
    rng = np.random.default_rng(0)
    A, n = 4, 50
    tokens = rng.integers(0, A, size=(64, L)).astype(np.int32)
    y = rng.normal(size=64).astype(np.float32)
    truth = np.where(np.arange(64) < n, y, -np.inf).astype(np.float32)
    spec = surrogate.SurrogateSpec(arch="linear")
    jax_spec = jax_surrogate.SurrogateSpec(arch="linear")
    key = jax.random.PRNGKey(0)
    jax_state = jax_surrogate.init_state(jax_spec, A, L, key)
    jax_state = jax_surrogate.train(jax_spec, A, jax_state, jnp.asarray(tokens),
                                    jnp.asarray(truth), n, key)
    want = np.asarray(jax_surrogate.predict(jax_spec, A, jax_state, jnp.asarray(tokens)))

    gen = torch.Generator().manual_seed(0)
    state = surrogate.init_state(spec, A, L, gen)
    state = surrogate.train(spec, A, state, torch.as_tensor(tokens), torch.as_tensor(truth), n,
                            gen)
    got = surrogate.predict(spec, A, state, torch.as_tensor(tokens)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-3)


def _buffer(seed=0, cap=64, n=60, A=4):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, A, (cap, L))
    truth = np.where(np.arange(cap) < n, (tokens == 2).sum(1) / L, -np.inf).astype(np.float32)
    return torch.as_tensor(tokens), torch.as_tensor(truth), n


@pytest.mark.parametrize("arch", ["cnn", "mlp", "gem"])
def test_surrogate_fit_reduces_loss(arch):
    tokens, truth, n = _buffer()
    spec = surrogate.SurrogateSpec(arch=arch, num_filters=8, hidden_size=16, epochs=40,
                                   batch_size=32)
    gen = torch.Generator().manual_seed(0)
    state = surrogate.init_state(spec, 4, L, gen)

    def mse(state):
        preds = surrogate.predict(spec, 4, state, tokens[:n])
        return float(((preds - truth[:n]) ** 2).mean())

    before = mse(state)
    state = surrogate.train(spec, 4, state, tokens, truth, n, gen)
    assert mse(state) < before * 0.5


def test_adaptive_ensemble_weights():
    tokens, truth, n = _buffer(1)
    spec = TINY._replace(ensemble_size=3, adaptive=True)
    gen = torch.Generator().manual_seed(0)
    state = surrogate.init_state(spec, 4, L, gen)
    np.testing.assert_allclose(state.weight.numpy(), [[1 / 3] * 3], atol=1e-7)
    state = surrogate.train(spec, 4, state, tokens, truth, n, gen)
    w = state.weight.numpy()[0]
    assert abs(w.sum() - 1.0) < 1e-5 and (w >= 0).all()
    assert not np.allclose(w, 1 / 3)
    members = surrogate.predict_members(spec, 4, state, tokens[:4]).numpy()
    np.testing.assert_allclose(
        surrogate.predict(spec, 4, state, tokens[:4]).numpy(), (members * w[:, None]).sum(0),
        atol=1e-6,
    )
    mean, std = surrogate.posterior(spec, 4, state, tokens[:4])
    np.testing.assert_allclose(std.numpy(), members.std(0), atol=1e-6)
    # Under 10 live rows the split is not used and the weights are kept.
    few = surrogate.train(spec, 4, state, tokens, truth, 8, gen)
    assert torch.equal(few.weight, state.weight)


@pytest.mark.parametrize("fields", [
    {}, {"ensemble_size": 3}, {"adaptive": True, "ensemble_size": 2}, {"arch": "mlp"},
    {"arch": "gem", "hidden_size": 16}, {"arch": "linear"}, {"arch": "gp"},
    {"num_filters": 8, "hidden_size": 16},
])
def test_model_names_equal_jax(fields):
    assert (surrogate.SurrogateSpec(**fields).model_name
            == jax_surrogate.SurrogateSpec(**fields).model_name)
    assert surrogate.SurrogateSpec()._asdict() == jax_surrogate.SurrogateSpec()._asdict()


def test_gem_keeps_the_reference_name_quirk():
    assert surrogate.SurrogateSpec(arch="gem", hidden_size=16).model_name == "MLP_hidden_size_16"


def test_gp_arch_raises():
    """arch="gp" needs a capacity and one plain member; unknown archs raise."""
    spec = surrogate.SurrogateSpec(arch="gp")
    surrogate.check_spec(spec)
    with pytest.raises(ValueError, match="capacity"):
        surrogate.init_state(spec, 4, L, torch.Generator())
    for bad in (spec._replace(ensemble_size=3), spec._replace(adaptive=True)):
        with pytest.raises(ValueError, match="exact posterior"):
            surrogate.init_state(bad, 4, L, torch.Generator(), capacity=64)
    with pytest.raises(ValueError, match="unknown surrogate arch"):
        surrogate.check_spec(surrogate.SurrogateSpec(arch="tree"))


def _gp_buffer(seed=3, cap=64, n=40, duplicates=False):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 4, size=(cap, L)).astype(np.int32)
    y = rng.normal(size=cap).astype(np.float32)
    if duplicates:
        tokens[[5, 9]] = tokens[2]
        y[[5, 9]] = y[2]
    truth = np.where(np.arange(cap) < n, y, -np.inf).astype(np.float32)
    return tokens, truth, n, rng.integers(0, 4, size=(16, L)).astype(np.int32)


@pytest.mark.parametrize("duplicates", [False, True])
def test_gp_arch_equals_jax_posterior(duplicates):
    """tests/test_surrogate_runner.py:109's case against JAX's arch="gp": the same
    first-occurrence mask; the posterior within 2e-3 when each package fits
    (JAX's own band between its two GP paths; the best point is picked among
    f32 values flat to their last bits) and within 1e-6 from JAX's state."""
    tokens, truth, n, query = _gp_buffer(duplicates=duplicates)
    A = 4
    jax_spec, spec = jax_surrogate.SurrogateSpec(arch="gp"), surrogate.SurrogateSpec(arch="gp")
    jax_state = jax_surrogate.init_state(jax_spec, A, L, jax.random.PRNGKey(0), capacity=64)
    jax_state = jax_surrogate.train(jax_spec, A, jax_state, jnp.asarray(tokens),
                                    jnp.asarray(truth), n, jax.random.PRNGKey(1))
    want_mu, want_std = (np.asarray(a) for a in jax_surrogate.posterior(
        jax_spec, A, jax_state, jnp.asarray(query)))

    gen = torch.Generator().manual_seed(0)
    state = surrogate.init_state(spec, A, L, gen, capacity=64)
    state = surrogate.train(spec, A, state, torch.as_tensor(tokens).long(), torch.as_tensor(truth),
                            n, gen)
    np.testing.assert_array_equal(state.nets.valid[0].numpy(),
                                  np.asarray(jax_state.params["valid"]))
    mu, std = surrogate.posterior(spec, A, state, torch.as_tensor(query).long())
    assert float(std.min()) > 0
    np.testing.assert_allclose(mu.numpy(), want_mu, atol=2e-3)
    np.testing.assert_allclose(std.numpy(), want_std, atol=2e-3)
    assert torch.equal(surrogate.predict(spec, A, state, torch.as_tensor(query).long()), mu)
    assert torch.equal(surrogate.predict_members(spec, A, state, torch.as_tensor(query).long()),
                       mu[None])

    carried = surrogate_state_from_flax(spec, jax_state)
    mu, std = surrogate.posterior(spec, A, carried, torch.as_tensor(query).long())
    np.testing.assert_allclose(mu.numpy(), want_mu, atol=1e-6)
    np.testing.assert_allclose(std.numpy(), want_std, atol=1e-6)


def test_gp_arch_survives_duplicate_measured_rows():
    """tests/test_surrogate_runner.py:475: duplicates do not NaN-poison the GP."""
    tokens, truth, _, _ = _gp_buffer(seed=0, cap=32, n=16, duplicates=True)
    spec = surrogate.SurrogateSpec(arch="gp", gp_opt_steps=10)
    gen = torch.Generator()
    state = surrogate.init_state(spec, 4, L, gen, capacity=32)
    state = surrogate.train(spec, 4, state, torch.as_tensor(tokens).long(), torch.as_tensor(truth),
                            16, gen)
    assert state.nets.valid[0, :16].sum() == 14  # rows 5 and 9 repeat row 2
    mu, std = surrogate.posterior(spec, 4, state, torch.as_tensor(tokens[:16]).long())
    assert torch.isfinite(mu).all() and torch.isfinite(std).all()
    np.testing.assert_allclose(mu.numpy()[2], truth[2], atol=0.1)


def test_gp_cells_train_as_one_state_equal_alone():
    """A 3-cell GP state fits and predicts as 3 one-cell states do, exactly."""
    spec = surrogate.SurrogateSpec(arch="gp", gp_opt_steps=20)
    bufs = [_gp_buffer(seed, n=30 + 5 * seed) for seed in range(3)]
    gens = [torch.Generator() for _ in bufs]
    joint = surrogate.init_state(spec, 4, L, gens, capacity=64)
    joint = surrogate.train(spec, 4, joint, torch.stack([torch.as_tensor(b[0]).long() for b in bufs]),
                            torch.stack([torch.as_tensor(b[1]) for b in bufs]),
                            torch.tensor([b[2] for b in bufs]), gens)
    queries = torch.stack([torch.as_tensor(b[3]).long() for b in bufs])
    mu, std = surrogate.posterior(spec, 4, joint, queries)
    for c, (tokens, truth, n, query) in enumerate(bufs):
        alone = surrogate.init_state(spec, 4, L, torch.Generator(), capacity=64)
        alone = surrogate.train(spec, 4, alone, torch.as_tensor(tokens).long(),
                                torch.as_tensor(truth), n, torch.Generator())
        m, s = surrogate.posterior(spec, 4, alone, torch.as_tensor(query).long())
        assert torch.equal(mu[c], m) and torch.equal(std[c], s)


def test_init_is_flax_lecun_normal():
    net = torch_model.Dense(400, 300, device="meta")
    flat = torch_model.init_flat(net, 2, torch.Generator().manual_seed(3))
    kernel, bias = flat[:, :-300], flat[:, -300:]
    std = (1 / 400) ** 0.5
    assert abs(float(kernel.std()) / std - 1) < 0.02
    assert float(kernel.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-7
    assert not bias.any()
    again = torch_model.init_flat(net, 2, torch.Generator().manual_seed(3))
    assert torch.equal(flat, again)


def test_cells_train_as_one_batch_equal_alone():
    """A state of 3 cells trains and predicts as 3 one-cell states do, exactly."""
    spec = TINY._replace(ensemble_size=2)
    bufs = [_buffer(seed, n=40 + 5 * seed) for seed in range(3)]

    def gens():
        return [torch.Generator().manual_seed(s) for s in (10, 11, 12)]

    g = gens()
    joint = surrogate.init_state(spec, 4, L, g)
    joint = surrogate.train(spec, 4, joint, torch.stack([b[0] for b in bufs]),
                            torch.stack([b[1] for b in bufs]), torch.tensor([b[2] for b in bufs]),
                            g)
    preds = surrogate.predict(spec, 4, joint, torch.stack([b[0][:7] for b in bufs]))
    for c, (gen, (tokens, truth, n)) in enumerate(zip(gens(), bufs)):
        alone = surrogate.init_state(spec, 4, L, gen)
        alone = surrogate.train(spec, 4, alone, tokens, truth, n, gen)
        assert torch.equal(joint.nets.params[2 * c: 2 * c + 2], alone.nets.params)
        assert torch.equal(preds[c], surrogate.predict(spec, 4, alone, tokens[:7]))
