"""The duplex kernel's per-landscape plan, held against the records it replaces.

The kernel (csrc/duplex_dp.cu) builds each sequence's gram indices and
duplex-end patches itself, from a `cuda_duplex.DuplexPlan`.  These tests
look the plan up the way the kernel does (`cuda_duplex.plan_lookups`, a
plain torch mirror of its formulas) and require bitwise equality with the
records the plain version builds (`rna_duplex.seq_grams`,
`boundary_patches`, `trigram_tables`) and with the JAX package's tables.
Nothing here builds or launches a kernel.
"""
import ctypes

import jax
import numpy as np
import pytest
import torch

from flexs_tpu.landscapes import rna as jax_rna
from flexs_tpu.ops import rna_duplex as jrd
from flexs_tpu_torch.alphabet import RNAA, Alphabet
from flexs_tpu_torch.landscapes import rna
from flexs_tpu_torch.ops import cuda_duplex
from flexs_tpu_torch.ops import rna_duplex as rd


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel worker processes."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


A = Alphabet(RNAA)
TARGETS = [jax_rna.registry()[f"L14_RNA{t}"]["params"]["targets"][0] for t in range(1, 5)]
_jax_slab_energies = jax.jit(jrd.duplex_energy_from_slabs, static_argnames="maxloop")


def _em():
    return rd.DuplexParams.calibrated().energy_model("cpu")


def _targets_rev(targets):
    return torch.as_tensor(np.stack([A.encode_one(t)[::-1] for t in targets]))


def _tokens(seed, b, l1, all_a_row=True):
    tokens = torch.as_tensor(np.random.default_rng(seed).integers(0, 4, (b, l1)))
    if all_a_row:
        tokens[0] = 3  # all "A": no cell pairs against an all-"A" target
    return tokens


@pytest.mark.parametrize("l1", [14, 50, 100])
@pytest.mark.parametrize("targets", [TARGETS, [TARGETS[1], "A" * 100]], ids=["T4", "T2"])
def test_patch_lookups_equal_boundary_patches(l1, targets):
    em = _em()
    targets_rev = _targets_rev(targets)
    plan = cuda_duplex.make_plan(targets_rev, em, 16)
    tokens = _tokens(l1, 6, l1)
    _, _, patches = cuda_duplex.plan_lookups(plan, tokens)
    if len(targets) == 2:  # the all-A row against the all-A target: unpairable ends
        assert (patches[1][0][0] == rd._INF).all() and (patches[1][1][0] == rd._INF).all()
    for t, trev in enumerate(targets_rev):
        want = rd.boundary_patches(tokens, trev, em)
        for got_p, want_p in zip(patches[t], want):
            assert got_p.dtype == want_p.dtype == torch.float32
            assert torch.equal(got_p, want_p)


@pytest.mark.parametrize("l1,l2", [(1, 5), (2, 1), (3, 2), (9, 40)])
def test_patch_lookups_at_the_smallest_shapes(l1, l2):
    em = _em()
    rng = np.random.default_rng(l1 * 10 + l2)
    targets_rev = torch.as_tensor(rng.integers(0, 4, (2, l2)))
    plan = cuda_duplex.make_plan(targets_rev, em, 16)
    tokens = _tokens(l2, 5, l1, all_a_row=False)
    _, _, patches = cuda_duplex.plan_lookups(plan, tokens)
    for t, trev in enumerate(targets_rev):
        for got_p, want_p in zip(patches[t], rd.boundary_patches(tokens, trev, em)):
            assert torch.equal(got_p, want_p)


@pytest.mark.parametrize("l1", [1, 2, 3, 14, 100])
def test_kernel_gram_formulas_equal_seq_grams(l1):
    plan = cuda_duplex.make_plan(_targets_rev(TARGETS[:1]), _em(), 16)
    tokens = _tokens(l1 + 1, 7, l1, all_a_row=False)
    s3g, s2g, _ = cuda_duplex.plan_lookups(plan, tokens)
    want3, want2 = rd.seq_grams(tokens)
    assert torch.equal(s3g, want3) and torch.equal(s2g, want2)


def test_plan_tables_equal_trigram_tables_and_jax():
    em = _em()
    targets_rev = _targets_rev(TARGETS)
    plan = cuda_duplex.make_plan(targets_rev, em, 16)
    t_past, t_fut = rd.trigram_tables(em)
    assert plan.t_past.is_contiguous() and plan.t_fut.is_contiguous()
    assert torch.equal(plan.t_past, t_past) and torch.equal(plan.t_fut, t_fut)
    for port, ref in zip((plan.t_past, plan.t_fut),
                         jrd.trigram_tables(jrd.DuplexParams.calibrated().energy_model())):
        np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    for t, trev in enumerate(targets_rev):
        t3g, t2g = rd.target_grams(trev)
        assert plan.t3g.dtype == plan.t2g.dtype == torch.int32
        assert torch.equal(plan.t3g[t].long(), t3g) and torch.equal(plan.t2g[t].long(), t2g)


def _nan_or_negative_zero(x):
    x = np.asarray(x, dtype=np.float32)
    return bool(np.isnan(x).any() or (np.signbit(x) & (x == 0)).any())


def test_min_reordering_precondition_no_nan_and_no_negative_zero():
    """The kernel takes each cell's min in another order and grouping than
    the plain version (four partial chains of the interior candidates).
    That is exact only if no candidate is NaN or -0.0: an f32 sum is -0.0 only
    if both addends are, so it suffices that no table holds either."""
    with np.load(rd._DEFAULT_PARAMS_PATH) as data:
        for name in data.files:
            if data[name].dtype.kind == "f":
                assert not _nan_or_negative_zero(data[name]), name
    for params in (rd.DuplexParams.calibrated(), rd.DuplexParams(maxloop=7)):
        em = params.energy_model("cpu")
        for name, x in em.items():
            assert not _nan_or_negative_zero(x.numpy()), name
        for table in rd.trigram_tables(em):
            assert not _nan_or_negative_zero(table.numpy())
        plan = cuda_duplex.make_plan(_targets_rev(TARGETS), em, params.maxloop)
        for x in (plan.open_col0, plan.close_coll, plan.open_row0, plan.close_rowl):
            assert not _nan_or_negative_zero(x.numpy())


@pytest.mark.parametrize("l1", [14, 50])
def test_plan_call_on_cpu_is_the_plain_version(l1):
    em = _em()
    targets_rev = _targets_rev(TARGETS[:2])
    plan = cuda_duplex.make_plan(targets_rev, em, 16)
    tokens = _tokens(l1 + 2, 5, l1)
    before = cuda_duplex.launch_counts()
    got = cuda_duplex.duplex_energies(tokens, targets_rev, em, 16, plan=plan)
    assert cuda_duplex.launch_counts() == before
    assert torch.equal(got, cuda_duplex.duplex_energies_plain(tokens, targets_rev, em, 16))
    em_j = jrd.DuplexParams.calibrated().energy_model()
    for t in range(2):
        ref = _jax_slab_energies(tokens.numpy().astype(np.int32),
                                 targets_rev[t].numpy().astype(np.int32), em_j, maxloop=16)
        np.testing.assert_array_equal(got[:, t].numpy(), np.asarray(ref))


def test_plan_must_match_the_call():
    em = _em()
    targets_rev = _targets_rev(TARGETS[:1])
    plan = cuda_duplex.make_plan(targets_rev, em, 16)
    tokens = _tokens(0, 2, 14)
    for args in [(targets_rev.clone(), em, 16), (targets_rev, dict(em), 16)]:
        with pytest.raises(ValueError, match="plan was made for other"):
            cuda_duplex.duplex_energies(tokens, *args, plan=plan)


@pytest.mark.parametrize("bad,match", [
    (lambda t, em: (t, em, 2), "maxloop >= 3"),
    (lambda t, em: (t.float(), em, 16), "integer tensor"),
    (lambda t, em: (t[0], em, 16), "integer tensor"),
    (lambda t, em: (torch.zeros((1, 1025), dtype=torch.long), em, 16), "unsupported shapes"),
    (lambda t, em: (t, em, 12), "expected"),
])
def test_make_plan_refuses_what_the_kernel_cannot_take(bad, match):
    with pytest.raises(ValueError, match=match):
        cuda_duplex.make_plan(*bad(_targets_rev(TARGETS[:1]), _em()))


@pytest.mark.parametrize("d", [5, 9, 18])
def test_cost_struct_layout_matches_the_kernel(d):
    struct = cuda_duplex.cost_struct(d)
    assert ctypes.sizeof(struct) == 4 * (d * d + (d - 1) + d)
    assert struct.icost.offset == 0
    assert struct.bseq.offset == 4 * d * d
    assert struct.btgt.offset == 4 * (d * d + d - 1)
    if d == 18:  # static_assert(sizeof(Costs<16>) == 1436) in the kernel source
        assert ctypes.sizeof(struct) == 1436


@pytest.mark.parametrize("maxloop", [3, 7, 16])
def test_plan_host_costs_hold_the_energy_model(maxloop):
    params = rd.DuplexParams.calibrated() if maxloop == 16 else rd.DuplexParams(maxloop=maxloop)
    em = params.energy_model("cpu")
    plan = cuda_duplex.make_plan(_targets_rev(TARGETS[:1]), em, maxloop)
    host = plan.host_costs
    np.testing.assert_array_equal(np.ctypeslib.as_array(host.icost), em["interior_cost"].numpy().ravel())
    np.testing.assert_array_equal(np.ctypeslib.as_array(host.bseq), em["bulge_seq"].numpy())
    np.testing.assert_array_equal(np.ctypeslib.as_array(host.btgt), em["bulge_tgt"].numpy())
    for name in ("interior_cost", "bulge_seq", "bulge_tgt"):
        assert torch.equal(getattr(plan, name), em[name])


def test_landscape_builds_one_plan_and_keeps_the_jax_fitness():
    problem = jax_rna.registry()["L50_RNA2+3"]["params"]
    port = rna.RNABinding(**problem, device="cpu")
    fn, params = port.device_fitness()
    assert params.plan.em is port.params.energy_model("cpu")
    assert params.plan.n_targets == 2 and params.plan.l2 == 100
    tokens = _tokens(11, 6, 50)
    before = cuda_duplex.launch_counts()
    got = fn(params, tokens)
    assert cuda_duplex.launch_counts() == before
    ref = jax_rna.RNABinding(**problem)
    np.testing.assert_array_equal(port.norm_values, ref.norm_values)
    jfn, jparams = ref.device_fitness()
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jfn(jparams, tokens.numpy().astype(np.int32))),
        rtol=1e-6, atol=1e-7,
    )
