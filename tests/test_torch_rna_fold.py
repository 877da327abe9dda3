"""The port's Zuker fold DP and RNAFolding held against the JAX package.

Inputs are those of tests/test_rna_fold.py (numpy-seeded rows and the
structural sequences), grouped by length so that JAX compiles each length
once.  The port adds every structure's terms in JAX's order, so the MFEs
agree to the bit; the tests hold them to atol 1e-5 (the largest difference
seen is 0).
"""
import numpy as np
import pandas as pd
import pytest
import torch

import flexs_tpu
import flexs_tpu_torch
from flexs_tpu.ops import rna_fold as jax_fold
from flexs_tpu_torch.landscapes import rna
from flexs_tpu_torch.ops import rna_fold

ATOL = 1e-5
_RNA = flexs_tpu_torch.Alphabet(flexs_tpu_torch.RNAA)


def _enumeration_rows(length, seed):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 4, size=(3, length)).astype(np.int32)
    rows[0, : length // 2] = _RNA.encode_one("G" * (length // 2))
    rows[0, length // 2:] = _RNA.encode_one("C" * (length - length // 2))
    return rows


def _zuker_rows(length):
    rng = np.random.default_rng(length)
    toks = rng.integers(0, 4, size=(6, length)).astype(np.int32)
    toks[0, : length // 3] = _RNA.encode_one("G" * (length // 3))
    toks[0, -(length // 3):] = _RNA.encode_one("C" * (length // 3))
    toks[1, : length // 4] = _RNA.encode_one("GC" * (length // 8) + "G" * (length // 4 % 2))
    return toks


_ARM = "GGGGAAAACCCC"
_TWO_ARMS = "CCCCAAAAGGGG" + "AA" + "GGGGAAAACCCC"
STRUCTURAL = [
    *("GGGGGG" + "A" * n + "CCCCCC" for n in (4, 8, 16, 30)),  # hairpin sizes
    "GGGGG" + "AAAA" + "CCCCC", "GGG" + "A" + "GG" + "AAAA" + "CCCCC",  # bulge
    _TWO_ARMS, "GGGGG" + "A" + _TWO_ARMS + "A" + "CCCCC",  # multiloop
    _ARM + "AA" + _ARM, "GGGGG" + "A" + _ARM + "AA" + _ARM + "A" + "CCCCC",
    *("G" * n + "AAAA" + "C" * n for n in (3, 5, 7)),  # stem length
    "A" * 20, "GCAAGC", "GGGAAACCC", "GGGAACCC",  # unpairable, min hairpin
    "GGGC" + "UUCG" + "GCCC", "GGGC" + "AUCG" + "GCCC",  # tetraloop
    "GGGGC" + "AAC" + "GCCCC",  # triloop
    "A" + "GGGGG" + "AAAA" + "CCCCC" + "A",  # exterior dangles
    "GGGGGGAAAACCCCCC",
]


def _cases():
    """length -> int32[B, length] rows, every input of tests/test_rna_fold.py."""
    by_len = {}
    for length, seed in [(8, 0), (10, 1), (11, 2), (12, 3)]:
        by_len.setdefault(length, []).extend(_enumeration_rows(length, seed))
    for length in (10, 16, 24, 31):
        by_len.setdefault(length, []).extend(_zuker_rows(length))
    for seq in STRUCTURAL:
        by_len.setdefault(len(seq), []).append(_RNA.encode_one(seq))
    return {length: np.stack(rows).astype(np.int32) for length, rows in sorted(by_len.items())}


CASES = _cases()


@pytest.fixture(scope="module")
def em_jax():
    return jax_fold.fold_energy_model()


@pytest.fixture(scope="module")
def em():
    return rna_fold.fold_energy_model(device="cpu")


def test_energy_model_equals_jax(em, em_jax):
    assert sorted(em) == sorted(em_jax)
    for key, value in em_jax.items():
        np.testing.assert_array_equal(em[key].numpy(), np.asarray(value), err_msg=key)
    for name in ("HAIRPIN_INIT", "ML_CLOSING", "ML_BRANCH", "ML_UNPAIRED", "_MAX_HAIRPIN_TABLE"):
        assert getattr(rna_fold, name) == getattr(jax_fold, name), name
    np.testing.assert_array_equal(rna_fold._REV_PT, jax_fold._REV_PT)
    np.testing.assert_array_equal(rna_fold._interior_windows(16), jax_fold._interior_windows(16))


def test_contraction_matrices_equal_jax(em, em_jax):
    mats, jax_mats = rna_fold._contraction_mats(em), jax_fold._contraction_mats(em_jax)
    assert sorted(mats) == sorted(jax_mats)
    for key, value in jax_mats.items():
        np.testing.assert_array_equal(mats[key].numpy(), np.asarray(value), err_msg=key)


@pytest.mark.parametrize("length", sorted(CASES))
def test_zuker_mfe_batch_matches_jax(em, em_jax, length):
    rows = CASES[length]
    want = np.asarray(jax_fold.zuker_mfe_batch(rows, em_jax))
    got = rna_fold.zuker_mfe_batch(torch.as_tensor(rows), em)
    assert got.dtype == torch.float32 and got.shape == (len(rows),)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_zuker_mfe_is_one_row_of_the_batch(em):
    rows = torch.as_tensor(CASES[16])
    batch = rna_fold.zuker_mfe_batch(rows, em)
    assert torch.equal(rna_fold.zuker_mfe(rows[0], em), batch[0])


def test_maxloop_and_min_hairpin_match_jax(em, em_jax):
    rows = CASES[24]
    for maxloop, min_hairpin in ((4, 3), (8, 3), (16, 4)):
        want = np.asarray(jax_fold.zuker_mfe_batch(rows, em_jax, maxloop, min_hairpin))
        got = rna_fold.zuker_mfe_batch(torch.as_tensor(rows), em, maxloop, min_hairpin)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL,
                                   err_msg=f"maxloop {maxloop}, min_hairpin {min_hairpin}")
    with pytest.raises(ValueError, match="maxloop"):
        rna_fold.zuker_mfe_batch(torch.as_tensor(rows), em, maxloop=17)


def test_perturbed_energy_model_matches_jax(em, em_jax):
    """The DP reads every table from `em` (a multiloop-closing perturbation)."""
    rows = CASES[38]
    em_hi = dict(em, consts=em["consts"] + torch.tensor([0.5, 0, 0, 0]))
    em_jax_hi = dict(em_jax, consts=em_jax["consts"] + np.array([0.5, 0, 0, 0], np.float32))
    want = np.asarray(jax_fold.zuker_mfe_batch(rows, em_jax_hi))
    got = rna_fold.zuker_mfe_batch(torch.as_tensor(rows), em_hi)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("knockout", [k for k in rna_fold.KNOCKOUTS if k])
def test_knockout_matches_jax_profile_knob(em, em_jax, knockout):
    """The argument leaves out what JAX's trace-time global leaves out."""
    rows = CASES[16]
    jax_fold._PROFILE_KNOCKOUT = knockout
    jax_fold.zuker_mfe.clear_cache()
    try:
        want = np.asarray(jax_fold.zuker_mfe_batch(rows, em_jax))
    finally:
        jax_fold._PROFILE_KNOCKOUT = None
        jax_fold.zuker_mfe.clear_cache()
    got = rna_fold.zuker_mfe_batch(torch.as_tensor(rows), em, knockout=knockout)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_knockout_is_an_argument_not_a_global(em):
    assert not any("KNOCKOUT" in name and name != "KNOCKOUTS" for name in vars(rna_fold))
    rows = torch.as_tensor(CASES[16])
    full = rna_fold.zuker_mfe_batch(rows, em)
    assert not torch.equal(rna_fold.zuker_mfe_batch(rows, em, knockout="interior"), full)
    assert torch.equal(rna_fold.zuker_mfe_batch(rows, em), full)
    with pytest.raises(ValueError, match="knockout"):
        rna_fold.zuker_mfe_batch(rows, em, knockout="stack")


def test_empty_batch(em):
    assert rna_fold.zuker_mfe_batch(torch.zeros((0, 12), dtype=torch.long), em).shape == (0,)


@pytest.fixture(scope="module")
def landscapes():
    return rna.RNAFolding(norm_value=2.5, device="cpu"), flexs_tpu.landscapes.RNAFolding(2.5)


def test_rna_folding_fitness_matches_jax(landscapes):
    land, jax_land = landscapes
    assert land.name == jax_land.name == "RNAFolding"
    # Mixed lengths: folded one batch per length, results in input order.
    seqs = ["GGGGGGAAAACCCCCC", "GGGGAAAACCCC", "A" * 16, "GGGGGAAAACCCCC", "GGGGAAAACCCC"]
    np.testing.assert_allclose(land.get_fitness(seqs), jax_land.get_fitness(seqs),
                               rtol=0, atol=ATOL)
    assert land.cost == len(seqs)
    fn, params = land.device_fitness()
    jax_fn, jax_params = jax_land.device_fitness()
    rows = CASES[16]
    got = fn(params, torch.as_tensor(rows).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_fn(jax_params, rows)),
                               rtol=0, atol=ATOL)
    assert torch.equal(land.fitness_from_tokens(rows), got)


def test_every_instance_shares_one_fitness_fn():
    a, b = rna.RNAFolding(device="cpu"), rna.RNAFolding(norm_value=3, device="cpu")
    assert a.device_fitness()[0] is b.device_fitness()[0]


def _runner_kw():
    return dict(rounds=2, sequences_batch_size=5, model_queries_per_batch=20,
                signal_strength=0.9, device="cpu")


def test_fused_run_true_score_is_get_fitness(landscapes):
    land, _ = landscapes
    start = "GGGGGGAAAACCCCCC"
    df, _ = flexs_tpu_torch.runtime.DeviceAdaleadNAM(
        land, flexs_tpu_torch.RNAA, starting_sequence=start, seed=0, **_runner_kw()
    ).run(verbose=False)
    assert df["round"].max() == 2 and df["sequence"].iloc[0] == start
    assert df["sequence"].is_unique and (df[df["round"] > 0]["model_cost"] > 0).all()
    np.testing.assert_array_equal(df["true_score"].to_numpy(),
                                  land.get_fitness(df["sequence"].tolist()))


def test_lockstep_sweep_cells_equal_standalone_runs():
    from flexs_tpu_torch.parallel import run_landscape_robustness_sweep

    land = rna.RNAFolding(device="cpu")
    starts = ["GGGGGGAAAACCCCCC", "GGGCUUCGGCCCAAAA"]
    kw = _runner_kw()
    ss = kw.pop("signal_strength")
    sweep = run_landscape_robustness_sweep([land], flexs_tpu_torch.RNAA, starts, [ss],
                                           seeds=[1], cell_mode="vmap", **kw)
    for row in sweep.itertuples():
        single_land = rna.RNAFolding(device="cpu")
        single, _ = flexs_tpu_torch.runtime.DeviceAdaleadNAM(
            single_land, flexs_tpu_torch.RNAA, starting_sequence=row.start, seed=1,
            signal_strength=ss, **kw,
        ).run(verbose=False)
        assert row.max_fitness == single["true_score"].max()
        assert row.model_cost == single["model_cost"].iloc[-1]
        assert row.landscape_cost == single_land.cost


def test_host_run_reproduces_jax_row_for_row():
    """Adalead + NoisyAbstractModel on RNAFolding, seeded alike in both packages."""
    start = "GGGGGGAAAACCCCCC"

    def run(pkg, **device):
        land = pkg.landscapes.RNAFolding(**device)
        model = pkg.baselines.models.NoisyAbstractModel(land, 0.9, seed=0, **device)
        df, _ = pkg.baselines.explorers.Adalead(
            model, rounds=2, sequences_batch_size=8, model_queries_per_batch=40,
            starting_sequence=start, alphabet=pkg.RNAA, seed=0,
        ).run(land, verbose=False)
        return df, land.cost

    (df, cost), (df_jax, cost_jax) = run(flexs_tpu_torch, device="cpu"), run(flexs_tpu)
    assert cost == cost_jax
    assert df["sequence"].tolist() == df_jax["sequence"].tolist()
    pd.testing.assert_frame_equal(df[["round", "model_cost", "measurement_cost"]],
                                  df_jax[["round", "model_cost", "measurement_cost"]])
    for col in ("true_score", "model_score"):
        np.testing.assert_allclose(df[col].to_numpy(), df_jax[col].to_numpy(), atol=1e-6)
