"""The PyTorch fused Adalead + NAM runner, on RNABinding L14_RNA1.

The runner draws from a torch Generator, which cannot replay the JAX
package's random streams, so it is held to the invariants the JAX runner's
tests pin and to the JAX package's golden quality band.
"""
import json

import numpy as np
import pytest
import torch

import flexs_tpu
import flexs_tpu_torch as flexs
from flexs_tpu_torch.runtime import DeviceAdaleadNAM, jit_runner


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel worker processes."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


PROBLEM = flexs.landscapes.rna.registry()["L14_RNA1"]
START = PROBLEM["starts"][1]


@pytest.fixture(scope="module")
def landscape():
    return flexs.landscapes.RNABinding(**PROBLEM["params"], device="cpu")


def _run(landscape, **kw):
    kw.setdefault("rounds", 3)
    kw.setdefault("sequences_batch_size", 5)
    kw.setdefault("model_queries_per_batch", 20)
    runner = DeviceAdaleadNAM(
        landscape,
        flexs.RNAA,
        starting_sequence=START,
        signal_strength=kw.pop("signal_strength", 0.9),
        seed=kw.pop("seed", 0),
        device="cpu",
        **kw,
    )
    return runner.run(verbose=False)


def test_schema_and_round_structure(landscape):
    df, meta = _run(landscape)
    assert list(df.columns) == [
        "sequence", "model_score", "true_score", "round", "model_cost",
        "measurement_cost",
    ]
    assert df["round"].max() == 3
    r0 = df[df["round"] == 0]
    assert len(r0) == 1 and r0["sequence"].iloc[0] == START
    assert np.isnan(r0["model_score"].iloc[0])
    for r in range(1, 4):
        assert 0 < len(df[df["round"] == r]) <= 5
    assert meta["model_name"] == "NAMb_ss0.9"


def test_no_sequence_measured_twice(landscape):
    df, _ = _run(landscape)
    assert df["sequence"].is_unique


def test_costs_monotone_and_budgeted(landscape):
    df, _ = _run(landscape)
    per_round = df.groupby("round")["model_cost"].first()
    assert per_round.is_monotonic_increasing
    # Each round uses at most budget + one extra root batch of queries.
    assert (np.diff(per_round.to_numpy()) <= 20 + 5).all()


def test_true_scores_match_both_landscapes(landscape):
    df, _ = _run(landscape)
    seqs = df["sequence"].tolist()
    np.testing.assert_allclose(
        df["true_score"].to_numpy(), landscape._fitness_function(seqs), atol=1e-6
    )
    jax_landscape = flexs_tpu.landscapes.RNABinding(**PROBLEM["params"])
    np.testing.assert_allclose(
        df["true_score"].to_numpy(), jax_landscape.get_fitness(seqs), atol=1e-6
    )


def test_landscape_cost_synced(landscape):
    before = landscape.cost
    df, _ = _run(landscape)
    # Start + measurements + 2 per new NAM query: at least one per row.
    assert landscape.cost - before >= len(df)


def test_ss1_model_scores_are_truth(landscape):
    df, _ = _run(landscape, signal_strength=1.0)
    prop = df[df["round"] > 0]
    np.testing.assert_allclose(
        prop["model_score"].to_numpy(), prop["true_score"].to_numpy(), atol=1e-5
    )


def test_seed_determinism(landscape):
    df1, _ = _run(landscape, seed=7)
    df2, _ = _run(landscape, seed=7)
    assert (df1["sequence"] == df2["sequence"]).all()
    np.testing.assert_array_equal(
        df1["model_score"].to_numpy()[1:], df2["model_score"].to_numpy()[1:]
    )


def test_log_file_format(landscape, tmp_path):
    log = tmp_path / "run.csv"
    runner = DeviceAdaleadNAM(
        landscape, flexs.RNAA, rounds=2, sequences_batch_size=5,
        model_queries_per_batch=20, starting_sequence=START, log_file=str(log),
        device="cpu",
    )
    df, _ = runner.run(verbose=False)
    lines = log.read_text().splitlines()
    meta = json.loads(lines[0])
    assert meta["landscape_name"] == landscape.name
    assert meta["exp_name"] == "DeviceAdalead_mu=1_threshold=0.05"
    assert lines[1].split(",") == [
        "sequence", "model_score", "true_score", "round", "model_cost",
        "measurement_cost",
    ]
    assert len(lines) == 2 + len(df)


def test_perfect_model_mode(landscape):
    """model='perfect': predictions equal truth; landscape cost = measured."""
    cost_before = landscape.cost
    df, meta = _run(landscape, model="perfect")
    prop = df[df["round"] > 0]
    np.testing.assert_allclose(
        prop["model_score"].to_numpy(), prop["true_score"].to_numpy(), atol=1e-5
    )
    assert meta["model_name"].startswith("LandscapeAsModel=")
    assert landscape.cost - cost_before == len(df)


def test_invalid_and_unported_modes_raise(landscape):
    kw = dict(rounds=1, sequences_batch_size=5, model_queries_per_batch=20,
              starting_sequence=START, device="cpu")
    with pytest.raises(ValueError):
        DeviceAdaleadNAM(landscape, flexs.RNAA, model="bogus", **kw)
    with pytest.raises(ValueError, match="unknown surrogate arch"):
        DeviceAdaleadNAM(landscape, flexs.RNAA, model="surrogate",
                         surrogate_spec=flexs.runtime.surrogate.SurrogateSpec(arch="tree"), **kw)
    # The exact GP (item 15's last arch) is ported: it no longer raises.
    gp = flexs.runtime.surrogate.SurrogateSpec(arch="gp")
    runner = DeviceAdaleadNAM(landscape, flexs.RNAA, model="surrogate", surrogate_spec=gp, **kw)
    assert runner.model_name == "gaussian_process"


def test_default_device_without_card_raises(landscape):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceAdaleadNAM(
            landscape, flexs.RNAA, rounds=1, sequences_batch_size=5,
            model_queries_per_batch=20, starting_sequence=START,
        )


@pytest.mark.parametrize("signal_strength", [0.9, 1.0])
def test_golden_band_l14_rna1(landscape, signal_strength):
    """The band of tests/test_generic_sweep.py's golden test (reference
    demo: max fitness 0.89-1.06 at 5 rounds x 100 x 1000 queries)."""
    df, _ = _run(
        landscape, rounds=5, sequences_batch_size=50, model_queries_per_batch=500,
        signal_strength=signal_strength,
    )
    assert 0.8 < df["true_score"].max() < 1.2


def test_profile_spans_wrap_the_run(landscape):
    """Every span of the profile script resolves and sees calls in a run; on
    the CPU the kernel-only span (launch_plan) is the only silent one."""
    from flexs_tpu_torch import profile_main_path

    calls = dict.fromkeys(profile_main_path.SPANS, 0)

    def counted(label, fn):
        def wrapper(*args, **kwargs):
            calls[label] += 1
            return fn(*args, **kwargs)

        return wrapper

    originals = {label: getattr(*where) for label, where in profile_main_path.SPANS.items()}
    with profile_main_path.spans_installed(counted):
        _run(landscape, rounds=1)
    assert {label: getattr(*where) for label, where in profile_main_path.SPANS.items()} == originals
    assert [label for label, n in calls.items() if n == 0] == ["duplex.launch_plan"]


def test_profile_round_hook_sees_every_round(landscape):
    """The profile script's window opens at a round the run really reaches,
    and the hook leaves the runner as it found it."""
    from flexs_tpu_torch import profile_main_path

    original = jit_runner._Run.round
    seen = []
    with profile_main_path.before_each_round(seen.append):
        _run(landscape, rounds=3)
    assert jit_runner._Run.round is original
    assert seen == [0, 1, 2]
    assert 0 <= profile_main_path.ROUNDS - profile_main_path.PROFILED_ROUNDS < profile_main_path.ROUNDS


def test_golden_band_six6_ref_r1():
    """TF-Bind-8 SIX6_REF_R1 at the JAX test's configuration
    (tests/test_jit_runner.py:96-108: 5 rounds x 50 x 500, top > 0.95)."""
    from flexs_tpu_torch.landscapes import tf_binding

    landscape = flexs.landscapes.TFBinding(name="SIX6_REF_R1", device="cpu")
    df, _ = DeviceAdaleadNAM(
        landscape, flexs.DNAA, rounds=5, sequences_batch_size=50,
        model_queries_per_batch=500, starting_sequence=tf_binding.STARTS[0],
        signal_strength=0.9, seed=0, device="cpu",
    ).run(verbose=False)
    assert df["true_score"].max() > 0.95
    assert df["sequence"].is_unique
    np.testing.assert_array_equal(
        df["true_score"].to_numpy(), landscape._fitness_function(df["sequence"].tolist())
    )


def test_cells_equal_single_runs(landscape):
    """Three cells in lockstep equal three single runs, field for field."""
    from flexs_tpu_torch.runtime.jit_runner import (
        AdaleadConfig, cell_axis_oracle, run_adalead_nam, run_adalead_nam_cells,
    )

    cfg = AdaleadConfig(rounds=3, sequences_batch_size=5, model_queries_per_batch=20,
                        alphabet_size=4)
    fn, params = landscape.device_fitness()
    alphabet = flexs.Alphabet(flexs.RNAA)
    starts = [PROBLEM["starts"][k] for k in (1, 2, 3)]
    signal_strengths, seeds = [0.9, 0.5, 1.0], [0, 1, 2]

    def gen(seed):
        g = torch.Generator()
        g.manual_seed(seed)
        return g

    tokens = torch.as_tensor(alphabet.encode(starts))
    cells = run_adalead_nam_cells(
        cell_axis_oracle(fn), params, tokens, cfg, signal_strengths,
        [gen(s) for s in seeds],
    )
    for c in range(3):
        single = run_adalead_nam(fn, params, tokens[c], cfg, signal_strengths[c], gen(seeds[c]))
        for name, got, want in zip(single._fields, cells, single):
            assert torch.equal(got[c], want), (c, name)
