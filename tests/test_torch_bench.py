"""The port's measurement entry points on the CPU, at small sizes, against the JAX package.

`flexs_tpu_torch.bench`, `bench_sweep`, `bench_fold` and `bench_surrogate`
are the counterparts of `bench.py` and `scripts/bench_{sweep,fold,
surrogate}.py`.  The root `bench.py` is read with `ast`, never imported: on
import it points JAX's persistent compilation cache at the repository.

What can be held exactly is: the final line's keys, the flags, the sweep's
cells in order and each cell's start fitness, the duplex energies and the
fold's MFEs.  A sweep cell's `model_cost` and `landscape_cost` and its
`max_fitness` follow the random stream, which the port cannot replay from
`jax.random`; they are held to bands that follow from the Adalead round
(see `test_sweep_stage_cells_equal_jax`).
"""
import ast
import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from flexs_tpu_torch import bench, bench_fold, bench_surrogate, bench_sweep

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(rounds=2, sequences_batch_size=10, model_queries_per_batch=50)
SIZES = {
    "single_run": dict(seeds=(1,), **SMALL),
    "sweep": dict(n_landscapes=2, warmup_landscapes=1, reps=1, chunk_size=5, **SMALL),
    "eval_sweeps": dict(n_landscapes=1, budgets=((10, 50), (5, 20)), rounds=2, num_rounds=(1, 2),
                        reps=1, total_ground_truth_measurements=20, total_model_queries=100),
    "surrogate_sweep": dict(n_starts=1, seeds=(0,), reps=1, **SMALL),
    "rna_oracle": dict(batch=2, reps=1),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel worker processes."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def _tree(relpath):
    with open(os.path.join(ROOT, relpath)) as f:
        return ast.parse(f.read())


def _functions(tree):
    return {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}


def _bench_py_final_keys():
    """The keys of bench.py's last line, in order, its `**` parts expanded."""
    funcs = _functions(_tree("bench.py"))
    dicts = [n for n in ast.walk(funcs["main"]) if isinstance(n, ast.Dict)]
    final = max(dicts, key=lambda d: len(d.keys))
    keys = [k.value for k in final.keys if k is not None]
    # **eval_metrics: out[f"{label}_..."] for each label of the loop.
    eval_fn = funcs["run_eval_sweeps"]
    loop = next(n for n in ast.walk(eval_fn) if isinstance(n, ast.For))
    labels = [elt.elts[0].value for elt in loop.iter.elts]
    suffixes = [n.slice.values[1].value for n in ast.walk(eval_fn)
                if isinstance(n, ast.Subscript) and isinstance(n.slice, ast.JoinedStr)]
    keys += [label + suffix for label in labels for suffix in suffixes]
    # **surr_metrics: the dict run_surrogate_sweep returns.
    ret = [n for n in ast.walk(funcs["run_surrogate_sweep"]) if isinstance(n, ast.Return)][-1]
    return keys + [k.value for k in ret.value.keys]


def _option_strings(relpath):
    tree = _tree(relpath)
    return [a.value for n in ast.walk(tree)
            if isinstance(n, ast.Call) and getattr(n.func, "attr", None) == "add_argument"
            for a in n.args if isinstance(a, ast.Constant)]


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


@pytest.fixture(scope="module")
def small_bench():
    """(last line, {stage: what it computed}, printed text) of every stage at SIZES."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        line, data = bench.run_all(device="cpu", sizes=SIZES)
    return line, data, out.getvalue()


def test_final_line_keys_and_stage_lines(small_bench):
    """bench.py's keys, one renamed, plus baseline_hardware and card; each stage's line."""
    line, _, printed = small_bench
    want = _bench_py_final_keys()
    assert "pallas_bitexact_vs_xla" in want and "surrogate_sweep_cells" in want
    want[want.index("pallas_bitexact_vs_xla")] = "duplex_kernel_bitexact_vs_plain"
    want.insert(want.index("vs_baseline") + 1, "baseline_hardware")
    assert list(line) == want + ["card"]
    assert line["card"] == "cpu"
    assert line["duplex_kernel_bitexact_vs_plain"] is True
    assert line["value"] > 0 and line["sweep_cells"] == 10 and line["surrogate_sweep_cells"] == 1
    with open(os.path.join(ROOT, "BASELINE_MEASURED.json")) as f:
        record = json.load(f)
    assert line["baseline_hardware"] == record["hardware"]
    assert abs(line["vs_baseline"] - line["value"] / record["seqs_per_sec"]) <= 0.0051

    stages = _json_lines(printed)
    assert [s["stage"] for s in stages] == list(bench.STAGE_KEYS)
    for s in stages:
        assert list(s) == ["stage", *bench.STAGE_KEYS[s["stage"]], "stage_wall_s", "card"], s
        assert s["stage_wall_s"] > 0
        for key, value in s.items():
            if key not in ("stage", "stage_wall_s", "card", *bench.STAGE_ONLY_KEYS):
                assert line[key] == value, key
    assert stages[3]["surrogate_sweep_cell_mode"] == "map"


@pytest.mark.parametrize("port, script", [
    ("flexs_tpu_torch/bench.py", "bench.py"),
    ("flexs_tpu_torch/bench_sweep.py", "scripts/bench_sweep.py"),
    ("flexs_tpu_torch/bench_fold.py", "scripts/bench_fold.py"),
    ("flexs_tpu_torch/bench_surrogate.py", "scripts/bench_surrogate.py"),
])
def test_flags_equal_the_jax_scripts(port, script):
    assert _option_strings(port) == _option_strings(script)


@pytest.mark.parametrize("port, script", [
    ("flexs_tpu_torch/bench.py", "bench.py"),
    ("flexs_tpu_torch/bench_sweep.py", "scripts/bench_sweep.py"),
    ("flexs_tpu_torch/bench_fold.py", "scripts/bench_fold.py"),
    ("flexs_tpu_torch/bench_surrogate.py", "scripts/bench_surrogate.py"),
])
def test_functions_of_the_jax_scripts_are_kept(port, script):
    """Every public function of a script is in its port (bench.py's preflight is not ported)."""
    want = {name for name in _functions(_tree(script)) if not name.startswith("_")}
    assert want <= set(_functions(_tree(port)))


def test_sweep_stage_cells_equal_jax(small_bench):
    """The sweep stage's cells, in order, against flexs_tpu's sweep with the same arguments.

    Exact: (landscape, start, signal strength, seed) in order and each
    cell's start fitness.  Bands, each checked on the JAX frame too:
    Adalead's round ends once its model queries reach the budget, and only
    a pass's B root queries can cross it (a generation is added only while
    under it), so a round costs [budget, budget + B) model queries;
    max_fitness lies in [start_fitness, 1] (TF-Bind-8 tables are scaled to
    a maximum of 1); the NAM charges the landscape 2 per model query that
    is not yet cached, plus one per measured sequence (at most B a round
    and the start), so landscape_cost lies in (0, 2 model_cost + rounds B + 1].
    """
    from flexs_tpu.landscapes import tf_binding as jax_tf_binding
    from flexs_tpu.parallel import run_robustness_sweep as jax_sweep
    from flexs_tpu_torch.parallel import run_robustness_sweep

    kw = dict(SIZES["sweep"])
    got = small_bench[1]["sweep"]
    n_landscapes = kw.pop("n_landscapes")
    kw.pop("warmup_landscapes")
    kw.pop("reps")
    names, _ = jax_tf_binding._packed_tables()
    args = dict(landscape_names=names[:n_landscapes], starts=jax_tf_binding.STARTS[:1],
                signal_strengths=[0.0, 0.5, 0.75, 0.9, 1.0], **kw)
    want = jax_sweep(**args)
    # The stage passes bench.py's arguments: its frame is the port's sweep's.
    pd.testing.assert_frame_equal(got, run_robustness_sweep(**args, device="cpu"))

    keys = ["landscape", "start", "signal_strength", "seed"]
    pd.testing.assert_frame_equal(got[keys], want[keys])
    assert len(got) == 10
    np.testing.assert_array_equal(got["start_fitness"].to_numpy(),
                                  want["start_fitness"].to_numpy())
    rounds, batch, budget = (kw[k] for k in ("rounds", "sequences_batch_size",
                                             "model_queries_per_batch"))
    for df in (got, want):
        assert df["model_cost"].between(rounds * budget, rounds * (budget + batch) - 1).all()
        assert (df["max_fitness"] >= df["start_fitness"]).all()
        assert (df["max_fitness"] <= 1.0).all()
        assert (df["landscape_cost"] > 0).all()
        assert (df["landscape_cost"] <= 2 * df["model_cost"] + rounds * batch + 1).all()


def test_rna_oracle_energies_equal_jax(small_bench):
    """The stage's energies (the plain version on the CPU) == JAX's slab DP, bitwise."""
    import jax.numpy as jnp

    from flexs_tpu.ops import rna_duplex as jax_rd

    batch = SIZES["rna_oracle"]["batch"]
    energies = small_bench[1]["rna_oracle"]
    # bench.py's draws, in its order: the timed batch, the target, the check batch.
    rng = np.random.default_rng(0)
    rng.integers(0, 4, size=(batch, 100), dtype=np.int32)
    target_rev = jnp.asarray(rng.integers(0, 4, size=100, dtype=np.int32))[::-1]
    check = jnp.asarray(rng.integers(0, 4, size=(64, 100), dtype=np.int32))
    params = jax_rd.DuplexParams.calibrated()
    want = np.asarray(jax_rd.duplex_energy_from_slabs(check, target_rev, params.energy_model(),
                                                      params.maxloop))
    assert energies.shape == (64, 1)
    np.testing.assert_array_equal(energies[:, 0].numpy(), want)


def test_oracle_inputs_are_bench_py_draws():
    """At bench.py's sizes the stage draws bench.py's tokens, target and check batch."""
    tokens, target_rev, check = bench.oracle_inputs(512, 100, "cpu")
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(tokens.numpy(),
                                  rng.integers(0, 4, size=(512, 100), dtype=np.int32))
    np.testing.assert_array_equal(target_rev.numpy()[0],
                                  rng.integers(0, 4, size=100, dtype=np.int32)[::-1])
    np.testing.assert_array_equal(check.numpy(),
                                  rng.integers(0, 4, size=(64, 100), dtype=np.int32))


def test_bench_fold_mfes_equal_jax(capsys):
    import jax.numpy as jnp

    from flexs_tpu.ops import rna_fold as jax_fold

    readings = bench_fold.run(batch=4, lengths=[20], reps=1, device="cpu")
    tokens = np.random.default_rng(0).integers(0, 4, (4, 20)).astype(np.int32)
    want = np.asarray(jax_fold.zuker_mfe_batch(jnp.asarray(tokens), jax_fold.fold_energy_model()))
    np.testing.assert_array_equal(readings[0]["mfe"].numpy(), want)
    assert readings[0]["mean_mfe"] == float(readings[0]["mfe"].mean())
    assert readings[0]["ms_per_batch"] > 0

    assert bench_fold.main(["--cpu", "--batch", "4", "--length", "20", "--reps", "1"]) == 0
    line = _json_lines(capsys.readouterr().out)[-1]
    assert list(line) == ["readings", "reps", "card"] and line["card"] == "cpu"
    assert [r["length"] for r in line["readings"]] == [20]


def test_bench_sweep_line(capsys):
    """scripts/bench_sweep.py's line, plus baseline_hardware and card."""
    assert bench_sweep.main(["--landscapes", "1", "--ss", "2"], device="cpu", **SMALL) == 0
    line = _json_lines(capsys.readouterr().out)[-1]
    funcs = _functions(_tree("scripts/bench_sweep.py"))
    final = max((n for n in ast.walk(funcs["main"]) if isinstance(n, ast.Dict)),
                key=lambda d: len(d.keys))
    assert list(line) == [k.value for k in final.keys] + ["baseline_hardware", "card"]
    assert line["cells"] == 2 and line["value"] > 0 and line["unit"] == "seqs/sec/chip"
    assert bench_sweep.sweep_mesh_and_device("cpu") == (None, torch.device("cpu"))


def test_bench_surrogate_cmaes_line(capsys):
    mean, per_run = bench_surrogate.bench_tfbind_cmaes(
        1, landscapes=("SIX6_REF_R1",), starts_n=1, device="cpu",
        sequences_batch_size=10, model_queries_per_batch=50)
    out = capsys.readouterr().out
    assert "tfbind-cmaes-3cnn SIX6_REF_R1" in out
    line = _json_lines(out)[-1]
    assert line["bench"] == "tfbind_cmaes" and line["runs"] == 1 and line["card"] == "cpu"
    assert line["mean_max"] == mean and line["s_per_run"] == per_run
    assert 0 < mean <= 1


def test_bench_without_a_card_exits_nonzero():
    """No card: the bench raises; it prints no line, and no value-0 line."""
    proc = subprocess.run([sys.executable, "-m", "flexs_tpu_torch.bench"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert _json_lines(proc.stdout) == []
    assert '"value": 0' not in proc.stdout
    assert "torch.cuda.is_available() is False" in proc.stderr
