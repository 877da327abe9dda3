"""The port's sweep CLI (`flexs-tpu-torch-sweep`) on the CPU.

The three cases of tests/test_cli.py with `--device cpu`: the shared-table
fast path (on its default one-rank mesh), the generic path with
checkpoints, whose rerun resumes from them and reproduces the CSV exactly,
and `--surrogate-arch gp`.  Then the fast path against the JAX package's
CLI on the same grid: the same columns, cells and start fitness.  The
proposals are drawn from `torch.Generator` in the port and `jax.random`
in the JAX package, so max fitness and the costs are each package's own
(on the fast-path case's one cell, JAX gives max fitness 0.55021, model
cost 40, landscape cost 31; the port 0.855121, 45, 41).
"""
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from flexs_tpu import cli as jax_cli
from flexs_tpu_torch import cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FAST = [
    "--landscapes", "SIX6_REF_R1",
    "--starts", "1",
    "--signal-strengths", "1.0",
    "--rounds", "2",
    "--batch", "5",
    "--queries", "20",
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel worker processes."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def test_cli_fast_path(tmp_path, capsys):
    out = str(tmp_path / "sweep.csv")
    assert cli.main(FAST + ["--out", out, "--device", "cpu"]) == 0
    df = pd.read_csv(out)
    assert len(df) == 1
    assert (df["max_fitness"] >= df["start_fitness"]).all()
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == ("sweep: 1 landscapes x 1 starts x 1 signal strengths x 1 seeds = "
                        "1 cells on 1 device(s)")
    assert lines[1].startswith("done in ") and "mean max fitness" in lines[1]


def test_cli_generic_path_with_checkpoint(tmp_path):
    out = str(tmp_path / "sweep.csv")
    ckpt = str(tmp_path / "ckpt")
    argv = [
        "--landscapes", "SIX6_REF_R1",
        "--starts", "2",
        "--signal-strengths", "1.0",
        "--seeds", "0", "1",
        "--rounds", "2",
        "--batch", "5",
        "--queries", "20",
        "--algorithm", "ga",
        "--chunk-size", "2",
        "--checkpoint-dir", ckpt,
        "--no-mesh",
        "--out", out,
        "--device", "cpu",
    ]
    assert cli.main(argv) == 0
    df1 = pd.read_csv(out)
    assert len(df1) == 4
    assert list(df1["landscape"].unique()) == ["SIX6_REF_R1"]
    assert sorted(f for f in os.listdir(ckpt) if f.endswith(".npz")) == [
        "chunk_00000.npz",
        "chunk_00001.npz",
    ]
    mtimes = {f: os.stat(os.path.join(ckpt, f)).st_mtime_ns for f in os.listdir(ckpt)}
    # The rerun resumes from the checkpoints and reproduces the summary.
    assert cli.main(argv) == 0
    assert pd.read_csv(out).equals(df1)
    assert {f: os.stat(os.path.join(ckpt, f)).st_mtime_ns for f in os.listdir(ckpt)} == mtimes


def test_cli_surrogate_arch_flag(tmp_path):
    """--model surrogate --surrogate-arch gp sweeps the exact-GP family."""
    out = str(tmp_path / "sweep.csv")
    rc = cli.main(
        [
            "--landscapes", "SIX6_REF_R1",
            "--starts", "1",
            "--rounds", "2",
            "--batch", "5",
            "--queries", "20",
            "--algorithm", "gpr_bo",
            "--model", "surrogate",
            "--surrogate-arch", "gp",
            "--no-mesh",
            "--out", out,
            "--device", "cpu",
        ]
    )
    assert rc == 0
    df = pd.read_csv(out)
    assert len(df) == 1
    assert (df["max_fitness"] >= df["start_fitness"]).all()


def test_cli_fast_path_against_the_jax_cli(tmp_path):
    """Same flags, same summary: columns, dtypes, cells and start fitness."""
    argv = FAST + ["--starts", "2", "--signal-strengths", "0.5", "1.0", "--no-mesh"]
    jax_out, port_out = str(tmp_path / "jax.csv"), str(tmp_path / "port.csv")
    assert jax_cli.main(argv + ["--out", jax_out]) == 0
    assert cli.main(argv + ["--out", port_out, "--device", "cpu"]) == 0
    want, got = pd.read_csv(jax_out), pd.read_csv(port_out)
    assert list(got.columns) == list(want.columns)
    assert list(got.dtypes) == list(want.dtypes)
    cells = ["landscape", "start", "signal_strength", "seed"]
    pd.testing.assert_frame_equal(got[cells], want[cells])
    np.testing.assert_allclose(got["start_fitness"], want["start_fitness"], rtol=0, atol=1e-6)
    assert (got["max_fitness"] >= got["start_fitness"]).all()
    assert (got["model_cost"] > 0).all() and (got["landscape_cost"] > 2 * 5).all()


def test_cli_surrogate_gp_ensemble_is_refused(tmp_path):
    with pytest.raises(SystemExit):
        cli.main(FAST + ["--model", "surrogate", "--surrogate-arch", "gp",
                         "--surrogate-ensemble", "2", "--no-mesh", "--device", "cpu"])


def test_cli_under_torchrun_equals_one_process(tmp_path):
    """Two ranks over torchrun's rendezvous gather the one-process CSV; rank 0 writes it."""
    argv = FAST + ["--starts", "2", "--seeds", "0", "1", "--device", "cpu"]
    one = str(tmp_path / "one.csv")
    assert cli.main(argv + ["--no-mesh", "--out", one]) == 0
    two = str(tmp_path / "two.csv")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(filter(None, (
        ROOT, os.environ.get("PYTHONPATH"))))}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "flexs_tpu_torch.cli", *argv, "--out", two],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.count("4 cells on 2 device(s)") == 2
    assert proc.stdout.count(f"wrote {two}") == 1
    with open(one) as a, open(two) as b:
        assert a.read() == b.read()
