"""`flexs_tpu_torch.tutorial` on the CPU at small sizes, against examples/tutorial.py's steps.

Every step runs and prints its line; the start's fitness equals the JAX
package's `get_fitness`; the checkpointed sweep resumed from its chunks
equals the sweep that wrote them.
"""
import contextlib
import io
import os
import subprocess
import sys

import pandas as pd
import pytest
import torch

import flexs_tpu
from flexs_tpu_torch import tutorial

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {step: dict(rounds=1, sequences_batch_size=10, model_queries_per_batch=50)
         for step in tutorial.SIZES}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel worker processes."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


@pytest.fixture(scope="module")
def small_run():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        readings = tutorial.main(device="cpu", **SMALL)
    return readings, out.getvalue()


def test_every_step_runs_and_prints(small_run):
    readings, text = small_run
    for line in ("TF-Bind-8 SIX6_REF_R1; start", "Adalead+NAM: top fitness", "CMAES: top fitness",
                 "robustness ss=0.5: top", "robustness ss=1.0: top", "fused device runner: top",
                 "fused CNN-surrogate runner: top", "sweep summary:",
                 "checkpointed GA sweep (resumed):"):
        assert line in text, line
    for step in ("adalead", "cmaes", "fused", "fused_cnn"):
        df = readings[step]
        assert df["round"].max() == 1 and (df["true_score"] <= 1).all(), step
    assert [ss for ss, _ in readings["robustness"]] == [0.5, 1.0]
    assert len(readings["sweep"]) == 4  # 2 starts x 2 signal strengths
    assert len(readings["ensemble"].models) == 1


def test_start_fitness_equals_jax(small_run):
    problem = flexs_tpu.landscapes.tf_binding.registry()["SIX6_REF_R1"]
    landscape = flexs_tpu.landscapes.TFBinding(**problem["params"])
    want = float(landscape.get_fitness([problem["starts"][0]])[0])
    assert small_run[0]["start_fitness"] == want


def test_resumed_sweep_equals_the_computed_one(small_run):
    readings, _ = small_run
    assert len(readings["resumed"]) == 2
    pd.testing.assert_frame_equal(readings["resumed"], readings["checkpointed"])


def test_sizes_default_to_the_tutorials():
    assert tutorial.SIZES["adalead"] == dict(rounds=5, sequences_batch_size=50,
                                             model_queries_per_batch=500)
    assert tutorial.SIZES["checkpointed"] == dict(rounds=2, sequences_batch_size=10,
                                                  model_queries_per_batch=50)


def test_without_a_card_exits_nonzero():
    """No card and no --cpu: it raises before printing any line."""
    proc = subprocess.run([sys.executable, "-m", "flexs_tpu_torch.tutorial"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "torch.cuda.is_available() is False" in proc.stderr
