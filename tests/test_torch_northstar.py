"""`flexs_tpu_torch.bench_northstar` and `aggregate_northstar` on the CPU, against the scripts.

The scripts are loaded from their paths, as tests/test_northstar.py loads
them.  The grid runs at that test's toy sizes in both packages: the lines,
their keys (the port's add `card`), the cells and the summary's sums must
agree; the cells' costs and fitnesses follow the random streams, which the
port cannot replay.  The aggregator, fed a log that the JAX script wrote,
must print what the script prints and write the same artifact, apart
from the port's `card`.
"""
import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys

import pytest
import torch

from flexs_tpu_torch import aggregate_northstar, bench_northstar

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY = ["--families", "random", "adalead", "--landscapes", "2", "--rounds", "2", "--batch", "5",
       "--queries", "20", "--chunk", "4"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel worker processes."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def _load(script):
    spec = importlib.util.spec_from_file_location(
        script + "_script", os.path.join(ROOT, "scripts", script + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed(fn, argv=None):
    """What `fn()` printed, with sys.argv set to `argv` if given."""
    out = io.StringIO()
    saved = sys.argv
    if argv is not None:
        sys.argv = argv
    try:
        with contextlib.redirect_stdout(out):
            fn()
    finally:
        sys.argv = saved
    return out.getvalue()


def _usage(fn):
    def help_():
        with pytest.raises(SystemExit):
            fn()
    return " ".join(_printed(help_, ["prog", "--help"]).split("\n\n")[0].split())


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


@pytest.fixture(scope="module")
def jax_toy():
    """The lines the JAX script prints at the toy sizes."""
    return _printed(_load("bench_northstar").main, ["bench_northstar.py", *TOY])


def test_families_and_flags_equal_the_scripts():
    script = _load("bench_northstar")
    assert bench_northstar.FAMILIES == script.FAMILIES
    assert _usage(lambda: bench_northstar.main(["--help"])) == _usage(script.main)
    assert _usage(lambda: aggregate_northstar.main(["--help"])) == \
        _usage(_load("aggregate_northstar").main)


def test_toy_grid_lines_equal_the_scripts(jax_toy):
    rc = []
    port = _json_lines(_printed(lambda: rc.append(bench_northstar.main([*TOY, "--cpu"]))))
    assert rc == [0]
    ref = _json_lines(jax_toy)
    assert len(port) == len(ref) == 3
    for got, want in zip(port, ref):
        assert list(got) == list(want) + ["card"] and got["card"] == "cpu"
    for got, want in zip(port[:-1], ref[:-1]):
        for key in ("family", "signal_strengths", "cells"):
            assert got[key] == want[key], key
        assert got["seqs"] > 0 and 0.0 <= got["mean_max_fitness"] <= 1.2
    summary = port[-1]
    for key in ("metric", "landscapes", "families", "total_cells"):
        assert summary[key] == ref[-1][key], key
    assert summary["n_devices"] == 1  # one process, no mesh (the JAX test's mesh has 8 CPUs)
    assert summary["total_cells"] == sum(l["cells"] for l in port[:-1])
    assert summary["total_seqs"] == sum(l["seqs"] for l in port[:-1])


@pytest.mark.parametrize("n_names, n_ss, chunk, mesh_size, want", [
    (2, 1, 4, 1, 2),     # the grid fits one chunk: the same single batch
    (200, 1, 40, 1, 40),  # 40 names fill one chunk exactly
    (200, 5, 40, 1, 8),   # 40 cells = 8 names x 5 signal strengths exactly
    (200, 3, 40, 1, 14),  # 13 x 3 = 39 < 40: 14 names, padded back to 40
    (200, 1, 10, 4, 12),  # the chunk rounds up to 12 on a mesh of 4
])
def test_warm_names_take_the_timed_chunk_shape(n_names, n_ss, chunk, mesh_size, want):
    names = [f"L{i}" for i in range(n_names)]
    assert bench_northstar.warm_names(names, n_ss, chunk, mesh_size) == names[:want]


def test_aggregate_equals_the_script_on_a_jax_log(jax_toy, tmp_path):
    log = tmp_path / "northstar.log"
    log.write_text("not a json line\n" + jax_toy + jax_toy)  # a rerun supersedes
    out_script, out_port = tmp_path / "script.json", tmp_path / "port.json"
    script_text = _printed(_load("aggregate_northstar").main,
                           ["aggregate_northstar.py", str(log), "--out", str(out_script)])
    port_text = _printed(lambda: aggregate_northstar.main([str(log), "--out", str(out_port)]))
    script_lines, port_lines = script_text.splitlines(), port_text.splitlines()
    assert len(port_lines) == len(script_lines)
    for got, want in zip(port_lines, script_lines):
        if got.startswith("{"):
            got = json.loads(got)
            assert got.pop("card") is None
            assert got == json.loads(want)
        elif not got.startswith("wrote "):
            assert got == want
    script_art, port_art = json.loads(out_script.read_text()), json.loads(out_port.read_text())
    assert port_art["summary"].pop("card") is None
    assert port_art == script_art
    assert [r["family"] for r in port_art["families"]] == ["random", "adalead"]


def test_aggregate_carries_the_card(tmp_path):
    rows = [{"family": f, "signal_strengths": [0.9], "cells": 40, "wall_s": w, "seqs": s,
             "seqs_per_sec": round(s / w, 1), "mean_max_fitness": 0.99, "min_max_fitness": 0.9,
             "card": "NVIDIA H100 80GB HBM3, 700.00 W"}
            for f, w, s in (("adalead", 13.5, 1_000_000), ("ga", 20.0, 400_000))]
    log = tmp_path / "log"
    log.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    out = tmp_path / "out.json"
    text = _printed(lambda: aggregate_northstar.main([str(log), "--out", str(out),
                                                      "--baseline", "1000"]))
    summary = _json_lines(text)[0]
    assert summary["card"] == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert summary["total_cells"] == 80 and summary["total_seqs"] == 1_400_000
    assert summary["reference_seqs_per_sec"] == 1000.0
    fam = aggregate_northstar.family_baselines()
    assert summary["reference_wall_s_family_fair"] == round(
        1_000_000 / fam.get("adalead", 1000.0) + 400_000 / fam["ga"], 1)
    art = json.loads(out.read_text())
    assert [r["card"] for r in art["families"]] == [rows[0]["card"]] * 2
    assert art["families"][1]["vs_family_baseline"] == round(20_000.0 / fam["ga"], 1)


def test_aggregate_without_family_lines_exits():
    with pytest.raises(SystemExit, match="no family lines"):
        aggregate_northstar.main([os.path.join(ROOT, "BASELINE_MEASURED.json")])


def test_without_a_card_exits_nonzero():
    """No card and no --cpu: it raises before printing any line."""
    proc = subprocess.run(
        [sys.executable, "-m", "flexs_tpu_torch.bench_northstar", "--families", "random",
         "--landscapes", "1", "--rounds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "torch.cuda.is_available() is False" in proc.stderr
