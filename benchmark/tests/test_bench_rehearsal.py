"""The harness end to end on the CPU at small sizes: schema, data-driven cells, the import rule."""
import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import run
from benchmark.tests import tiny

CELLS = sorted(tiny.TINY)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", CELLS)
def test_one_unit_of_each_mix(workload, trace, capsys):
    spec = tiny.spec(workload)
    result = tiny.rehearse(workload, trace)
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    record = next(line for line in lines if "window_lookup_calls" in line)
    checked = next(line["checked"] for line in lines if "checked" in line)
    # The window's lookups are counted in a traced run (the whole-window share reads them),
    # each call once, beside the sample of the same calls.
    assert record["window_lookup_calls"] == (checked["dist_calls"] if trace else 0)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "compared"
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    declared = {m["name"]: m["unit"] for m in (spec.per_layer if trace else spec.end_to_end)}
    assert set(result["metrics"]) <= set(declared)
    for name, metric in result["metrics"].items():
        assert set(metric) == {"value", "unit"} and metric["unit"] == declared[name]
        assert isinstance(metric["value"], float) and metric["value"] == metric["value"]
    if not trace:
        assert set(result["metrics"]) == set(declared)  # every end-to-end metric, every run
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(result["device"])
    assert ("busy_s" in result["device"]) == trace
    for name, v in result["compared"].items():
        assert set(v) == {"value", "limit"} and v["value"] <= v["limit"], name
    json.dumps(result)


def _digest(root):
    h = hashlib.sha256()
    for d, _, files in sorted(os.walk(os.path.join(root, "benchmark"))):
        if "__pycache__" in d:
            continue
        for f in sorted(files):
            with open(os.path.join(d, f), "rb") as fh:
                h.update(f.encode() + fh.read())
    with open(os.path.join(root, "BENCHMARK.json"), "rb") as fh:
        h.update(fh.read())
    return h.hexdigest()


def test_a_cell_from_a_new_traffic_file(tmp_path):
    """A cell added by a data file and an entry, in another tree: no file of the harness edited."""
    before = _digest(tiny.ROOT)
    for sub in ("configs", "traffic"):
        shutil.copytree(os.path.join(tiny.ROOT, "benchmark", sub), tmp_path / "benchmark" / sub)
    data = os.path.join("flexs_tpu", "landscapes", "data")
    (tmp_path / data).parent.mkdir(parents=True)
    os.symlink(os.path.join(tiny.ROOT, data), tmp_path / data)  # the tables, read as data
    with open(os.path.join(tiny.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(tmp_path / "benchmark" / "traffic" / "chunk12.json", "w") as f:
        json.dump({"entry": "robustness_sweep", "landscapes_per_unit": 3, "chunk_size": 4}, f)
    name = "tfbind8-adalead-nam.chunk12"
    bench["workloads"].append({"name": name, "config": "tfbind8-adalead-nam",
                               "traffic": "chunk12", "chips": 1, "why": "a test"})
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    overrides = {"config": tiny.TINY["tfbind8-adalead-nam.chunk40"]["config"]}
    spec = run.load_cell(str(tmp_path), name, overrides)
    assert spec.traffic["landscapes_per_unit"] == 3
    result = run.run_cell(spec, tiny.SEED, 0.01, False, "cpu")
    assert result["correct"] and result["attempted"] == 9  # 3 landscapes x 3 strengths
    assert _digest(tiny.ROOT) == before


def test_no_jax_and_no_reference_import_of_the_port():
    """After runs of both cells no module is jax, jaxlib, flax, optax or flexs_tpu (whole names)."""
    loaded = tiny.in_subprocess(
        "import json, sys\n"
        "from benchmark.tests import tiny\n"
        f"for w in {CELLS!r}:\n"
        "    assert tiny.rehearse(w)['correct']\n"
        "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))\n")
    assert not set(loaded) & {"jax", "jaxlib", "flax", "optax", "flexs_tpu"}
    assert "flexs_tpu_torch" in loaded  # whole names: the port is not the JAX package
    ref = tiny.in_subprocess(
        "import json, sys\n"
        "import benchmark.reference.tf_binding, benchmark.reference.bert_gfp\n"
        "import benchmark.reference.hamming\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    assert not [n for n in ref if n.split(".")[0] in ("flexs_tpu_torch", "flexs_tpu", "jax")]
    assert not [n for n in ref if n.startswith("benchmark.") and
                not n.startswith("benchmark.reference")]


def test_the_forbidden_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "flexs_tpu_torch_fake", sys)
    assert run.forbidden_modules() == sorted(
        {n.split(".")[0] for n in sys.modules} & run.FORBIDDEN)
    monkeypatch.setitem(sys.modules, "flexs_tpu.fake", sys)
    assert "flexs_tpu" in run.forbidden_modules()


@pytest.mark.parametrize("bare", [False, True])
def test_no_result_without_a_card_or_without_the_port(tmp_path, bare):
    """Without a card (this CPU) or outside a checkout the command exits nonzero and prints no result."""
    cwd = tiny.ROOT
    if bare:
        shutil.copytree(os.path.join(tiny.ROOT, "benchmark"), tmp_path / "benchmark",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(os.path.join(tiny.ROOT, "BENCHMARK.json"), tmp_path)
        cwd = str(tmp_path)
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", CELLS[0], "--seed",
                          "1", "--seconds", "1", "--trace", "0"], cwd=cwd, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
