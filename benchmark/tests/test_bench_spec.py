"""BENCHMARK.json and the files it names, against the benchmark's contract."""
import json
import os
import re

import pytest

from benchmark.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = ("hidden", "intermediate", "heads", "value_hidden", "positions", "tokens")


@pytest.mark.parametrize("staged", [False, True])
def test_keys_names_and_units(staged):
    b = tiny.bench(staged)
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["benchmark"] and not any(w.startswith("/") for w in b["command"])
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert 1 <= len(c["why"]) <= 200 and all(NAME.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and len(w["why"]) <= 200
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert b["end_to_end"][0]["name"] == "setup_s"
    e2e = {m["name"] for m in b["end_to_end"]}
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and set(m.get("workloads", [])) <= cells
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        reader = m["name"].split(".")[0] + ".py"
        assert os.path.exists(os.path.join(tiny.ROOT, "benchmark", "metrics", reader))


@pytest.mark.parametrize("staged", [False, True])
def test_files_and_reductions(staged):
    b = tiny.bench(staged)
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        with open(os.path.join(tiny.ROOT, c["file"])) as f:
            config = json.load(f)
        assert config["reduced"] == c["reduced"] and config["source"] == c["source"]
        assert not set(c["reduced"]) & set(WIDTHS)
        assert all(k in config.get("published", {}) for k in c["reduced"])
        for mod in ("families", "reference"):
            assert os.path.exists(os.path.join(tiny.ROOT, "benchmark", mod, config["family"] + ".py"))
    for w in b["workloads"]:
        with open(os.path.join(tiny.ROOT, "benchmark", "traffic", w["traffic"] + ".json")) as f:
            traffic = json.load(f)
        assert os.path.exists(os.path.join(tiny.ROOT, "benchmark", "entries",
                                           traffic["entry"] + ".py"))


def test_run_seconds_fit_a_full_check_of_24_cells():
    rs = tiny.bench()["run_seconds"]
    assert 1 <= rs <= 51 and (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
