"""The yardstick's arithmetic: trace reduction, work counts, and the metric readers."""
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import probes, run, trace, work
from benchmark.tests import tiny


def _events():
    # Device ops [0, 10), [15, 20), [20, 30), [50, 60) ns; launched at host times 1, 12, 13, 45.
    return trace.Events(
        dev_start=np.array([0, 15, 20, 50]), dev_end=np.array([10, 20, 30, 60]),
        dev_name=["a", "b", "a", "c"], launch_t=np.array([1, 12, 13, 45]),
        launch_op=["aten::x", "aten::y", "aten::y", "aten::z"],
        spans={"dist": (np.array([11]), np.array([14])),
               "round": (np.array([0]), np.array([100]))},
    )


def test_reduce_busy_spans_and_gaps():
    out = trace.reduce(_events(), 100e-9)
    assert out["busy_s"] == pytest.approx(35e-9)
    assert out["span_device_s"]["dist"] == pytest.approx(15e-9)  # b and the second a
    assert out["span_device_s"]["round"] == pytest.approx(35e-9)
    ops = dict(out["breakdown"]["device_ops"])
    assert ops["a"] == pytest.approx(20e-9) and ops["c"] == pytest.approx(10e-9)
    gaps = dict(out["breakdown"]["idle_gaps"])
    assert gaps["dist: aten::y"] == pytest.approx(5e-9)  # 10 -> 15, ended by b, launched in dist
    assert gaps["round: aten::z"] == pytest.approx(20e-9)  # 30 -> 50
    assert sum(gaps.values()) == pytest.approx(100e-9 - 35e-9)


def test_swaps_of_one_attribute_nest():
    owner = SimpleNamespace(f=lambda x: x)
    tag = lambda t: lambda fn: lambda x: fn(x) + t  # noqa: E731
    with probes.replaced([(owner, "f", tag("a")), (owner, "f", tag("b"))]):
        assert owner.f("") == "ab"
    assert owner.f("") == ""


def test_lookup_work():
    w = work.Lookup()
    w.add(100, [10, 30], words=1, bits=2)
    assert w.ops["popc"] == 4000 and w.ops["compare"] == 4000
    assert w.ops["logic"] == 4000 * 3 and w.ops["shift"] == 4000
    assert w.bytes == (400 + 40 + 800) + (400 + 120 + 800)
    pk = work.peaks()
    t = work.lookup_ops_s(w, pk, 1000.0)
    assert t == pytest.approx(4000 / (16 * 132 * 1e9))  # popcount is the slowest class here
    assert work.lookup_bound_s(w, pk, 1000.0) >= t


def test_bert_flops_at_tape_widths():
    with open(os.path.join(tiny.ROOT, "benchmark", "configs", "gfp-adalead-nam.json")) as f:
        config = json.load(f)
    assert work.bert_flops(config) == pytest.approx(42.894e9, rel=1e-4)
    assert work.distinct_rows(1 + 2 * 1800 + 100, 100) == 1801


def _ctx(unit=True):
    lookup = work.Lookup()
    lookup.add(100, [1000] * 40, 1, 2)
    return SimpleNamespace(
        config={"work": "lookup_ops"}, peaks=work.peaks(), on_device=True, sm_clock_mhz=1980.0,
        setup={"import_s": 3.0, "warm_s": 2.0},
        window={"wall_s": 50.0, "syncs": 100000, "rounds": 40, "cells": 160, "lookup": lookup,
                "bert_forwards": 0},
        unit=None if not unit else {"window_s": 12.0, "untraced_wall_s": 8.0, "busy_s": 6.0,
                                    "bert_forwards": 0,
                                    "span_device_s": {"dist": 5.0, "oracle": 0.1},
                                    "lookup": lookup})


def test_every_declared_metric_has_a_reader_that_reads_or_stays_silent():
    for m in tiny.bench(staged=True)["per_layer"]:
        reader = run.load_metric(m["name"])
        value = reader.read(_ctx())
        if not m["name"].startswith("oracle_roofline"):
            assert isinstance(value, float), m["name"]
        if m["unit"] == "%" and value is not None:
            assert 0 <= value <= 100, (m["name"], value)
        if m["source"] == "device_trace":
            assert reader.read(_ctx(unit=False)) is None, m["name"]  # nothing to read: no number
    assert run.load_metric("sync_ms").read(_ctx()) == pytest.approx(0.5)
    # Over the unit's untraced wall (8 s), not its traced one (12 s).
    assert run.load_metric("idle_pct").read(_ctx()) == pytest.approx(25.0)
