"""The program's span registry (`flexs_tpu_torch.utils.profiling.span`) and its sites.

Spans are off unless switched on; on, they keep each path's calls, host and
self time, and under `torch.profiler` each is a `record_function` range
around the ops launched inside it.  A tiny TF-Bind-8 Adalead chunk on the
CPU gives the same results with them on as off.
"""
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import flexs_tpu_torch as flexs
from flexs_tpu_torch.landscapes import tf_binding
from flexs_tpu_torch.runtime import jit_runner
from flexs_tpu_torch.utils import profiling
from flexs_tpu_torch.utils.profiling import span

# Every span the fused Adalead runner opens (`jit_runner`'s module docstring).
ADALEAD_SPANS = ("flexs.round", "flexs.nam_query", "flexs.mutants", "flexs.recombine",
                 "flexs.draw", "flexs.dist", "flexs.oracle", "flexs.top_b", "flexs.measure",
                 "flexs.fetch")


@pytest.fixture(autouse=True)
def _spans_off_after():
    """Each test starts and ends with the spans off and the table empty."""
    profiling.enable_spans(False)
    profiling.reset_spans()
    yield
    profiling.enable_spans(False)
    profiling.reset_spans()


@pytest.fixture(scope="module")
def landscape():
    return flexs.landscapes.TFBinding(name="SIX6_REF_R1", device="cpu")


def _chunk(landscape, spans_on: bool):
    """A 1-round, 3-cell lockstep Adalead chunk with one recombination pass a budget pass."""
    cfg = jit_runner.AdaleadConfig(rounds=1, sequences_batch_size=6, model_queries_per_batch=24,
                                   alphabet_size=4, recomb_rate=0.3, rho=1)
    fn, params = landscape.device_fitness()
    tokens = torch.as_tensor(flexs.Alphabet(flexs.DNAA).encode([tf_binding.STARTS[0]] * 3))
    gens = []
    for seed in (0, 1, 2):
        gens.append(torch.Generator())
        gens[-1].manual_seed(seed)
    profiling.enable_spans(spans_on)
    try:
        return jit_runner.run_adalead_nam_cells(
            jit_runner.cell_axis_oracle(fn), params, tokens, cfg, [0.0, 0.5, 1.0], gens)
    finally:
        profiling.enable_spans(False)


def test_spans_off_record_nothing_and_open_no_range(landscape):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _chunk(landscape, spans_on=False)
    assert profiling.span_table() == {}
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert not [n for n in names if n.startswith("flexs.")]
    assert "aten::random_" in names  # the profiler saw the run
    assert profiling.span("flexs.round") is profiling.span("flexs.draw")  # one shared no-op


def test_spans_on_leave_a_chunk_unchanged_and_record_every_step(landscape):
    off = _chunk(landscape, spans_on=False)
    jit_runner.reset_run_counts()
    on = _chunk(landscape, spans_on=True)
    for name, a, b in zip(off._fields, off, on):
        assert torch.equal(a, b), name
    totals = profiling.span_totals()
    assert [name for name in ADALEAD_SPANS if totals.get(name, {}).get("calls", 0) == 0] == []
    assert totals["flexs.round"]["calls"] == 1  # one round, one lockstep run
    assert totals["flexs.fetch"]["calls"] == jit_runner.run_counts["syncs"]
    table = profiling.span_table()
    assert table["flexs.round/flexs.mutants/flexs.draw"]["parent"] == "flexs.round/flexs.mutants"
    assert table["flexs.round"]["parent"] is None
    jit_runner.reset_run_counts()  # the counters and the table together
    assert profiling.span_table() == {} and jit_runner.run_counts["syncs"] == 0


def _children(table, path):
    return [row for p, row in table.items() if row["parent"] == path]


def test_nesting_gives_self_time_total_less_children(landscape):
    profiling.enable_spans(True)
    for _ in range(2):
        with span("outer"):
            time.sleep(0.002)
            with span("inner"):
                time.sleep(0.003)
                with span("inner"):  # a name nested in itself
                    time.sleep(0.001)
            with span("other"):
                pass
    profiling.enable_spans(False)
    table = profiling.span_table()
    assert set(table) == {"outer", "outer/inner", "outer/inner/inner", "outer/other"}
    outer, inner = table["outer"], table["outer/inner"]
    assert outer["calls"] == 2 and outer["parent"] is None
    assert outer["self_s"] >= 0.004 and inner["self_s"] >= 0.006
    totals = profiling.span_totals()
    assert totals["inner"]["calls"] == 4
    assert totals["inner"]["total_s"] == pytest.approx(inner["total_s"])  # outermost only
    assert totals["inner"]["self_s"] == pytest.approx(
        inner["self_s"] + table["outer/inner/inner"]["self_s"])
    # On a real run too: self = total less the children, and no parent below its children.
    _chunk(landscape, spans_on=True)
    table = profiling.span_table()
    for path, row in table.items():
        kids = sum(k["total_s"] for k in _children(table, path))
        assert row["total_s"] >= kids - 1e-9, path
        assert row["self_s"] == pytest.approx(row["total_s"] - kids, abs=1e-8), path


def test_each_span_is_a_profiler_range_around_its_ops(landscape):
    profiling.enable_spans(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("flexs.draw"):
            torch.empty(64).uniform_()
        _chunk(landscape, spans_on=True)
    profiling.enable_spans(False)
    events = list(prof.profiler.kineto_results.events())

    def ranges(name):
        return [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
                if e.name() == name]

    def inside(t, spans):
        return any(a <= t < b for a, b in spans)

    draws, dists = ranges("flexs.draw"), ranges("flexs.dist")
    assert len(draws) == profiling.span_totals()["flexs.draw"]["calls"]
    for op, spans in (("aten::uniform_", draws), ("aten::random_", draws),
                      ("aten::exponential_", draws), ("aten::randperm", draws),
                      ("aten::bitwise_xor", dists)):
        starts = [e.start_ns() for e in events if e.name() == op]
        assert starts and all(inside(t, spans) for t in starts), op
    # Outside a profiler, no range is opened: the table fills all the same.
    profiling.reset_spans()
    profiling.enable_spans(True)
    with span("flexs.draw"):
        assert not torch.autograd.profiler._is_profiler_enabled
    profiling.enable_spans(False)
    assert profiling.span_table()["flexs.draw"]["calls"] == 1
