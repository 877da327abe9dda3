"""Profiling hooks (the reference's only tracing is a per-round print).

Thin wrappers over `torch.profiler`, so runs can be traced without
touching explorer code, and the program's own spans (`span`): named steps
of the fused runners whose host time is kept in memory while they are
switched on (`enable_spans`).  `trace`, `amortized_seconds_per_call` and
`jax_leaf` are the JAX package's names.

Read a trace's raw events (`prof.events()`, or the Chrome trace's JSON)
rather than `key_averages()`, which takes minutes on the half million
events of a long run.
"""
import contextlib
import dataclasses
import os
import socket
import time
from typing import Dict, List

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block and write a Chrome trace under `log_dir`.

    CPU activity always, CUDA activity when a card is present.  Yields the
    `torch.profiler.profile`; the trace goes to
    `<log_dir>/<host>_<pid>.<ns>.pt.trace.json` when the block ends, for
    Perfetto or chrome://tracing.
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    name = f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json"
    prof.export_chrome_trace(os.path.join(log_dir, name))


def amortized_seconds_per_call(fn, *args, reps: int = 20) -> float:
    """Seconds per `fn(*args)`, averaged over `reps` calls after one warm-up call.

    When the result's first tensor leaf lies on a card, the calls are timed
    with CUDA events on its stream; otherwise with `time.perf_counter`
    around calls that end in `torch.cuda.synchronize()` where a card is
    present (CPU execution has finished when the call returns).
    """
    out = fn(*args)
    leaf = jax_leaf(out)
    if leaf.is_cuda:
        with torch.cuda.device(leaf.device):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn(*args)
            end.record()
            end.synchronize()
        return start.elapsed_time(end) / 1e3 / reps
    start = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return (time.perf_counter() - start) / reps


def _tensor_leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for key in sorted(tree):
            yield from _tensor_leaves(tree[key])
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _tensor_leaves(x)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensor_leaves(getattr(tree, f.name))


def jax_leaf(tree) -> torch.Tensor:
    """First tensor leaf of a tree (tuples, lists, dicts by sorted key, dataclasses).

    The name is the JAX package's.  Raises ValueError for a tree without a
    tensor.
    """
    for leaf in _tensor_leaves(tree):
        return leaf
    raise ValueError("the tree holds no tensor")


# The program's spans.  Off by default: `span` then reads the switch and
# returns a shared no-op, with no clock read and no allocation.  On, each
# span reads the clock twice and adds its host time to a table kept by path
# ("flexs.round/flexs.nam_query/flexs.dist": the names of the spans open
# around it, outermost first), and while a `torch.profiler` is active it
# also opens a `record_function` range of its name, so that the device work
# it launches can be put down to it on the profiler's timeline.  The table
# and the stack of open spans are kept for the one thread that runs the
# fused loops.
_spans_on = False
_table: Dict[str, list] = {}  # path -> [calls, total ns, self ns, parent path or None, path]
_open: List[list] = []  # the open spans: [row, start ns, range or None]
_OFF = contextlib.nullcontext()
_profiler = torch.autograd.profiler


class _Span:
    """The span of one name: its rows in the table, by the path of the span open around it."""

    __slots__ = ("name", "rows")

    def __init__(self, name: str):
        self.name = name
        self.rows: Dict[str, list] = {}

    def __enter__(self):
        parent = _open[-1][0][4] if _open else None
        row = self.rows.get(parent)
        if row is None:
            path = self.name if parent is None else f"{parent}/{self.name}"
            row = self.rows[parent] = _table.setdefault(path, [0, 0, 0, parent, path])
        rng = None
        if _profiler._is_profiler_enabled:
            rng = _profiler.record_function(self.name)
            rng.__enter__()
        _open.append([row, time.perf_counter_ns(), rng])

    def __exit__(self, *exc):
        total = time.perf_counter_ns()
        row, start, rng = _open.pop()
        if rng is not None:
            rng.__exit__(None, None, None)
        total -= start
        row[0] += 1
        row[1] += total
        row[2] += total
        if _open:
            _open[-1][0][2] -= total  # the parent's self time
        return False


_spans: Dict[str, _Span] = {}


def span(name: str):
    """A context manager around one step of the program, named `name`.

    A no-op unless spans are on (`enable_spans`); then it records its calls
    and host time under its path in the span table (`span_table`).
    """
    if not _spans_on:
        return _OFF
    s = _spans.get(name)
    if s is None:
        s = _spans[name] = _Span(name)
    return s


def enable_spans(on: bool) -> None:
    """Switch the program's spans on or off (off when the package is imported)."""
    global _spans_on
    _spans_on = bool(on)


def reset_spans() -> None:
    """Empty the span table (spans open at the time go unrecorded)."""
    _table.clear()
    for s in _spans.values():
        s.rows.clear()


def span_table() -> Dict[str, dict]:
    """Each span path's calls, host seconds (`total_s`), `self_s` and `parent` path.

    A span's self time is its total less the time of the spans closed
    inside it.
    """
    return {path: {"calls": calls, "total_s": total / 1e9, "self_s": own / 1e9,
                   "parent": parent}
            for path, (calls, total, own, parent, _) in _table.items()}


def span_totals() -> Dict[str, dict]:
    """`span_table()` summed by span name over every path that ends in it.

    A name's `total_s` counts only its outermost spans, so a span nested in
    one of its own name is not counted twice; `self_s` counts them all.
    """
    out: Dict[str, dict] = {}
    for path, row in span_table().items():
        *outer, name = path.split("/")
        t = out.setdefault(name, {"calls": 0, "total_s": 0.0, "self_s": 0.0})
        t["calls"] += row["calls"]
        t["self_s"] += row["self_s"]
        if name not in outer:
            t["total_s"] += row["total_s"]
    return out
