"""Profiling hooks (the reference's only tracing is a per-round print).

Thin wrappers over `torch.profiler` plus a wall-clock round timer, so runs
can be traced without touching explorer code.  Counterpart of the JAX
package's module, with the same names.

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


class RoundTimer:
    """Accumulates per-round wall-clock spans for an experiment loop."""

    def __init__(self):
        self.spans: List[Dict] = []
        self._start = None
        self._label = None

    @contextlib.contextmanager
    def measure(self, label: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            self.spans.append(
                {"label": label, "seconds": time.perf_counter() - start}
            )

    def summary(self) -> Dict[str, float]:
        """Total seconds per label."""
        out: Dict[str, float] = {}
        for span in self.spans:
            out[span["label"]] = out.get(span["label"], 0.0) + span["seconds"]
        return out
