"""The port's profiling hooks on the CPU: trace, amortized timing, jax_leaf.

The JAX package's `trace` writes a TensorBoard profile and its
`amortized_seconds_per_call` times through an array fetch; the port's
write a Chrome trace with `torch.profiler` and time with CUDA events on a
card, `time.perf_counter` here.
"""
import collections
import glob
import json
import os

import pytest
import torch

from flexs_tpu_torch.utils import profiling


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    a = torch.randn(64, 64)
    with profiling.trace(log_dir) as prof:
        torch.mm(a, a)
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    assert any(e.name == "aten::mm" for e in prof.events())


def test_amortized_seconds_per_call_is_positive():
    calls = []
    a = torch.randn(32, 32)

    def fn(x):
        calls.append(1)
        return {"out": torch.mm(x, x)}

    seconds = profiling.amortized_seconds_per_call(fn, a, reps=5)
    assert isinstance(seconds, float) and seconds > 0
    assert len(calls) == 6  # one warm-up call, then the timed ones


def test_jax_leaf_is_the_first_tensor_leaf():
    first, second = torch.zeros(2), torch.ones(3)
    Pair = collections.namedtuple("Pair", "a b")
    assert profiling.jax_leaf(first) is first
    assert profiling.jax_leaf(Pair(first, second)) is first
    assert profiling.jax_leaf({"b": second, "a": [3, first]}) is first  # sorted keys
    assert profiling.jax_leaf(("text", 1.0, [second])) is second
    with pytest.raises(ValueError, match="no tensor"):
        profiling.jax_leaf({"a": 1})
