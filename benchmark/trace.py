"""Reduce one profiled unit's raw profiler events to device time, spans and gaps.

Events are read in memory from `prof.profiler.kineto_results.events()`, not
through `key_averages()` (which builds an object tree per event), and no
trace is exported.  A device event is charged to every benchmark span that
was open on the host when the op that launched it started: its launch is
found through the event's linked correlation id, which is the launching
op's id.  Idle gaps are labelled by the innermost open span and the
launching op of the kernel that ends the gap.
"""
from dataclasses import dataclass

import numpy as np
import torch

TOP = 10


@dataclass
class Events:
    """One unit's events as arrays (ns on the profiler's clock)."""

    dev_start: np.ndarray  # int64[k]: device ops, kernels and copies alike
    dev_end: np.ndarray
    dev_name: list
    launch_t: np.ndarray  # int64[k]: host start of the launching op, -1 where unknown
    launch_op: list  # name of the launching op, "?" where unknown
    spans: dict  # label -> (int64 starts, int64 ends), sorted by start


def collect(prof, labels) -> Events:
    """`Events` of a finished `torch.profiler.profile`, spans restricted to `labels`."""
    labels = set(labels)
    ops, spans, dev = {}, {label: [] for label in labels}, []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cuda:
            # The spans' own ranges on the device timeline are annotations, not device work.
            if name not in labels and not e.is_user_annotation():
                dev.append((e.start_ns(), e.start_ns() + e.duration_ns(), name,
                            e.linked_correlation_id()))
            continue
        if name in labels:
            spans[name].append((e.start_ns(), e.start_ns() + e.duration_ns()))
        elif e.linked_correlation_id() == 0:
            ops[e.correlation_id()] = (e.start_ns(), name)
    dev.sort()
    launches = [ops.get(link, (-1, "?")) for *_, link in dev]
    return Events(
        dev_start=np.array([d[0] for d in dev], np.int64),
        dev_end=np.array([d[1] for d in dev], np.int64),
        dev_name=[d[2] for d in dev],
        launch_t=np.array([t for t, _ in launches], np.int64),
        launch_op=[op for _, op in launches],
        spans={k: tuple(np.array(x, np.int64).reshape(-1, 2).T) for k, x in
               ((k, sorted(v)) for k, v in spans.items())},
    )


def _inside(t, starts, ends):
    """bool[k]: whether each time lies in one of the sorted, non-overlapping intervals."""
    if len(starts) == 0:
        return np.zeros(len(t), bool)
    i = np.searchsorted(starts, t, side="right") - 1
    return (i >= 0) & (t < ends[np.maximum(i, 0)])


def _innermost(ev: Events):
    """Label of the innermost span open at each device op's launch ("" where none)."""
    best_t = np.full(len(ev.launch_t), -1, np.int64)
    label = np.array([""] * len(ev.launch_t), dtype=object)
    for name, (starts, ends) in ev.spans.items():
        if len(starts) == 0:
            continue
        i = np.maximum(np.searchsorted(starts, ev.launch_t, side="right") - 1, 0)
        inside = _inside(ev.launch_t, starts, ends) & (starts[i] > best_t)
        best_t = np.where(inside, starts[i], best_t)
        label[inside] = name
    return label


def reduce(ev: Events, window_s: float) -> dict:
    """busy_s, each span's device seconds, the top device ops and the longest idle gaps."""
    dur = (ev.dev_end - ev.dev_start) / 1e9
    out = {"window_s": window_s, "device_ops": len(dur),
           "linked_share": float(np.mean(ev.launch_t >= 0)) if len(dur) else None}
    if not len(dur):
        return {**out, "busy_s": 0.0, "span_device_s": {}, "breakdown": None}
    # Busy: the union of the device ops' intervals.
    run_end = np.maximum.accumulate(ev.dev_end)
    gaps = np.maximum(ev.dev_start[1:] - run_end[:-1], 0) / 1e9
    busy = (run_end[-1] - ev.dev_start[0]) / 1e9 - gaps.sum()
    out["busy_s"] = float(busy)
    out["span_device_s"] = {
        name: float(dur[_inside(ev.launch_t, *ev.spans[name])].sum()) for name in ev.spans
    }
    by_name = {}
    for name, d in zip(ev.dev_name, dur):
        by_name[name] = by_name.get(name, 0.0) + float(d)
    label = _innermost(ev)
    by_gap = {}
    for k in np.nonzero(gaps > 0)[0]:
        key = f"{label[k + 1] or 'no span'}: {ev.launch_op[k + 1]}"
        by_gap[key] = by_gap.get(key, 0.0) + float(gaps[k])
    # Idle time before the first op and after the last one, inside the window.
    edge = window_s - (run_end[-1] - ev.dev_start[0]) / 1e9
    if edge > 0:
        by_gap["window edges: before the first and after the last device op"] = float(edge)

    def top(d):
        return [[k[:120], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    out["breakdown"] = {"device_ops": top(by_name), "idle_gaps": top(by_gap)}
    return out
