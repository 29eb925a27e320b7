"""Spans recorded from outside the program, and the profiled slice.

`Spans` wraps attributes of the program (a module's function, a class's
method) with a host-clock timer; with `annotate` each call is also a
`torch.profiler.record_function` range, so that a trace shows what the host
was doing.  `unwrap` puts every attribute back.

`profile_slice` runs a few frames or steps under torch.profiler (CUPTI) and
reduces the trace: the device's busy time as the union of its activity
intervals (copied from `chip_smoke.py::device_busy`), the device time by
kernel name, the number of device activities, and the idle gaps between
activities, each named by the innermost annotated host span around it; on
request also each stream's activities, by the stream id the trace gives.
"""
from __future__ import annotations

import functools
import time
from collections import Counter, defaultdict
from typing import Callable, Dict, List, Optional


class Spans:
    def __init__(self):
        self.total: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)
        self.on = True
        self.annotate = False
        self._undo: List = []

    def wrap(self, owner, attr: str, name: str) -> None:
        original = getattr(owner, attr)
        spans = self

        @functools.wraps(original)
        def timed(*args, **kwargs):
            if not spans.on:
                return original(*args, **kwargs)
            if spans.annotate:
                import torch

                with torch.profiler.record_function("pb:" + name):
                    t0 = time.perf_counter()
                    try:
                        return original(*args, **kwargs)
                    finally:
                        spans.total[name] += time.perf_counter() - t0
                        spans.calls[name] += 1
            t0 = time.perf_counter()
            try:
                return original(*args, **kwargs)
            finally:
                spans.total[name] += time.perf_counter() - t0
                spans.calls[name] += 1

        had = attr in vars(owner) if hasattr(owner, "__dict__") else True
        self._undo.append((owner, attr, original, had))
        setattr(owner, attr, timed)

    def reset(self) -> None:
        self.total.clear()
        self.calls.clear()

    def unwrap(self) -> None:
        for owner, attr, original, had in reversed(self._undo):
            if had:
                setattr(owner, attr, original)
            else:
                delattr(owner, attr)
        self._undo.clear()


def busy_union(spans) -> float:
    """Length of the union of (start, end) intervals, sorted by start."""
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def merge(spans) -> list:
    """The union of (start, end) intervals as disjoint intervals, in order."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def overlap(a, b) -> float:
    """Length of the intersection of the unions of two interval lists."""
    a, b = merge(a), merge(b)
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def profile_slice(run_units: Callable[[], int], spans: Optional[Spans],
                  streams: bool = False) -> dict:
    """Profile `run_units()` (which runs and returns its frame or step count,
    ending in a synchronize) and reduce its trace.  Times in seconds.  With
    `streams`, `streams` maps each stream id to its activities as (start,
    end, name)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if torch.cuda.is_available():
        torch.cuda.synchronize()
    if spans is not None:
        spans.annotate = True
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            units = run_units()
            wall = time.perf_counter() - t0
    finally:
        if spans is not None:
            spans.annotate = False
    events = prof.events()
    # device activities only: record_function ranges also appear on the
    # device's timeline as user annotations, and are no device work
    activities = [e for e in events if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)
                  and not e.name.startswith(("pb:", "Optimizer.", "ProfilerStep"))]
    device = sorted(((e.time_range.start, e.time_range.end, e.name) for e in activities),
                    key=lambda x: x[0])
    by_name, count_by_name = Counter(), Counter()
    for s, e, n in device:
        by_name[n] += (e - s) / 1e6
        count_by_name[n] += 1
    busy = busy_union([(s, e) for s, e, _ in device]) / 1e6
    host = [(e.time_range.start, e.time_range.end, e.name[3:]) for e in events
            if e.device_type == DeviceType.CPU and e.name.startswith("pb:")]
    gaps = Counter()
    end = device[0][1] if device else 0.0
    for s, e, _ in device[1:]:
        if s > end + 10.0:  # microseconds; shorter gaps are launch spacing
            mid = 0.5 * (s + end)
            around = [h for h in host if h[0] <= mid <= h[1]]
            label = min(around, key=lambda h: h[1] - h[0])[2] if around else "outside the spans"
            gaps[label] += (s - end) / 1e6
        elif s > end:
            gaps["gaps under 10 us"] += (s - end) / 1e6
        end = max(end, e)
    out = {"units": units, "wall_s": wall, "busy_s": busy, "activities": len(device),
           "by_name": dict(by_name), "count_by_name": dict(count_by_name),
           "idle_by_host": dict(gaps)}
    if streams:
        by_stream = defaultdict(list)
        for e in activities:
            by_stream[getattr(e, "device_resource_id", None)].append(
                (e.time_range.start / 1e6, e.time_range.end / 1e6, e.name))
        out["streams"] = dict(by_stream)
    return out
