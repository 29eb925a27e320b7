"""Spans and counters inside the program, off by default.

`enable()` turns the tracer on for the process, `disable()` off, `reset()`
drops what it recorded; `utils.profiling.trace(log_dir)` turns it on for its
block.  Off, each site costs one check of the module flag `on` (and a
decorated function one more call): no clock read, no record, no profiler
call.

On, a span records its name, start and end (`time.perf_counter_ns`), the
span open around it on the same thread (its parent), its thread, and the id
of the frame or step it serves: the id given to it, else its parent's.  So
the spans of one SLAM frame carry that frame's `step_id`, and `slam.retire`
carries the id of the frame it retires, though it runs inside a later
frame's `slam.step`.  Each span is also a profiler range named `PREFIX +
name` (`torch._C._profiler._RecordFunctionFast`: the range
`torch.profiler.record_function` makes, at a twentieth of its host cost),
so a profiler that runs holds the program's spans on its own clock, beside
the device's activities.  A counter adds to
a running sum (`h2d_bytes`, `d2h_bytes`, `launches.<kernel entry>`).

On the card an adapting state replays its iteration as a CUDA graph
(`train.steps.IterationGraph`): the counters `graph.capture` and
`graph.replay` count captures and replays, and each replay counts the
`launches.<entry>` its capture recorded (`tally()`), so those counters
count every launch on the device, eager or replayed.  A replayed
iteration's span `step.iter` holds `step.graph` (the replay) and
`step.adam`; `step.decode`, `step.warp_loss` and `step.backward` fire only
where an iteration runs eagerly or is being captured.

Every thread records into a buffer of its own, in memory, until `reset()`.
`snapshot()` sums them up by name; `records()` lists the spans.  A span
never synchronises the device and never reads a device tensor: it only
reads the host's clock around work that runs as it would without it.

This module imports nothing of the package, so that any module can import
it.
"""
from __future__ import annotations

import functools
import threading
import time
from contextlib import contextmanager, nullcontext
from typing import Dict, List, NamedTuple, Optional

import torch

PREFIX = "ts:"  # the profiler ranges of the program's spans

on = False  # the one flag every site checks

_OFF = nullcontext()
_lock = threading.Lock()
_buffers: List["_Buffer"] = []
_generation = 0
_local = threading.local()
_tally: Optional[tuple] = None  # the open `tally()`'s (prefix, counts)


class Span(NamedTuple):
    name: str
    uid: Optional[int]  # the frame or step served
    start_ns: int
    end_ns: int
    parent: Optional[int]  # index of the parent span in `records()`
    thread: int  # threading.get_ident() of the thread that ran it


class _Buffer:
    def __init__(self, generation: int):
        self.generation = generation
        self.thread = threading.get_ident()
        self.spans: List[list] = []  # [name, uid, start_ns, end_ns, parent index or -1]
        self.open: List[int] = []  # indices of the spans open on this thread
        self.counters: Dict[str, int] = {}


def _buffer() -> _Buffer:
    buf = getattr(_local, "buf", None)
    if buf is None or buf.generation != _generation:
        with _lock:
            buf = _local.buf = _Buffer(_generation)
            _buffers.append(buf)
    return buf


class _Span:
    __slots__ = ("name", "uid", "buf", "index", "range")

    def __init__(self, name: str, uid: Optional[int]):
        self.name, self.uid = name, uid

    def __enter__(self):
        buf = self.buf = _buffer()
        parent = buf.open[-1] if buf.open else -1
        uid = self.uid
        if uid is None and parent >= 0:
            uid = buf.spans[parent][1]
        self.range = torch._C._profiler._RecordFunctionFast(PREFIX + self.name)
        self.range.__enter__()
        self.index = len(buf.spans)
        buf.spans.append([self.name, uid, time.perf_counter_ns(), 0, parent])
        buf.open.append(self.index)
        return self

    def __exit__(self, *exc):
        self.buf.spans[self.index][3] = time.perf_counter_ns()
        self.buf.open.pop()
        self.range.__exit__(*exc)
        return False


def span(name: str, uid: Optional[int] = None):
    """`with span(name, uid):` records the block as a span when the tracer
    is on; `uid` is the frame or step served (the parent's by default)."""
    if not on:
        return _OFF
    return _Span(name, uid)


def traced(name: str):
    """Decorator: every call of the function is a span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not on:
                return fn(*args, **kwargs)
            with _Span(name, None):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` when the tracer is on, or to the open
    `tally()`'s counts where it takes `name`.  Where working out `n` costs
    something, guard the call with `if tracing.on:`."""
    if _tally is not None and name.startswith(_tally[0]):
        with _lock:
            _tally[1][name] = _tally[1].get(name, 0) + n
    elif on:
        counters = _buffer().counters
        counters[name] = counters.get(name, 0) + n


@contextmanager
def tally(prefix: str):
    """`with tally(prefix) as counts:` gathers into the dict `counts`, in
    place of the counters, what any thread counts under a name that starts
    with `prefix` while the block runs, with the tracer on or off: the
    launches a CUDA graph's capture records (some on autograd's thread),
    which run on the device only when it is replayed.  One block at a
    time."""
    global _tally
    if _tally is not None:
        raise RuntimeError("tracing.tally() is already open")
    counts: Dict[str, int] = {}
    _tally = (prefix, counts)
    try:
        yield counts
    finally:
        _tally = None


def enable() -> None:
    global on
    on = True


def disable() -> None:
    global on
    on = False


def reset() -> None:
    """Drop every span and counter recorded so far, on every thread."""
    global _generation
    with _lock:
        _generation += 1
        _buffers.clear()


def records() -> List[Span]:
    """Every finished span, thread by thread, each thread's in start order."""
    out: List[Span] = []
    for buf in _copy():
        rows = list(buf.spans)
        done = [i for i, r in enumerate(rows) if r[3]]
        where = {i: len(out) + k for k, i in enumerate(done)}
        out.extend(Span(r[0], r[1], r[2], r[3], where.get(r[4]), buf.thread)
                   for r in (rows[i] for i in done))
    return out


def snapshot() -> dict:
    """{"spans": {name: {"total_s", "self_s", "count"}}, "counters": {name:
    sum}} over every thread; a span's self time is its time less its
    children's.  Spans still open are left out."""
    spans: Dict[str, dict] = {}
    counters: Dict[str, int] = {}
    for buf in _copy():
        rows = list(buf.spans)
        child = [0] * len(rows)
        for r in rows:
            if r[3] and r[4] >= 0:
                child[r[4]] += r[3] - r[2]
        for r, c in zip(rows, child):
            if not r[3]:
                continue
            s = spans.setdefault(r[0], {"total_s": 0.0, "self_s": 0.0, "count": 0})
            s["total_s"] += (r[3] - r[2]) / 1e9
            s["self_s"] += (r[3] - r[2] - c) / 1e9
            s["count"] += 1
        for k, v in list(buf.counters.items()):
            counters[k] = counters.get(k, 0) + v
    return {"spans": spans, "counters": counters}


def _copy() -> List[_Buffer]:
    with _lock:
        return list(_buffers)
