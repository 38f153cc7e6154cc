"""The port's recorder: spans and counters, and ``torch.profiler`` traces.

A layer of the program wraps its work in :func:`span` and counts events
with :func:`count`.  A span keeps its name, its host start and end on
``time.perf_counter()``, its thread, its id, its parent's id (the span
open on the same thread around it) and its trace id: the root span's id,
or the ``trace=`` given where work crosses threads (a served request).
The last :data:`RING` spans of each name are kept in memory, beside a
running count and total per name; :func:`count` keeps a running total and
the last :data:`RING` counts with their times.  :func:`spans` and
:func:`counters` read them back (within a window of the host clock, if
given), :func:`report` sums them per name, :func:`write` dumps them as
JSON and :func:`reset` clears them.

``device=True`` also records a CUDA timing-event pair around the span on
the current stream, once CUDA is initialised; it is resolved when read
(:meth:`Span.device_ms`), never on the hot path.  While a
``torch.profiler`` is active, and only then, a span also enters
``torch.profiler.record_function(name)``, so it sits on the profiler's
host timeline beside the ops it issues.  Otherwise a span costs two clock
reads and an append.

:func:`trace` captures a ``torch.profiler`` trace of a block (the
reference's ``jax.profiler`` one) as ``trace.json`` in ``log_dir``, and
the spans recorded in the block as ``spans.json`` beside it.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import deque
from threading import get_ident
from time import perf_counter

import torch
import torch.autograd.profiler as _autograd_profiler

RING = 4096  # spans (and counts) kept per name

_lock = threading.Lock()
_rings: dict[str, deque] = {}
_totals: dict[str, list] = {}        # name -> [count, total host s]
_count_rings: dict[str, deque] = {}  # name -> deque of (time, n)
_count_totals: dict[str, float] = {}
_ids = itertools.count(1)
_local = threading.local()



def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class Span:
    """One span: a context manager while open, a record once closed."""

    __slots__ = ("name", "start", "end", "thread", "id", "parent", "trace",
                 "start_event", "end_event", "_device", "_rf", "_stream")

    def __init__(self, name: str, device: bool = False, trace=None):
        self.name = name
        self.trace = trace
        self._device = device
        self.start = self.end = None
        self.start_event = self.end_event = self._rf = self._stream = None

    def __enter__(self) -> Span:
        try:
            stack = _local.stack
        except AttributeError:
            stack = _local.stack = []
        self.id = next(_ids)
        self.thread = get_ident()
        if stack:
            self.parent = stack[-1].id
            if self.trace is None:
                self.trace = stack[-1].trace
        else:
            self.parent = None
        if self.trace is None:
            self.trace = self.id
        if _autograd_profiler._is_profiler_enabled:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        if self._device and torch.cuda.is_initialized():
            # one stream lookup serves both records (it costs as much as
            # a record)
            self._stream = torch.cuda.current_stream()
            self.start_event = torch.cuda.Event(enable_timing=True)
            self.end_event = torch.cuda.Event(enable_timing=True)
            self.start_event.record(self._stream)
        stack.append(self)
        self.start = perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.end = perf_counter()
        if self.end_event is not None:
            self.end_event.record(self._stream)
            self._stream = None
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        stack = _local.stack
        if stack and stack[-1] is self:
            stack.pop()
        _keep(self)

    @property
    def host_ms(self) -> float:
        return (self.end - self.start) * 1e3

    def device_ms(self) -> float | None:
        """Device ms between the span's events (waits for the end event),
        or None without them."""
        if self.end_event is None:
            return None
        self.end_event.synchronize()
        return self.start_event.elapsed_time(self.end_event)

    def as_dict(self) -> dict:
        return {"name": self.name, "start": self.start, "end": self.end,
                "thread": self.thread, "id": self.id, "parent": self.parent,
                "trace": self.trace, "device_ms": self.device_ms()}


def _keep(s: Span) -> None:
    ring = _rings.get(s.name)
    if ring is None:
        ring = _rings.setdefault(s.name, deque(maxlen=RING))
    ring.append(s)
    dt = s.end - s.start
    with _lock:
        tot = _totals.get(s.name)
        if tot is None:
            _totals[s.name] = [1, dt]
        else:
            tot[0] += 1
            tot[1] += dt


def span(name: str, *, device: bool = False, trace=None) -> Span:
    """A span named ``name`` around a ``with`` block (see the module's
    docstring); ``trace``: the trace id to join, where the work belongs to
    a trace begun on another thread."""
    return Span(name, device, trace)


def record(name: str, start: float, end: float | None = None, *,
           trace=None) -> Span:
    """Keep a host span measured after the fact, from ``start`` to ``end``
    (default now), both on ``time.perf_counter()``: for an interval that
    begins in one call and ends in another, or on another thread.  It has
    no device events and no place on the profiler's timeline."""
    s = Span(name, trace=trace)
    stack = _stack()
    s.id = next(_ids)
    s.thread = threading.get_ident()
    s.parent = stack[-1].id if stack else None
    if s.trace is None:
        s.trace = stack[-1].trace if stack else s.id
    s.start = start
    s.end = time.perf_counter() if end is None else end
    _keep(s)
    return s


def current() -> Span | None:
    """The innermost span open on this thread, or None."""
    stack = _stack()
    return stack[-1] if stack else None


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    t = time.perf_counter()
    ring = _count_rings.get(name)
    if ring is None:
        ring = _count_rings.setdefault(name, deque(maxlen=RING))
    ring.append((t, n))
    with _lock:
        _count_totals[name] = _count_totals.get(name, 0) + n


def _inside(t0, t1):
    lo = -float("inf") if t0 is None else t0
    hi = float("inf") if t1 is None else t1
    return lo, hi


def spans(name: str, t0: float | None = None,
          t1: float | None = None) -> list[Span]:
    """The kept spans of ``name`` that started at or after ``t0`` and
    ended at or before ``t1`` (host clock), oldest first."""
    lo, hi = _inside(t0, t1)
    return [s for s in list(_rings.get(name, ()))
            if s.start >= lo and s.end <= hi]


def counters(t0: float | None = None,
             t1: float | None = None) -> dict[str, float]:
    """Each counter's running total; with a window, the sum of its kept
    counts made inside ``[t0, t1]``."""
    if t0 is None and t1 is None:
        with _lock:
            return dict(_count_totals)
    lo, hi = _inside(t0, t1)
    return {k: sum(n for t, n in list(ring) if lo <= t <= hi)
            for k, ring in list(_count_rings.items())}


def report() -> dict[str, dict]:
    """``{name: {"total_s", "count", "mean_s"}}`` of every span name since
    the last :func:`reset` (running totals, not bounded by the ring)."""
    with _lock:
        return {k: {"total_s": tot, "count": n, "mean_s": tot / n}
                for k, (n, tot) in _totals.items()}


def reset() -> None:
    """Forget every span and counter."""
    with _lock:
        _rings.clear()
        _totals.clear()
        _count_rings.clear()
        _count_totals.clear()


def write(path: str, t0: float | None = None, t1: float | None = None):
    """Dump the kept spans (within ``[t0, t1]``) and the counters as JSON
    to ``path``: ``{"spans": [...], "counters": {...}}``."""
    out = [s.as_dict() for name in list(_rings) for s in spans(name, t0, t1)]
    out.sort(key=lambda d: d["start"])
    with open(path, "w") as f:
        json.dump({"spans": out, "counters": counters()}, f)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block (CPU, and CUDA when a GPU is present)
    and write ``log_dir/trace.json`` (Chrome trace format) and the spans
    recorded in the block, ``log_dir/spans.json`` (also on error); yields
    the ``torch.profiler.profile``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    t0 = time.perf_counter()
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
        write(os.path.join(log_dir, "spans.json"), t0, time.perf_counter())
