"""Spans and counters inside the port.

A span names a phase of the program where the work happens
(``train.forward``, ``features.layer0``, ``eval.topk``, ``feed.wait``...).
Tracing is off unless a profiler window turns it on (``enable``): the
CLI's ``--profile_dir`` epoch, ``chip_smoke.py``'s profile windows and
the benchmark's span slice (``benchmark/spans.py``). Off, ``span``
returns one shared no-op context after a single flag test. On, it opens
``torch.profiler.record_function(name)``, so that an active profiler
shows the span as a ``user_annotation`` event on the kernels' clock, and
keeps the span in ``SPANS``.

Spans are stamped with ``time.perf_counter_ns`` and written out
(``snapshot``) in microseconds on the clock of a ``torch.profiler``
Chrome trace, whose ``ts + baseTimeNanoseconds / 1e3`` reads
``time.time_ns() / 1e3``: the offset between the two clocks is taken at
``enable``.

A counter (``count``) is a plain integer that is always counted, like
the kernel wrappers' ``launches`` (``ops/launches.py``).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional

import torch

# while tracing is on (enable), one list a span, appended when it opens:
# [name, start_ns, end_ns (None while open), parent, unit, thread] on the
# perf_counter_ns clock; parent is the index in SPANS of the enclosing span
# on the same thread (None at the top), unit the step or batch number that
# the spans of one step or batch share, thread the OS thread id (the
# ``tid`` of a profiler trace)
SPANS: list = []
_ON = [False]
# time_ns() - perf_counter_ns() at enable()
_OFFSET_NS = [0]
# always counted; never cleared
COUNTERS: Dict[str, int] = {}

_LOCK = threading.Lock()
_OPEN = threading.local()
_OFF = contextlib.nullcontext()


def _thread_state():
    """This thread's stack of open spans and its OS thread id, read once
    a thread: ``gettid`` is a system call, several µs on some hosts."""
    try:
        return _OPEN.stack, _OPEN.thread
    except AttributeError:
        _OPEN.stack, _OPEN.thread = [], threading.get_native_id()
        return _OPEN.stack, _OPEN.thread


class _Span:
    __slots__ = ("name", "unit", "annotation", "index")

    def __init__(self, name: str, unit: Optional[int]):
        self.name, self.unit = name, unit

    def __enter__(self):
        stack, thread = _thread_state()
        parent = stack[-1] if stack else None
        unit = self.unit
        if unit is None and parent is not None:
            unit = SPANS[parent][4]
        self.annotation = torch.profiler.record_function(self.name)
        self.annotation.__enter__()
        with _LOCK:
            SPANS.append([self.name, time.perf_counter_ns(), None, parent,
                          unit, thread])
            self.index = len(SPANS) - 1
        stack.append(self.index)
        return self

    def __exit__(self, *exc):
        SPANS[self.index][2] = time.perf_counter_ns()
        _thread_state()[0].pop()
        self.annotation.__exit__(*exc)
        return False


def span(name: str, unit: Optional[int] = None):
    """A context that records the phase ``name`` while tracing is on.
    ``unit``: the step or batch number; a span given none takes its
    enclosing span's."""
    if not _ON[0]:
        return _OFF
    return _Span(name, unit)


def count(name: str, n: int = 1) -> None:
    COUNTERS[name] = COUNTERS.get(name, 0) + n


def _clock_offset_ns() -> int:
    """``time_ns() - perf_counter_ns()`` from the tightest of a few
    bracketed reads: a read cut by the scheduler would shift every span."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        wall = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, wall - (a + b) // 2)
    return best[1]


def enable() -> None:
    """Start recording spans (clearing ``SPANS``)."""
    with _LOCK:
        SPANS.clear()
        _OFFSET_NS[0] = _clock_offset_ns()
    _ON[0] = True


def disable() -> None:
    _ON[0] = False


def snapshot() -> Dict:
    """The spans recorded since ``enable`` (each ``name``, ``start_us``,
    ``end_us`` on the profiler trace's clock, ``parent``, ``unit``,
    ``thread``; a span still open has ``end_us`` None), the counters, and
    the kernel wrappers' launch counts (``ops.launches.launch_counts``)."""
    from ihgnn_torch.ops.launches import launch_counts
    off = _OFFSET_NS[0]
    with _LOCK:
        spans = [{"name": name, "start_us": (start + off) / 1e3,
                  "end_us": None if end is None else (end + off) / 1e3,
                  "parent": parent, "unit": unit, "thread": thread}
                 for name, start, end, parent, unit, thread in SPANS]
    return {"spans": spans, "counters": dict(COUNTERS),
            "launches": launch_counts()}


def summary() -> Dict[str, Dict]:
    """Per span name of the closed spans since ``enable``: ``count``,
    ``host_s`` (the spans' time) and ``self_s`` (less the time of their
    child spans)."""
    with _LOCK:
        spans = [list(s) for s in SPANS]
    child_ns: List[int] = [0] * len(spans)
    for name, start, end, parent, _, _ in spans:
        if end is not None and parent is not None:
            child_ns[parent] += end - start
    out: Dict[str, Dict] = {}
    for (name, start, end, _, _, _), inner in zip(spans, child_ns):
        if end is None:
            continue
        s = out.setdefault(name, {"count": 0, "host_s": 0.0, "self_s": 0.0})
        s["count"] += 1
        s["host_s"] += (end - start) / 1e9
        s["self_s"] += (end - start - inner) / 1e9
    return out
