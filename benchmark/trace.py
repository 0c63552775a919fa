"""A bounded profiler window and what the benchmark reads from its trace.

``profile(fn, units, sync)`` runs ``fn`` ``units + 1`` times under
``torch.profiler`` (the first call a warm-up the profiler discards), writes
the Chrome trace under ``TMPDIR``, reads it and deletes it. From the
trace: the device's busy time (the union of its kernel, copy and set
spans), the window (first to last event of the recorded calls), the
device operations that took the most time, and the longest idle gaps of
the device, each named by the innermost host operation running at its
middle.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Callable, Dict, List, Tuple

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for start, end in sorted(spans):
        if merged and start <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], end))
        else:
            merged.append((start, end))
    return merged


def summarize(events: List[dict]) -> Dict:
    """Busy seconds, window seconds and the breakdown of a trace's
    complete events (timestamps in microseconds)."""
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    if not device:
        return {}
    window = (max(e["ts"] + e["dur"] for e in events)
              - min(e["ts"] for e in events))
    busy_spans = _union([(e["ts"], e["ts"] + e["dur"]) for e in device])
    busy = sum(end - start for start, end in busy_spans)
    by_op: Dict[str, float] = {}
    for e in device:
        by_op[e["name"]] = by_op.get(e["name"], 0.0) + e["dur"]
    host = [e for e in events
            if e.get("cat") in ("cpu_op", "cuda_runtime", "python_function")]
    starts = np.array([e["ts"] for e in host], np.float64)
    durs = np.array([e["dur"] for e in host], np.float64)
    gaps: Dict[str, float] = {}
    for (_, a), (b, _) in zip(busy_spans, busy_spans[1:]):
        mid = (a + b) / 2
        cover = np.nonzero((starts <= mid) & (starts + durs >= mid))[0]
        name = (host[cover[np.argmin(durs[cover])]]["name"] if len(cover)
                else "(no host op)")
        gaps[name] = gaps.get(name, 0.0) + (b - a)
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy / 1e6, "window_s": window / 1e6,
            "device_ops": [[k[:120], v / 1e6] for k, v in top],
            "idle_gaps": [[k[:120], v / 1e6] for k, v in idle]}


def profile(fn: Callable[[], None], units: int, sync: Callable[[], None]
            ) -> Dict:
    """``summarize`` of ``units`` calls of ``fn`` in a row, as the window
    runs them, after one call the profiler discards; the device is
    synchronised before the first recorded call and after the last. With
    ``units`` beside it; ``{}`` when the trace holds no device event."""
    from torch.profiler import ProfilerActivity, profile as torch_profile
    from torch.profiler import schedule

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "window.trace.json")
        with torch_profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                schedule=schedule(wait=0, warmup=1, active=1),
                on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
            fn()
            sync()
            prof.step()
            for _ in range(units):
                fn()
            sync()
            prof.step()
        with open(path, encoding="utf-8") as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("ph") == "X" and "dur" in e]
    out = summarize(events)
    if out:
        out["units"] = units
    return out
