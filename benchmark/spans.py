"""The port's spans (``ihgnn_torch/utils/tracing.py``) read from a
profiler trace: where each step's host time and each idle gap go.

``profile_spans(fn, units, sync)`` runs like ``trace.profile``: one call
of ``fn`` the profiler discards, then ``units`` calls under
``torch.profiler`` with the port's tracing on (after ``first()``, once,
when given). ``attribute`` reads the Chrome trace's ``user_annotation``
events of the port's spans, its kernels, copies and sets, and the
runtime calls that launched them, and gives per span name:

* ``host_s``: the spans' host time; ``self_s`` less their child spans';
* ``device_s``: the device time of the kernels and copies whose launch
  (matched by ``correlation``, on any thread) lies inside the span;
* ``idle_s``: the device's idle gaps whose midpoint lies inside the span
  and inside no span nested in it, among the spans of the thread that
  runs the step (the thread whose spans take the most host time);

and ``unspanned_idle_s``, the gaps in no span of that thread, with
``unspanned_gaps`` naming them by the innermost host operation at their
midpoint, as ``trace.summarize`` names every gap;
``runtime_calls``, the CUDA runtime calls that took the most host time,
each by the innermost span of its thread (where the host waits on the
card, a synchronising call shows). The profiler's
``gpu_user_annotation`` twins of the spans count as no device time, as
in ``trace.py``.

Run as a module, it runs one cell as ``benchmark.run --trace 1`` does;
after the cell's traced slice it runs, over the same calls, a span
slice, the traced slice again (tracing's cost is the span slice's
window against the two traced slices'), and ``steady_slices`` (where
the host waits once the device has a backlog). It prints the span
records and the span readers' values as one JSON line:

    python3 -m benchmark.spans --workload <name> --seed <n> --seconds <s>
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np

from benchmark.trace import DEVICE_CATS, TOP, _union

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "cuda_runtime", "python_function")
# calls before, and calls in, the steady summary (steady_slices)
STEADY_FILL, STEADY_UNITS = 20, 30
# the readers of the span slice (benchmark/metrics/<name>.py)
READERS = ("put_ms", "forward_ms", "backward_ms", "optimizer_ms",
           "feed_wait_ms", "score_ms", "topk_ms", "idle_unspanned")


def _innermost(starts: np.ndarray, ends: np.ndarray, t: float) -> int:
    """The index of the shortest interval holding ``t``, else -1."""
    cover = np.nonzero((starts <= t) & (ends >= t))[0]
    if not len(cover):
        return -1
    return int(cover[np.argmin(ends[cover] - starts[cover])])


def attribute(events: List[dict], names: Optional[Iterable[str]] = None
              ) -> Dict:
    """Span records of a trace's complete events (microseconds): the
    ``user_annotation`` events named in ``names`` (every one when None)
    are the program's spans. ``{}`` when the trace holds none."""
    keep = None if names is None else set(names)
    anns = [e for e in events if e.get("cat") == "user_annotation"
            and (keep is None or e["name"] in keep)]
    if not anns:
        return {}
    starts = np.array([e["ts"] for e in anns], np.float64)
    ends = starts + np.array([e["dur"] for e in anns], np.float64)
    tids = [e.get("tid") for e in anns]
    by: Dict[str, Dict] = {}
    for e in anns:
        r = by.setdefault(e["name"], {"count": 0, "host_s": 0.0,
                                      "self_s": 0.0, "device_s": 0.0,
                                      "idle_s": 0.0})
        r["count"] += 1
        r["host_s"] += e["dur"] / 1e6
        r["self_s"] += e["dur"] / 1e6
    of_tid = {tid: np.array([j for j, t in enumerate(tids) if t == tid])
              for tid in set(tids)}
    # a span's parent: the shortest other span of its thread holding it
    for i, e in enumerate(anns):
        holds = [j for j in of_tid[tids[i]] if j != i
                 and starts[j] <= starts[i] and ends[j] >= ends[i]]
        if holds:
            parent = min(holds, key=lambda j: (ends[j] - starts[j], -j))
            by[anns[parent]["name"]]["self_s"] -= e["dur"] / 1e6

    launched = {}
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") in LAUNCH_CATS and corr is not None:
            launched[corr] = e["ts"]
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    for e in device:
        t = launched.get(e.get("args", {}).get("correlation"))
        if t is None:
            continue
        inside = np.nonzero((starts <= t) & (ends >= t))[0]
        for name in {anns[j]["name"] for j in inside}:
            by[name]["device_s"] += e["dur"] / 1e6

    idx = max(of_tid.values(), key=lambda js: sum(anns[j]["dur"]
                                                  for j in js))
    host = [e for e in events if e.get("cat") in HOST_CATS]
    host_starts = np.array([e["ts"] for e in host], np.float64)
    host_ends = host_starts + np.array([e["dur"] for e in host], np.float64)
    busy = _union([(e["ts"], e["ts"] + e["dur"]) for e in device])
    idle = unspanned = 0.0
    outside: Dict[str, float] = {}
    for (_, a), (b, _) in zip(busy, busy[1:]):
        k = _innermost(starts[idx], ends[idx], (a + b) / 2)
        idle += b - a
        if k >= 0:
            by[anns[idx[k]]["name"]]["idle_s"] += (b - a) / 1e6
            continue
        unspanned += b - a
        j = _innermost(host_starts, host_ends, (a + b) / 2)
        op = host[j]["name"] if j >= 0 else "(no host op)"
        outside[op] = outside.get(op, 0.0) + b - a
    calls: Dict[tuple, float] = {}
    for e in events:
        if e.get("cat") not in LAUNCH_CATS:
            continue
        own = of_tid.get(e.get("tid"), np.zeros(0, np.int64))
        k = _innermost(starts[own], ends[own], e["ts"]) if len(own) else -1
        key = (anns[own[k]]["name"] if k >= 0 else "(no span)", e["name"])
        calls[key] = calls.get(key, 0.0) + e["dur"]
    window = (max(e["ts"] + e["dur"] for e in events)
              - min(e["ts"] for e in events))
    return {"window_s": window / 1e6,
            "busy_s": sum(end - start for start, end in busy) / 1e6,
            "idle_s": idle / 1e6, "unspanned_idle_s": unspanned / 1e6,
            "unspanned_gaps": [[op, t / 1e6] for op, t in sorted(
                outside.items(), key=lambda kv: -kv[1])[:TOP]],
            "by_name": by,
            "runtime_calls": [[name, call, t / 1e6] for (name, call), t in
                              sorted(calls.items(), key=lambda kv: -kv[1])
                              [:TOP]]}


def _clock_gap_us(spans: List[dict], events: List[dict], base_us: float
                  ) -> Optional[float]:
    """The largest gap between a recorded span's start (``tracing``'s
    clock conversion) and its annotation's ``ts + baseTimeNanoseconds /
    1e3``, spans matched by name and order."""
    starts: Dict[str, List[float]] = {}
    for e in sorted((e for e in events if e.get("cat") == "user_annotation"),
                    key=lambda e: e["ts"]):
        starts.setdefault(e["name"], []).append(e["ts"] + base_us)
    seen: Dict[str, int] = {}
    gaps = []
    for s in sorted(spans, key=lambda s: s["start_us"]):
        k = seen.get(s["name"], 0)
        seen[s["name"]] = k + 1
        if k < len(starts.get(s["name"], [])):
            gaps.append(abs(s["start_us"] - starts[s["name"]][k]))
    return max(gaps) if gaps else None


def profile_spans(fn: Callable[[], None], units: int,
                  sync: Callable[[], None],
                  first: Optional[Callable[[], None]] = None) -> Dict:
    """``attribute`` of ``units`` calls of ``fn`` (after ``first()``,
    once, when given) under ``torch.profiler`` with the port's tracing on,
    after one call the profiler discards; the device is synchronised
    before the first recorded call and after the last. With ``units``
    and ``clock_gap_us`` (``_clock_gap_us``) beside it."""
    from torch.profiler import ProfilerActivity, profile as torch_profile
    from torch.profiler import schedule

    from ihgnn_torch.utils import tracing

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "spans.trace.json")
        with torch_profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                schedule=schedule(wait=0, warmup=1, active=1),
                on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
            fn()
            sync()
            prof.step()
            tracing.enable()
            try:
                if first is not None:
                    first()
                for _ in range(units):
                    fn()
                sync()
            finally:
                tracing.disable()
            prof.step()
        spans = tracing.snapshot()["spans"]
        with open(path, encoding="utf-8") as f:
            trace = json.load(f)
    events = [e for e in trace["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    out = attribute(events, {s["name"] for s in spans})
    if out:
        out["units"] = units
        out["clock_gap_us"] = _clock_gap_us(
            spans, events, trace.get("baseTimeNanoseconds", 0) / 1e3)
    return out


def steady_slices(fn: Callable[[], None], units: int,
                  sync: Callable[[], None]) -> Dict:
    """Where the host waits once the device has a backlog, as in a
    window: ``STEADY_FILL`` untraced calls of ``fn``, then the port's
    in-memory span summary (``tracing.summary``, no profiler) over
    ``STEADY_UNITS`` calls (``summary``, with ``units``), then a span
    slice of ``units`` calls with no synchronise before it
    (``profiled``), then a synchronise."""
    from ihgnn_torch.utils import tracing

    for _ in range(STEADY_FILL):
        fn()
    tracing.enable()
    try:
        for _ in range(STEADY_UNITS):
            fn()
    finally:
        tracing.disable()
    out = {"units": STEADY_UNITS, "summary": tracing.summary(),
           "profiled": profile_spans(fn, units, lambda: None)}
    sync()
    return out


def per_unit(record: dict, name: str, key: str) -> Optional[float]:
    """``key`` of span ``name`` in the record's span slice, in ms a unit
    (train step or rank batch); None without the slice or the span."""
    sp = record.get("spans")
    if not sp or name not in sp["by_name"]:
        return None
    return sp["by_name"][name][key] / sp["units"] * 1e3


def run_cell(cell: dict, seed: int, seconds: float, device: str = "cuda",
             root=None) -> Dict:
    """One traced run of the resolved ``cell`` (``spec.cell``) as
    ``benchmark.run --trace 1`` makes it, with a span slice after the
    cell's traced slice over the same calls (a ranking slice starts with
    one refresh). Its span records, the span readers' values under the
    cell's suffix (that of its ``device_idle`` entry), the result's
    per-layer metrics, ``correct`` and device, and each slice's window a
    unit."""
    import time

    from benchmark import harness, program, spec, trace

    started = time.perf_counter()
    root = spec.ROOT if root is None else root
    slices, made = {}, {}
    profile, make_eval = trace.profile, program.make_eval

    def both(fn, units, sync):
        out = profile(fn, units, sync)
        slices["trace"] = out
        slices["spans"] = profile_spans(fn, units, sync,
                                        made.get("features_fn"))
        slices["trace_again"] = profile(fn, units, sync)
        slices["steady"] = steady_slices(fn, units, sync)
        return out

    def keep(*args, **kw):
        made["features_fn"], metrics_fn = make_eval(*args, **kw)
        return made["features_fn"], metrics_fn

    trace.profile, program.make_eval = both, keep
    try:
        result = harness.run_cell(cell, seed, seconds, True, device,
                                  started, root)
    finally:
        trace.profile, program.make_eval = profile, make_eval
    record = {"kind": cell["traffic"]["kind"], "spans": slices["spans"]}
    suffix = [m["name"].split(".", 1)[1] for m in cell["per_layer"]
              if m["name"].startswith("device_idle.")][0]
    values = {}
    for name in READERS:
        value = spec.reader(name, root)(record)
        if value is not None:
            values[f"{name}.{suffix}"] = value
    sp = slices["spans"]
    unit_ms = {k: slices[k]["window_s"] / slices[k]["units"] * 1e3
               for k in ("trace", "spans", "trace_again") if slices[k]}
    return {"workload": cell["name"], "seed": seed,
            "correct": result["correct"], "device": result["device"],
            "span_metrics": values, "metrics": result["metrics"],
            "unit_ms": unit_ms, "spans": sp, "steady": slices["steady"]}


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    import torch

    from benchmark import spec
    if not torch.cuda.is_available():
        print("benchmark.spans: no CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    out = run_cell(spec.cell(args.workload), args.seed, args.seconds)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
