"""The port's spans and counters (``ihgnn_torch/utils/tracing.py``) on the
CPU: the trees a train step, a refresh and an eval batch record, the
feed's counters, a step's bits with tracing on and off, and the spans'
clock against a ``torch.profiler`` trace."""

import itertools
import json
import statistics

import numpy as np
import pytest
import torch

from ihgnn_torch.config import ModelConfig, TrainConfig
from ihgnn_torch.data.dataset import Batch, prefetch
from ihgnn_torch.graph import build_hypergraph
from ihgnn_torch.models.rawgnn import RawGnn
from ihgnn_torch.train.eval import make_eval_fns
from ihgnn_torch.train.train import make_optimizer, make_train_step
from ihgnn_torch.utils import tracing

U, Q, I, V, E, D = 20, 12, 30, 25, 150, 8
ROWS = 24

FORWARD = [("features.embed", []), ("features.layer0", []),
           ("features.layer1", []), ("features.concat", [])]
STEP = ("train.step", [("train.optimizer", []), ("train.put", []),
                       ("train.forward", FORWARD), ("train.backward", []),
                       ("train.optimizer", [])])


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    uqi = np.stack([rng.integers(0, U, E), rng.integers(0, Q, E),
                    rng.integers(0, I, E)], 1)
    words = rng.integers(0, V + 1, (Q, 3))
    counts = (words > 0).sum(1)
    batches = [Batch(users=rng.integers(0, U, ROWS).astype(np.int32),
                     queries=rng.integers(0, Q, ROWS).astype(np.int32),
                     items=rng.integers(0, I, ROWS).astype(np.int32),
                     flags=(rng.random(ROWS) < 0.3).astype(np.float32),
                     weight=np.ones(ROWS, np.float32)) for _ in range(2)]
    return build_hypergraph(uqi, U + Q + I, U, Q), words, counts, batches


def _model():
    return RawGnn(ModelConfig(embedding_size=D), U, Q, I, V)


def _step(inputs, model):
    graph, words, counts, _ = inputs
    opt = make_optimizer(model.parameters(), TrainConfig())
    return make_train_step(model, graph, words, counts, opt, device="cpu")


@pytest.fixture
def traced():
    tracing.enable()
    try:
        yield
    finally:
        tracing.disable()


def _tree(spans, parent=None):
    """The spans under ``parent`` as (name, children), in order."""
    return [(s["name"], _tree(spans, k)) for k, s in enumerate(spans)
            if s["parent"] == parent]


def test_off_records_nothing(inputs):
    tracing.enable()
    tracing.disable()
    _step(inputs, _model())(inputs[3][0])
    assert tracing.snapshot()["spans"] == []
    assert tracing.span("train.step") is tracing.span("eval.batch")


def test_a_train_step_records_its_tree(inputs, traced):
    step = _step(inputs, _model())
    step(inputs[3][0])
    step(inputs[3][1])
    snap = tracing.snapshot()
    spans = snap["spans"]
    assert _tree(spans) == [STEP, STEP]
    top = [k for k, s in enumerate(spans) if s["parent"] is None]
    for unit, (a, b) in enumerate(zip(top, top[1:] + [len(spans)])):
        assert {s["unit"] for s in spans[a:b]} == {unit}
    assert all(s["end_us"] >= s["start_us"] for s in spans)
    assert "launches" in snap and "counters" in snap
    summary = tracing.summary()
    assert summary["train.step"]["count"] == 2
    assert summary["train.optimizer"]["count"] == 4
    inner = sum(summary[n]["host_s"] for n in (
        "train.optimizer", "train.put", "train.forward", "train.backward"))
    assert summary["train.step"]["self_s"] == pytest.approx(
        summary["train.step"]["host_s"] - inner, abs=1e-9)
    assert summary["train.forward"]["self_s"] <= \
        summary["train.forward"]["host_s"]


def test_refresh_and_eval_batch_record_their_trees(inputs, traced):
    graph, words, counts, _ = inputs
    features_fn, metrics_fn = make_eval_fns(_model(), graph, words, counts,
                                            device="cpu")
    feats = features_fn()
    truth = np.array([[1, 2], [3, -1], [4, 5]], np.int32)
    for _ in range(2):
        metrics_fn(feats, np.array([0, 1, 2]), np.array([3, 4, 5]), truth,
                   np.array([2, 1, 2]))
    batch = ("eval.batch", [("eval.put", []), ("eval.score", []),
                            ("eval.put", []), ("eval.topk", []),
                            ("eval.metrics", [])])
    spans = tracing.snapshot()["spans"]
    assert _tree(spans) == [("eval.refresh", FORWARD), batch, batch]
    assert [s["unit"] for s in spans if s["name"] == "eval.batch"] == [0, 1]


def test_prefetch_counts_and_waits(traced):
    before = dict(tracing.COUNTERS)
    taken = list(itertools.islice(prefetch(iter(range(5))), 3))
    assert taken == [0, 1, 2]
    assert tracing.COUNTERS["feed.batches"] - before.get("feed.batches",
                                                         0) == 3
    waited = tracing.COUNTERS.get("feed.waited", 0) - before.get(
        "feed.waited", 0)
    assert 0 <= waited <= 3
    names = [s["name"] for s in tracing.snapshot()["spans"]]
    assert names == ["feed.wait"] * 3


def test_tracing_leaves_the_step_bit_for_bit(inputs):
    runs = []
    for on in (False, True):
        (tracing.enable if on else tracing.disable)()
        try:
            model = _model()
            step = _step(inputs, model)
            losses = [step(b) for b in inputs[3]]
        finally:
            tracing.disable()
        runs.append((losses, [p.detach().clone()
                              for p in model.parameters()]))
    (off_losses, off_params), (on_losses, on_params) = runs
    assert all(torch.equal(a, b) for a, b in zip(off_losses, on_losses))
    assert all(torch.equal(a, b) for a, b in zip(off_params, on_params))


def test_spans_are_the_profilers_annotations(inputs, tmp_path):
    from torch.profiler import ProfilerActivity, profile
    step = _step(inputs, _model())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tracing.enable()
        try:
            step(inputs[3][0])
        finally:
            tracing.disable()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = trace.get("baseTimeNanoseconds", 0) / 1e3
    events = {}
    for e in sorted((e for e in trace["traceEvents"]
                     if e.get("cat") == "user_annotation"),
                    key=lambda e: e["ts"]):
        events.setdefault(e["name"], []).append(e["ts"] + base)
    spans = tracing.snapshot()["spans"]
    assert spans
    gaps = []
    for name in {s["name"] for s in spans}:
        mine = [s["start_us"] for s in spans if s["name"] == name]
        assert len(events.get(name, [])) == len(mine), name
        gaps += [abs(a - b) for a, b in zip(mine, events[name])]
    # the clocks agree to 1 ms; one span's stamp may lie a time slice from
    # its annotation's when the scheduler cuts in between on a loaded host
    assert statistics.median(gaps) < 1e3, gaps
    assert max(gaps) < 20e3, gaps


def test_build_counts_the_libraries_it_finds(tmp_path, monkeypatch):
    from ihgnn_torch.ops import _build
    lib = tmp_path / "segsum.so"
    lib.write_bytes(b"")
    monkeypatch.setattr(_build, "library_path", lambda stem: lib)
    before = dict(tracing.COUNTERS)
    assert _build.build(("segsum",)) == {"segsum": lib}
    assert tracing.COUNTERS["kernels.loaded"] == \
        before.get("kernels.loaded", 0) + 1
    assert tracing.COUNTERS.get("kernels.compiled", 0) == \
        before.get("kernels.compiled", 0)
