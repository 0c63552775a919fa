"""``benchmark/spans.py``: the span records of a hand-built trace, a span
slice on the CPU, and the span readers on records without a slice."""

import pytest

from benchmark import spans, spec
from ihgnn_torch.utils import tracing

STEP, AUTOGRAD = 1, 2


def _x(cat, name, ts, dur, tid=STEP, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 0, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


# microseconds: a step [0, 100] holding put [5, 15], forward [20, 60] and
# backward [60, 85], whose kernel autograd's thread launches inside a
# collective span of its own; then the feed's wait [105, 115]; kernels
# [10, 20] [30, 50] [80, 110] [130, 135]; the profiler's step annotation
# and a device twin of the step span, which are no program span and no
# device time; a host op outside the spans at [116, 124]
EVENTS = [
    _x("user_annotation", "ProfilerStep#1", 0, 140),
    _x("user_annotation", "train.step", 0, 100),
    _x("user_annotation", "train.put", 5, 10),
    _x("user_annotation", "train.forward", 20, 40),
    _x("user_annotation", "train.backward", 60, 25),
    _x("user_annotation", "feed.wait", 105, 10),
    _x("user_annotation", "collective.all-reduce.grad:x", 68, 5, AUTOGRAD),
    _x("user_annotation", "collective.all-reduce.loss", 118, 4, AUTOGRAD),
    _x("cuda_runtime", "cudaLaunchKernel", 6, 1, corr=1),
    _x("cuda_runtime", "cudaLaunchKernel", 25, 1, corr=2),
    _x("cuda_runtime", "cudaLaunchKernel", 70, 1, AUTOGRAD, corr=3),
    _x("cuda_runtime", "cudaMemcpyAsync", 125, 1, corr=4),
    _x("kernel", "k1", 10, 10, tid=7, corr=1),
    _x("kernel", "k2", 30, 20, tid=7, corr=2),
    _x("kernel", "k3", 80, 30, tid=7, corr=3),
    _x("gpu_memcpy", "copy", 130, 5, tid=7, corr=4),
    _x("gpu_user_annotation", "train.step", 0, 135, tid=7),
    _x("cpu_op", "aten::copy_", 116, 8),
]
NAMES = ("train.step", "train.put", "train.forward", "train.backward",
         "feed.wait", "collective.all-reduce.grad:x",
         "collective.all-reduce.loss")


def test_attribution_of_a_hand_built_trace():
    out = spans.attribute(EVENTS, NAMES)
    by = {k: {m: v if m == "count" else round(v * 1e6, 6)
              for m, v in r.items()} for k, r in out["by_name"].items()}
    assert set(by) == set(NAMES)
    assert by["train.step"] == {"count": 1, "host_s": 100, "self_s": 25,
                                "device_s": 60, "idle_s": 0}
    assert by["train.put"] == {"count": 1, "host_s": 10, "self_s": 10,
                               "device_s": 10, "idle_s": 0}
    # the gap [20, 30] lies in the forward, [50, 80] in the backward
    assert by["train.forward"]["device_s"] == 20
    assert by["train.forward"]["idle_s"] == 10
    assert by["train.backward"]["device_s"] == 30
    assert by["train.backward"]["idle_s"] == 30
    assert by["collective.all-reduce.grad:x"]["device_s"] == 30
    # [110, 130]: past the wait, in another thread's span only
    assert by["collective.all-reduce.loss"]["idle_s"] == 0
    assert by["feed.wait"]["device_s"] == 0
    assert out["idle_s"] * 1e6 == pytest.approx(60)
    assert out["unspanned_idle_s"] * 1e6 == pytest.approx(20)
    assert [op for op, _ in out["unspanned_gaps"]] == ["aten::copy_"]
    assert out["busy_s"] * 1e6 == pytest.approx(65)
    assert out["window_s"] * 1e6 == pytest.approx(140)
    assert sorted((n, c, round(t * 1e6, 6))
                  for n, c, t in out["runtime_calls"]) == [
        ("(no span)", "cudaMemcpyAsync", 1),
        ("collective.all-reduce.grad:x", "cudaLaunchKernel", 1),
        ("train.forward", "cudaLaunchKernel", 1),
        ("train.put", "cudaLaunchKernel", 1)]
    record = {"kind": "train", "spans": dict(out, units=2)}
    assert spec.reader("put_ms.train")(record) == pytest.approx(0.005)
    assert spec.reader("backward_ms.train")(record) == pytest.approx(0.0125)
    assert spec.reader("idle_unspanned.train")(record) == \
        pytest.approx(100 / 3)
    assert spans.attribute(EVENTS, ["eval.batch"]) == {}


def test_a_span_slice_on_the_cpu():
    import torch
    x = torch.ones(64, 64)

    def fn():
        with tracing.span("train.step", 0):
            with tracing.span("train.forward"):
                (x @ x).sum()
    out = spans.profile_spans(fn, 3, lambda: None)
    assert out["units"] == 3
    assert out["by_name"]["train.step"]["count"] == 3
    assert out["by_name"]["train.forward"]["count"] == 3
    # the largest gap; tests/test_torch_tracing.py holds the median to 1 ms
    assert out["clock_gap_us"] < 20e3
    assert not tracing._ON[0]


@pytest.mark.parametrize("reader", spans.READERS)
@pytest.mark.parametrize("kind", ["train", "rank"])
def test_readers_find_nothing_without_a_span_slice(reader, kind):
    assert spec.reader(reader)({"kind": kind}) is None


@pytest.mark.parametrize("workload", ["ihgnn.train", "ihgnn.rank"])
def test_a_tiny_cell_with_its_span_slice(workload):
    from conftest import tiny
    out = spans.run_cell(tiny(workload), seed=2**31 + 5, seconds=0.5,
                         device="cpu")
    assert out["correct"]
    names = set(out["spans"]["by_name"])
    if workload == "ihgnn.train":
        assert {"train.step", "train.put", "train.forward", "train.backward",
                "train.optimizer", "feed.wait", "features.layer1"} <= names
        want = {f"{r}.ihgnn" for r in ("put_ms", "forward_ms", "backward_ms",
                                       "optimizer_ms", "feed_wait_ms")}
    else:
        assert {"eval.refresh", "eval.batch", "eval.put", "eval.score",
                "eval.topk", "eval.metrics", "features.embed"} <= names
        assert out["spans"]["by_name"]["eval.batch"]["count"] == \
            out["spans"]["units"]
        want = {"put_ms.eval", "score_ms.eval", "topk_ms.eval"}
    # no device events on the CPU: device times read 0, idle nothing
    assert set(out["span_metrics"]) == want
