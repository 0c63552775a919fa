"""A configuration, a traffic mix, a per-layer metric and a cell added as
new files and new entries only, then found and run by the harness."""

import json
import shutil
import time

import pytest

from benchmark import harness, spec
from conftest import ROOT, TINY

NEW_CELL = "ihgnn-o1.train.small"


@pytest.fixture
def grown(tmp_path):
    """A copy of the benchmark that a later change has added to."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.load(ROOT)
    home = tmp_path / "benchmark"
    config = json.loads((home / "configs" / "ihgnn-o3o1-d32.json")
                        .read_text())
    config["model"]["feature_interaction_order"] = 1
    config["deployment"] = dict(TINY)
    (home / "configs" / "ihgnn-o1-tiny.json").write_text(json.dumps(config))
    traffic = json.loads((home / "traffic" / "train.json").read_text())
    traffic.update(batch_positives=8, random_negatives=2, profiled_steps=2)
    (home / "traffic" / "train.small.json").write_text(json.dumps(traffic))
    (home / "limits" / f"{NEW_CELL}.json").write_text(
        (home / "limits" / "ihgnn.train.json").read_text())
    (home / "metrics" / "steps.train.py").write_text(
        "def read(record):\n"
        "    return record.get(\"steps\")\n")
    bench["configs"].append({
        "name": "ihgnn-o1-tiny", "source": "https://example.org/tiny",
        "file": "benchmark/configs/ihgnn-o1-tiny.json", "reduced": [],
        "why": "test"})
    bench["workloads"].append({
        "name": NEW_CELL, "config": "ihgnn-o1-tiny",
        "traffic": "train.small", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_step_ms":
            m["workloads"].append(NEW_CELL)
    bench["per_layer"].append({
        "name": "steps.train", "unit": "steps", "better": "higher",
        "source": "program_counter", "layer": "train step",
        "moves": "train_step_ms", "workloads": [NEW_CELL]})
    # a metric split by cell with no file of its own: mfu.py reads it
    bench["per_layer"].append({
        "name": "mfu.small", "unit": "%", "better": "higher",
        "source": "host_clock", "layer": "model step",
        "moves": "train_step_ms", "workloads": [NEW_CELL]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


def test_new_files_are_found_by_name(grown):
    cell = spec.cell(NEW_CELL, grown)
    assert cell["config"]["model"]["feature_interaction_order"] == 1
    assert cell["traffic"]["batch_positives"] == 8
    assert "steps.train" in [m["name"] for m in cell["per_layer"]]
    assert "train_step_ms" in [m["name"] for m in cell["end_to_end"]]
    # the cells that were there report no metric of the new one
    old = spec.cell("ihgnn.train", grown)
    assert "steps.train" not in [m["name"] for m in old["per_layer"]]


@pytest.mark.parametrize("trace", [False, True])
def test_new_cell_runs(grown, trace):
    cell = spec.cell(NEW_CELL, grown)
    out = harness.run_cell(cell, 2_500_000_001, 0.3, trace, "cpu",
                           time.perf_counter(), grown)
    assert out["correct"] is True
    if trace:
        assert out["metrics"]["steps.train"]["value"] == out["attempted"]
        assert out["metrics"]["mfu.small"]["value"] > 0
    else:
        # peak_mem_gib reads the card's allocator: nothing on the CPU
        assert set(out["metrics"]) == {"train_step_ms", "setup_s"}


@pytest.mark.parametrize("metric,file", [
    ("steps.train", "steps.train.py"), ("mfu.small", "mfu.py"),
    ("host_issue_ms.gat", "host_issue_ms.py"),
    ("train_step_ms.gat", "train_step_ms.py"), ("step_ms.ihgnn", "step_ms.py"),
    ("setup_s", "setup_s.py")])
def test_reader_by_name_then_by_prefix(grown, metric, file):
    assert spec.reader_path(metric, grown).name == file


def test_step_ms_reads_the_window_step():
    record = {"kind": "train", "window_s": 2.0, "steps": 400}
    assert spec.reader("step_ms.gat", ROOT)(record) == \
        spec.reader("train_step_ms", ROOT)(record) == 5.0


def test_every_metric_has_a_reader():
    bench = spec.load(ROOT)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert spec.reader_path(m["name"], ROOT).is_file()


def test_premade_batches_replay_in_order_until_stopped():
    import threading

    import numpy as np

    from benchmark import generate
    draws = iter({"users": np.array([i])} for i in range(100))
    stop = threading.Event()
    feed = generate.premade(draws, 3, stop)
    assert [int(next(feed)["users"][0]) for _ in range(7)] == \
        [0, 1, 2, 0, 1, 2, 0]
    assert int(next(draws)["users"][0]) == 3   # drawn in set-up, no more
    stop.set()
    assert list(feed) == []
