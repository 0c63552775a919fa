"""The command of ``BENCHMARK.json``: it prints no result without a card or
without the program, and on a card prints the contract's last line."""

import json
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT

COMMAND = json.loads((ROOT / "BENCHMARK.json").read_text())["command"]
WORKLOADS = [w["name"] for w in
             json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _run(cwd, workload, trace=0, seconds=2, timeout=1200):
    argv = [sys.executable] + COMMAND[1:] + [
        "--workload", workload, "--seed", "2147483999", "--seconds",
        str(seconds), "--trace", str(trace)]
    return subprocess.run(argv, cwd=cwd, capture_output=True, text=True,
                          timeout=timeout)


def _has_result(stdout: str) -> bool:
    lines = stdout.strip().splitlines()
    return bool(lines) and lines[-1].startswith("{")


def test_no_result_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run(ROOT, WORKLOADS[0])
    assert out.returncode != 0
    assert not _has_result(out.stdout)


def test_no_result_without_the_program(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = _run(tmp_path, WORKLOADS[0])
    assert out.returncode != 0
    assert not _has_result(out.stdout)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card(card, workload, trace):
    out = _run(ROOT, workload, trace)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(result)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in result
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu"
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        assert "breakdown" in result
    else:
        assert "setup_s" in result["metrics"]
