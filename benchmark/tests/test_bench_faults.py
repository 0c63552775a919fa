"""A run with a fault planted under the timed path comes out not correct,
and the same run without it correct. The harness's look for a card is
skipped: the run is driven on the CPU at a tiny size."""

import time

import pytest

from benchmark import faults, harness
from conftest import tiny

CASES = [(cell, fault) for cell, kind in (("ihgnn.train", "train"),
                                          ("gat.train", "train"),
                                          ("ihgnn.rank", "rank"))
         for fault in faults.FAULTS[kind]]


def _run(cell, fault):
    return harness.run_cell(tiny(cell), 3_141_592_653, 0.2, False, "cpu",
                            time.perf_counter(), fault=fault)


@pytest.mark.parametrize("cell", ["ihgnn.train", "gat.train", "ihgnn.rank",
                                  "ihgnn.train.zipf"])
def test_sound_run_is_correct(cell):
    assert _run(cell, None)["correct"] is True


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_caught(cell, fault):
    out = _run(cell, fault)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())
