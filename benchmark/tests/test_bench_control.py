"""The lower-precision control of each cell fails one of the cell's
limits, at a size a test run holds; the program itself passes them all.
The control is the configuration's ``control``: the program with its
bf16 streams on (IHGNN), or the reference computed in TF32 put in the
program's place (GAT, whose program has no lower precision of its
own)."""

import time

import pytest
import torch

from benchmark import calibrate, harness
from conftest import tiny

# big enough that the control's rounding shows above the sound runs'
SIZES = {"users": 300, "queries": 200, "items": 500, "vocab": 150,
         "words_per_query": 4, "interactions": 3000}


@pytest.mark.parametrize("cell", ["ihgnn.train", "gat.train", "ihgnn.rank",
                                  "ihgnn.train.zipf"])
def test_control_fails_and_program_passes(cell):
    c = tiny(cell, sizes=SIZES)
    run = harness.Run(c, 1_618_033_988, 0, False, torch.device("cpu"),
                      time.perf_counter())
    side = (calibrate.train_seed if c["traffic"]["kind"] == "train"
            else calibrate.rank_seed)
    readings = dict(side(run, c["config"]["control"], ()))
    limits = c["limits"]
    assert all(readings["program"][k][0] <= v for k, v in limits.items()), \
        readings["program"]
    assert any(readings["control"][k][0] > v for k, v in limits.items()), \
        readings["control"]
