"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program. Each check runs in a fresh
interpreter, so what another test imported does not count."""

import json
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = ["jax", "jaxlib", "flax", "optax", "ihgnn_tpu"]

LOADED = """
import json, sys
sys.path.insert(0, {root!r})
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in list(sys.modules)}})))
"""

RUN_A_CELL = """
import time
import benchmark.run, benchmark.calibrate
from benchmark import harness
sys.path.insert(0, {tests!r})
from conftest import tiny
for name in ("ihgnn.train", "gat.train", "ihgnn.rank"):
    out = harness.run_cell(tiny(name), 7, 0.2, True, "cpu",
                           time.perf_counter())
    assert out["correct"], name
"""

REFERENCE = """
import benchmark.reference.rawgnn, benchmark.reference.ihgnn
import benchmark.reference.gat, benchmark.reference.precision
"""


def _top_level_names(body: str) -> set:
    code = LOADED.format(root=str(ROOT), body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    body = RUN_A_CELL.format(tests=str(ROOT / "benchmark" / "tests"))
    names = _top_level_names(body)
    assert "ihgnn_torch" in names
    assert not names & set(FORBIDDEN), names & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    names = _top_level_names(REFERENCE)
    assert not names & set(FORBIDDEN + ["ihgnn_torch"])
