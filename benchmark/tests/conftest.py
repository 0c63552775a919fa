"""The benchmark's own tests: ``python -m pytest benchmark/tests`` from the
root of the repository. They run on the CPU at tiny sizes; a test that
needs the card is marked ``cuda`` and skips without one.

``tiny(name)`` is the cell ``name`` of ``BENCHMARK.json`` with its
deployment cut to a few dozen nodes and its traffic to a few rows, which
the port runs on the CPU through its plain twins."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {"users": 40, "queries": 25, "items": 60, "vocab": 30,
        "words_per_query": 4, "interactions": 300}
TINY_TRAIN = {"batch_positives": 16, "random_negatives": 3,
              "premade_batches": 8, "profiled_steps": 2}
TINY_RANK = {"logs": 300, "batch_logs": 32, "checked_batches": 4,
             "profiled_batches": 2, "top_items": 4}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card and nvcc; skips without a card")


def tiny(name: str, root: Path = ROOT, sizes=None) -> dict:
    from benchmark import spec
    cell = spec.cell(name, root)
    cell["config"]["deployment"] = dict(sizes or TINY)
    kind = cell["traffic"]["kind"]
    cell["traffic"].update(TINY_TRAIN if kind == "train" else TINY_RANK)
    return cell


@pytest.fixture
def card():
    """The CUDA device; skips the test without one."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
