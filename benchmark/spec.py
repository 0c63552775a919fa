"""``BENCHMARK.json`` and the files the harness finds by name.

* a configuration: the file its ``configs`` entry names;
* a traffic mix: ``benchmark/traffic/<traffic>.json``, whose ``kind``
  names its timed loop, ``benchmark/loops/<kind>.py``;
* a cell's limits on what ``correct`` compares:
  ``benchmark/limits/<workload>.json``;
* a metric: its reader, ``benchmark/metrics/<metric>.py``, whose
  ``read(record)`` gives the value or None when the run has nothing to
  read. A metric split by the cells it serves (``mfu.train``,
  ``mfu.eval``) that has no file of its own is read by the reader of its
  name with the last ``.<part>`` dropped (``mfu.py``), and so on.

A later cell, mix or metric is a new file and a new entry; no file here
changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
HOME = "benchmark"


def load(root: Path = ROOT) -> dict:
    path = Path(root) / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _applies(metric: dict, cell: str, reported: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in reported


def cell(name: str, root: Path = ROOT) -> dict:
    """Everything one workload of ``BENCHMARK.json`` needs, resolved:
    ``config`` (with ``name``), ``traffic`` (with ``name``), ``limits``,
    ``chips`` and the ``end_to_end`` and ``per_layer`` metric entries that
    the cell reports."""
    root = Path(root)
    bench = load(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; BENCHMARK.json has "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = dict(_json(root / configs[w["config"]]["file"]),
                  name=w["config"])
    traffic = dict(_json(root / HOME / "traffic" / f"{w['traffic']}.json"),
                   name=w["traffic"])
    limits = _json(root / HOME / "limits" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    reported = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, name, reported)]
    return {"name": name, "chips": w["chips"], "config": config,
            "traffic": traffic, "limits": limits, "end_to_end": e2e,
            "per_layer": per_layer}


def reader_path(metric: str, root: Path = ROOT) -> Path:
    """``benchmark/metrics/<metric>.py``, or the file of the longest
    prefix of ``metric`` that ends before a dot."""
    home = Path(root) / HOME / "metrics"
    name = metric
    while not (home / f"{name}.py").is_file():
        if "." not in name:
            raise FileNotFoundError(f"no reader of {metric!r} in {home}")
        name = name.rsplit(".", 1)[0]
    return home / f"{name}.py"


def reader(metric: str, root: Path = ROOT) -> Callable[[dict],
                                                       Optional[float]]:
    """The ``read`` function of the metric's reader (``reader_path``)."""
    path = reader_path(metric, root)
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{path.stem.replace('.', '_').replace('-', '_')}",
        path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(f"no reader {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def loop(kind: str):
    return importlib.import_module(f"benchmark.loops.{kind}")


def read_metrics(entries: List[dict], record: dict,
                 root: Path = ROOT) -> Dict[str, dict]:
    """``{name: {"value", "unit"}}`` of every entry whose reader finds
    something to read in ``record``."""
    out = {}
    for m in entries:
        value = reader(m["name"], root)(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
