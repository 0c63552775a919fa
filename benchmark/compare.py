"""The numbers ``correct`` compares, and the verdict.

Training (the first three steps, program against reference):

* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad_gap``: the first step's gradient, leaf by leaf: the gap between
  the program's norm and the reference's, over the larger of the
  reference's norm of that leaf and of the median leaf; the worst leaf;
* ``change_gap``: the same of each leaf's change after the steps, over
  the leaves whose reference gradient is at least ``MOVED`` of the median
  leaf's (a smaller one moves under Adam by round-off alone).

A cell's limits file names the numbers it compares.

Ranking (the program's last refresh and a sample of its metric rows):

* ``feature_gap``: the largest gap of a feature, over the largest feature
  of its layer's block of columns, the worst block;
* ``score_gap``: the catalog scores that the window's ``metrics_fn``
  gave the sampled logs' truth items, against the reference's: the
  largest gap over the largest magnitude of the batch's feature term
  <F_i, λ·F_q + (1 - λ)·F_u>, the worst batch;
* ``row_mismatches``: the sampled logs whose four metrics differ from the
  reference's by more than ``ROW_TOL``, leaving out those whose ranks a
  score move of ``TIE`` could change (``reference.rawgnn.truth_ranks``).

A run is correct when every number is at or under its limit.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional, Tuple

MOVED = 1e-3
ROW_TOL = 1e-5
TIE = 1e-4


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep=None) -> Dict[str, float]:
    """Each leaf's gap of norms over the larger of its reference norm and
    the median leaf's."""
    med = statistics.median(ref.values())
    return {name: abs(prog[name] - r) / max(r, med)
            for name, r in ref.items() if keep is None or name in keep}


def _worst(gaps: Dict[str, float]) -> Tuple[float, Optional[str]]:
    worst, leaf = 0.0, None
    for name, gap in gaps.items():
        if not gap <= worst:        # NaN counts as worst
            worst, leaf = gap, name
    return worst, leaf


def train_readings(prog: dict, ref: dict) -> Dict[str, Tuple[float, str]]:
    """``{number: (value, what)}`` of a program's and the reference's
    ``losses``, ``grad_norms`` and ``change_norms``."""
    steps = [abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                 ref["losses"])]
    loss_gap = max(steps, key=lambda g: g if g == g else math.inf)
    med = statistics.median(ref["grad_norms"].values())
    moved = {k for k, v in ref["grad_norms"].items() if v >= MOVED * med}
    grad_gap, g_leaf = _worst(leaf_gaps(prog["grad_norms"],
                                        ref["grad_norms"]))
    change_gap, c_leaf = _worst(leaf_gaps(prog["change_norms"],
                                          ref["change_norms"], moved))
    return {"loss_gap": (loss_gap, f"step {steps.index(loss_gap) + 1}"),
            "grad_gap": (grad_gap, str(g_leaf)),
            "change_gap": (change_gap, str(c_leaf))}


def feature_gap(prog, ref, width: int) -> Tuple[float, str]:
    """The worst block of ``width`` columns (one layer's), as above."""
    worst, block = 0.0, 0
    for k in range(ref.shape[1] // width):
        cols = slice(k * width, (k + 1) * width)
        scale = float(ref[:, cols].abs().max())
        gap = float((prog[:, cols] - ref[:, cols]).abs().max()) / max(
            scale, 1e-30)
        if not gap <= worst:
            worst, block = gap, k
    return worst, f"X{block}"


def score_gap(prog, ref, term, valid) -> float:
    """The largest gap of the ``valid`` scores over the largest magnitude
    of their feature terms."""
    gap = (prog.double() - ref).abs()[valid].max()
    return float(gap / term.abs()[valid].max().clamp(min=1e-30))


def checks(readings: Dict[str, Tuple[float, str]],
           limits: Dict[str, float]) -> List[dict]:
    """One ``{name, value, limit, what}`` a number, in the limits'
    order."""
    return [{"name": name, "value": readings[name][0], "limit": limit,
             "what": readings[name][1]} for name, limit in limits.items()]


def verdict(rows: List[dict]) -> bool:
    return bool(rows) and all(r["value"] <= r["limit"] for r in rows)
