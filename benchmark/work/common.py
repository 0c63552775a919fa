"""Peaks, the op record, and the work every RawGnn configuration shares.

Peaks of one H100 SXM from NVIDIA's data sheet (dense, at the 700 W
limit): 3.35 TB/s of HBM, 67 TFLOP/s float32 outside the tensor cores,
495 TFLOP/s TF32 on them. A float32 matrix product can run on the tensor
cores in three TF32 passes (3xTF32) and keep float32's accuracy, so the
least time of an op's matrix products is over 495 / 3 TFLOP/s; its other
operations are over 67. ``mfu`` divides all operations by 67 TFLOP/s,
the rate the configurations' float32 states.

Shapes (``s``): ``users``, ``queries``, ``items``, ``vocab``,
``words_per_query``, ``interactions`` (E), ``d``, ``layers``, ``rows``
(a train batch's rows), ``entries`` (the 2D graph's distinct pairs),
``batch_logs``, ``truth_max``.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import List

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
TF32_FLOPS = 495e12
PRODUCT_FLOPS = TF32_FLOPS / 3
F4 = 4          # bytes of a float32 or an int32
I8 = 8          # bytes of an int64 index
TOP_K = 10


@dataclasses.dataclass(frozen=True)
class Op:
    name: str
    read: float            # bytes
    write: float           # bytes
    products: float = 0.0  # operations in matrix products
    other: float = 0.0     # every other operation

    @property
    def flops(self) -> float:
        return self.products + self.other

    @property
    def bound_s(self) -> float:
        """The least time the op can take: its bytes at the HBM rate or
        its operations at their peaks, whichever is longer."""
        return max((self.read + self.write) / HBM_BYTES_PER_S,
                   self.products / PRODUCT_FLOPS, self.other / F32_FLOPS)


def total_bound_s(ops: List[Op]) -> float:
    return sum(op.bound_s for op in ops)


def total_flops(ops: List[Op]) -> float:
    return sum(op.flops for op in ops)


def layer_module(gnn: str):
    return importlib.import_module(f"benchmark.work.{gnn}")


def nodes(s: dict) -> int:
    return s["users"] + s["queries"] + s["items"]


def feature_width(s: dict) -> int:
    return s["d"] * (1 + s["layers"])


def bag(s: dict) -> List[Op]:
    """X0's query rows: each query's word rows summed and scaled."""
    d, q, k = s["d"], s["queries"], s["queries"] * s["words_per_query"]
    return [Op("bag", read=((s["vocab"] + 1) * d + 2 * k + q + 1) * F4,
               write=q * d * F4, other=2 * k * d)]


def bag_backward(s: dict) -> List[Op]:
    """The word table's gradient, and the user and item tables'."""
    d, q, k = s["d"], s["queries"], s["queries"] * s["words_per_query"]
    tables = (s["users"] + s["items"] + 2) * d
    return [Op("bag_backward", read=(q * d + 2 * k + s["vocab"] + 2) * F4,
               write=(s["vocab"] + 1) * d * F4, other=2 * k * d),
            Op("tables_backward", read=(s["users"] + s["items"]) * d * F4,
               write=tables * F4)]


def head(s: dict) -> List[Op]:
    """A batch's scores and its weighted BCE: three feature rows a row
    mixed and dotted, plus the item's bias."""
    r, f = s["rows"], feature_width(s)
    return [Op("head", read=(3 * r * f + 3 * r + r + 2 * r) * F4,
               write=r * F4, other=4 * r * f + 8 * r)]


def head_backward(s: dict) -> List[Op]:
    r, f = s["rows"], feature_width(s)
    return [Op("head_backward", read=(3 * r * f + r + 3 * r) * F4,
               write=(3 * r * f + r) * F4, other=6 * r * f)]


def adam(params: int) -> List[Op]:
    """Read each parameter, its gradient and two moments; write the
    parameter and the moments."""
    return [Op("adam", read=4 * params * F4, write=3 * params * F4,
               other=12 * params)]


def params(s: dict) -> int:
    d = s["d"]
    tables = (s["users"] + s["items"] + s["vocab"] + 3) * d
    return tables + s["items"] + sum(
        layer_module(s["gnn"]).layer_params(s, k) for k in range(s["layers"]))


def forward(s: dict) -> List[Op]:
    """The full-graph forward, [X0 | X1 | ... | XL]."""
    layer = layer_module(s["gnn"])
    ops = bag(s)
    for k in range(s["layers"]):
        ops += layer.layer_forward(s, k)
    return ops


def train_step(s: dict) -> List[Op]:
    """Forward, head, BCE, backward, Adam; no recomputation."""
    layer = layer_module(s["gnn"])
    ops = forward(s) + head(s) + head_backward(s)
    for k in reversed(range(s["layers"])):
        ops += layer.layer_backward(s, k)
    return ops + bag_backward(s) + adam(params(s))


def rank_batch(s: dict) -> List[Op]:
    """One batch of logs against the whole catalog: the pairs' mixed rows,
    every item's score, the top ``TOP_K``, the metric rows. A kernel that
    scores and selects in one pass never writes the ``[B, I]`` scores, so
    none are counted."""
    b, f, i, t = s["batch_logs"], feature_width(s), s["items"], s["truth_max"]
    return [Op("rank_mix", read=(2 * b + 2 * b * f) * F4, write=b * f * F4,
               other=3 * b * f),
            Op("rank_score_topk", read=(i * f + i + b * f) * F4,
               write=b * TOP_K * (F4 + I8), products=2 * b * f * i,
               other=2 * b * i),
            Op("rank_metrics", read=(b * TOP_K * I8 + b * t * F4 + b * F4),
               write=4 * b * F4, other=b * t * TOP_K * 4)]
