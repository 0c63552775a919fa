"""The work of a GAT layer with the concatenation head
(``reference/gat.py``) over K distinct pairs and N nodes at width d.

Forward: the transform; each node's two head scalars; the pairs'
scores, softmax and α (read through the destination CSR); the α-weighted
sum of the source rows. Backward: each pair's <X'_s, cot_t> scaled by α;
the softmax's backward into the two scalars' node sums; the source-side
sum of α·cot_t plus the scalars' terms; the head's gradient; the
transform's.
"""

from __future__ import annotations

from typing import List

from benchmark.work.common import F4, Op, nodes
from benchmark.work.ihgnn import transform, transform_backward


def layer_params(s: dict, layer: int) -> int:
    d = s["d"]
    return d * d + d + 2 * d + 1


def layer_forward(s: dict, layer: int) -> List[Op]:
    n, k, d = nodes(s), s["entries"], s["d"]
    return [transform(s),
            Op("head_scalars", read=(n * d + 2 * d) * F4, write=2 * n * F4,
               products=4 * n * d),
            Op("softmax", read=(2 * n + k + n + 1 + 1) * F4, write=k * F4,
               other=8 * k),
            Op("weighted_sum", read=(n * d + 2 * k + n + 1) * F4,
               write=n * d * F4, other=2 * k * d)]


def layer_backward(s: dict, layer: int) -> List[Op]:
    n, k, d = nodes(s), s["entries"], s["d"]
    return [Op("edge_dot", read=(2 * n * d + 2 * k + n + 1) * F4,
               write=k * F4, other=2 * k * d + k),
            Op("softmax_backward", read=(3 * k + n + 1) * F4,
               write=2 * n * F4, other=6 * k),
            Op("source_sum", read=(n * d + 2 * k + n + 1 + 2 * n + 2 * d)
               * F4, write=n * d * F4, other=2 * k * d + 4 * n * d),
            Op("head_backward", read=(n * d + 2 * n) * F4,
               write=(2 * d + 1) * F4, products=4 * n * d),
            transform_backward(s)]
