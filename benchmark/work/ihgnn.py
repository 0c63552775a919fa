"""The work of an IHGNN layer (``reference/ihgnn.py``) over E edges and N
nodes at width d, interaction order o with p parts.

Forward: the transform; the interaction, which reads X' and each edge's
three node ids and writes the edge rows (its gather counts no edge-sized
read, since a kernel can gather as it goes); the node sums, which read
the edge rows through the node-major CSR and divide by the degree.
Backward, in reverse: the edge cotangents (each edge's three node rows),
the interaction's backward with its dW (summed into node rows through the
CSR, so its role gradients count no edge-sized write), the transform's.
"""

from __future__ import annotations

from typing import List

from benchmark.work.common import F4, Op, nodes

PARTS = {1: 3, 2: 6, 3: 7}
# elementwise operations an edge and feature: the products of order 2 and
# 3, and their product rule in the backward
PART_OPS = {1: 0, 2: 3, 3: 4}
PART_BACKWARD_OPS = {1: 0, 2: 6, 3: 10}


def order(s: dict, layer: int) -> int:
    o = s["order"]
    return 1 if (o > 1 and layer > 0) else o


def layer_params(s: dict, layer: int) -> int:
    d, p = s["d"], PARTS[order(s, layer)]
    return d * d + d + p * d * d + d


def transform(s: dict) -> Op:
    n, d = nodes(s), s["d"]
    return Op("transform", read=(n * d + d * d + d) * F4, write=n * d * F4,
              products=2 * n * d * d)


def transform_backward(s: dict) -> Op:
    n, d = nodes(s), s["d"]
    return Op("transform_backward", read=(2 * n * d + d * d) * F4,
              write=(n * d + d * d + d) * F4, products=4 * n * d * d,
              other=n * d)


def layer_forward(s: dict, layer: int) -> List[Op]:
    n, e, d = nodes(s), s["interactions"], s["d"]
    o = order(s, layer)
    p = PARTS[o]
    return [transform(s),
            Op(f"interaction_o{o}", read=(n * d + 3 * e + p * d * d + d) * F4,
               write=e * d * F4, products=2 * e * p * d * d,
               other=(PART_OPS[o] + 1) * e * d),
            Op("node_sum", read=(e * d + (n + 1) + 3 * e + n) * F4,
               write=n * d * F4, other=3 * e * d + n * d)]


def layer_backward(s: dict, layer: int) -> List[Op]:
    n, e, d = nodes(s), s["interactions"], s["d"]
    o = order(s, layer)
    p = PARTS[o]
    return [Op("node_sum_backward", read=(n * d + n + 3 * e) * F4,
               write=e * d * F4, other=3 * e * d + n * d),
            Op(f"interaction_o{o}_backward",
               read=(e * d + n * d + 3 * e + (n + 1) + 3 * e + p * d * d)
               * F4,
               write=(n * d + p * d * d + d) * F4,
               products=4 * e * p * d * d,
               other=(PART_BACKWARD_OPS[o] + 3) * e * d),
            transform_backward(s)]
