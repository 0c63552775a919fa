"""Hypergraph packing: positive (u, q, i) interactions → sorted index tensors.

Counterpart of ``ihgnn_tpu/graph.py`` ``HyperGraph``/``build_hypergraph``
without the TPU kernel packs. One hyperedge per positive interaction
(reference: Helpers/Graph.py:84-134). Node ids are grouped
[users | queries | items]: query ids are offset by ``user_count`` and item
ids by ``user_count + query_count``.

The node update H·E is a CSR gather-sum over the node-major incidence:
``rowptr`` delimits each node's entries of ``inc_edge``, so the GPU kernel
sums a node's edges in a fixed order, with no atomics. The same CSR with
``inc_slot`` as its column is the gather's backward: users, queries and
items hold disjoint node ranges, so every node has one role, and entry k
reads row ``role·E + edge`` of the ``[3E, d]`` role cotangents. The
scatter's backward is the edge-major CSR ``(edge_rowptr, i3.view(-1))``:
edge e sums the rows of its three nodes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ihgnn_torch.device import DeviceLike, resolve_device

DEGREE_FLOOR = 1e-8   # Helpers/Graph.py:120 — zero-degree vertices


@dataclasses.dataclass(frozen=True)
class HyperGraph:
    """Hypergraph with edge degree 3 (one edge per uqi interaction).

    All tensors live on one device; ``to`` moves them."""

    i3: torch.Tensor        # [E, 3] int32 — (u, q, i) global node ids
    dv: torch.Tensor        # [N, 1] f32 — vertex degrees, floored at 1e-8
    inc_node: torch.Tensor  # [3E] int32 — node ids, sorted ascending
    inc_edge: torch.Tensor  # [3E] int32 — edge id of each incidence entry
    rowptr: torch.Tensor    # [N+1] int32 — CSR offsets of inc_node
    inc_slot: torch.Tensor  # [3E] int32 — role · E + edge of each entry
    edge_rowptr: torch.Tensor  # [E+1] int32 — 0, 3, 6, …, 3E
    node_count: int
    edge_count: int

    def to(self, device: DeviceLike) -> "HyperGraph":
        dev = resolve_device(device)
        return dataclasses.replace(
            self, i3=self.i3.to(dev), dv=self.dv.to(dev),
            inc_node=self.inc_node.to(dev), inc_edge=self.inc_edge.to(dev),
            rowptr=self.rowptr.to(dev), inc_slot=self.inc_slot.to(dev),
            edge_rowptr=self.edge_rowptr.to(dev))


def build_hypergraph(uqi: np.ndarray, node_count: int, user_count: int,
                     query_count: int) -> HyperGraph:
    """Pack positive interactions ``[P, >=3]`` of (u, q, i[, flag]) columns
    into a CPU ``HyperGraph``; the caller filters out flag <= 0.

    Edges are numbered in user-sorted order (stable), as
    ``ihgnn_tpu.graph.build_hypergraph`` numbers them, so edge ``e`` is the
    same edge in both packages."""
    uqi = np.asarray(uqi)
    item_count = node_count - user_count - query_count
    for col, name, count in ((0, "user", user_count), (1, "query", query_count),
                             (2, "item", item_count)):
        ids = uqi[:, col]
        if len(ids) and (ids.min() < 0 or ids.max() >= count):
            raise ValueError(f"{name} ids must lie in [0, {count})")
    u = uqi[:, 0].astype(np.int64)
    q = uqi[:, 1].astype(np.int64) + user_count
    i = uqi[:, 2].astype(np.int64) + user_count + query_count
    e_count = len(u)

    edge_order = np.argsort(u, kind="stable")
    i3 = np.stack([u[edge_order], q[edge_order], i[edge_order]],
                  axis=1).astype(np.int32)

    flat_nodes = i3.reshape(-1).astype(np.int64)
    dv = np.bincount(flat_nodes, minlength=node_count).astype(np.float32)
    dv[dv == 0] = DEGREE_FLOOR

    # flat entry f = 3·edge + role
    order = np.argsort(flat_nodes, kind="stable")
    inc_node = flat_nodes[order].astype(np.int32)
    rowptr = np.zeros(node_count + 1, np.int64)
    np.cumsum(np.bincount(inc_node, minlength=node_count), out=rowptr[1:])

    return HyperGraph(
        i3=torch.from_numpy(i3),
        dv=torch.from_numpy(dv.reshape(-1, 1)),
        inc_node=torch.from_numpy(inc_node),
        inc_edge=torch.from_numpy((order // 3).astype(np.int32)),
        rowptr=torch.from_numpy(rowptr.astype(np.int32)),
        inc_slot=torch.from_numpy(
            ((order % 3) * e_count + order // 3).astype(np.int32)),
        edge_rowptr=torch.from_numpy(
            np.arange(0, 3 * e_count + 1, 3, dtype=np.int32)),
        node_count=int(node_count),
        edge_count=int(e_count),
    )
