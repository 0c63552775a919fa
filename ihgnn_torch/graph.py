"""Graph packing: interactions → sorted index tensors and the CSRs the
kernels read.

Counterpart of ``ihgnn_tpu/graph.py`` (reference: Helpers/Graph.py). Its
TPU kernel packs are built on request (``pack_kernels=True``): the
hypergraph's routed pack, chunked past 2048 grid rows (``ops/packing.py``),
and the 2D graph's routed role pack and GAT pack (``ops/packing.py``
``role_pack``, ``ops/gatpack.py``). Node ids
are grouped [users | queries | items]: query ids are offset by
``user_count`` and item ids by ``user_count + query_count``. Zero-degree
vertices get degree 1e-8 (Helpers/Graph.py:68,120,175).

* ``HyperGraph`` — one hyperedge per positive (u, q, i) interaction
  (Helpers/Graph.py:84-134). The node update H·E is a CSR gather-sum over
  the node-major incidence: ``rowptr`` delimits each node's entries of
  ``inc_edge``, so the GPU kernel sums a node's edges in a fixed order,
  with no atomics. The same CSR with ``inc_slot`` as its column is the
  gather's backward: users, queries and items hold disjoint node ranges,
  so every node has one role, and entry k reads row ``role·E + edge`` of
  the ``[3E, d]`` role cotangents. The scatter's backward is the
  edge-major CSR ``(edge_rowptr, i3.view(-1))``: edge e sums the rows of
  its three nodes. ``phase2`` is the bipartite attention graph of IHGNN
  phase 2 (edge node ``N + e`` → its member nodes). ``long_segments``
  lists the hub nodes of ``rowptr`` (``ops/segsum.py``), which K1 sums
  with a block each.
* ``Graph2D`` — the symmetric 2D graph of one completeness mode
  (uqi/uq/ui/qi, Helpers/Graph.py:12-81), coalesced (duplicates summed)
  and sorted by (row, col). ``rowptr`` over ``row`` makes it GCN's SpMM;
  ``attention`` is GAT's destination-sorted edge list.
* ``LogHyperGraph`` — one hyperedge per search log = {u, q, positive
  items}, ragged edge degree (Helpers/Graph.py:138-189), with an
  edge-major and a node-major CSR.
* ``AttentionCSR`` — one edge list for the attention conv
  (``ops/gatconv.py``) in both orders: destination-sorted for the softmax
  and the weighted sum, source-sorted for the backward's source sums.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Union

import numpy as np
import torch

from ihgnn_torch.config import V
from ihgnn_torch.device import DeviceLike, moved
from ihgnn_torch.ops.edgedot import EdgeDotOrder, edge_dot_order
from ihgnn_torch.ops.gatpack import AnyGatPack, build_gat_pack
from ihgnn_torch.ops.packing import (CHUNK_ROWS_CAP, AnyHyperPack, RolePack,
                                     build_hyper_kernel_pack, role_pack)
from ihgnn_torch.ops.permute import pick_grid
from ihgnn_torch.ops.segsum import LongSegments, long_segments

DEGREE_FLOOR = 1e-8   # Helpers/Graph.py:120 — zero-degree vertices


def _rowptr(sorted_ids: np.ndarray, segments: int) -> np.ndarray:
    """int32 CSR offsets ``[segments + 1]`` of ascending ids."""
    rowptr = np.zeros(segments + 1, np.int64)
    np.cumsum(np.bincount(sorted_ids, minlength=segments), out=rowptr[1:])
    return rowptr.astype(np.int32)


@dataclasses.dataclass(frozen=True)
class AttentionCSR:
    """An edge list src → dst over ``node_count`` source rows and
    ``dst_count`` destinations (the first ``dst_count`` node ids), in two
    orders.

    Destination order: destination s owns entries
    ``[dst_rowptr[s], dst_rowptr[s+1])``; ``src[k]`` and ``dst[k]`` are the
    ends of entry k. Source order: source n owns entries
    ``[src_rowptr[n], src_rowptr[n+1])``, ``src_dst`` holds their
    destinations, and source-order entry j is destination-order entry
    ``to_dst[j]``. ``mask`` (destination order, 1 live / 0 excluded) or
    None when every entry is live."""

    dst_rowptr: torch.Tensor   # [S+1] int32
    src: torch.Tensor          # [K] int32 — source of each entry, dst order
    dst: torch.Tensor          # [K] int32 — destination, dst order
    src_rowptr: torch.Tensor   # [M+1] int32
    src_dst: torch.Tensor      # [K] int32 — destination, source order
    to_dst: torch.Tensor       # [K] int32 — dst-order position, source order
    mask: Optional[torch.Tensor]   # [K] f32 or None
    node_count: int                # M
    dst_count: int                 # S

    @property
    def entry_count(self) -> int:
        return self.src.shape[0]

    @functools.cached_property
    def dot_order(self) -> EdgeDotOrder:
        """The destination order as ``csr_edge_dot`` reads it, built on
        the host at its first use (a GAT layer's backward, the product
        head) and kept; a graph whose attention never runs pays nothing.
        ``to`` gives a copy without it."""
        return edge_dot_order(self.src, self.dst_rowptr)

    def to(self, device: DeviceLike) -> "AttentionCSR":
        return moved(self, device)


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
    phase2: AttentionCSR    # edge node N + e → its three member nodes
    node_count: int
    edge_count: int
    # the routed pack, chunked or not (ops/packing.py), or None: the
    # direct path
    kp: Optional[AnyHyperPack] = None
    # [E, 1] f32, 0 at the edges a mesh pads with (parallel/sharding.py),
    # or None: every edge is real
    edge_mask: Optional[torch.Tensor] = None
    # a rank's slice of the edges (parallel/sharding.py shard_graph): the
    # node sums are this rank's partials, combined over the mesh; None on
    # one device
    mesh: Optional[object] = None
    # the long segments of rowptr (ops/segsum.py), or None
    long_segments: Optional[LongSegments] = None

    def to(self, device: DeviceLike) -> "HyperGraph":
        return moved(self, device)


@dataclasses.dataclass(frozen=True)
class Graph2D:
    """Coalesced symmetric 2D graph in sorted COO form, with its CSRs."""

    row: torch.Tensor        # [nnz] int32, sorted (lexicographic with col)
    col: torch.Tensor        # [nnz] int32
    val: torch.Tensor        # [nnz] f32 — summed duplicate multiplicities
    dv: torch.Tensor         # [N, 1] f32
    dst_order: torch.Tensor  # [nnz] int32 — stable permutation sorting by col
    rowptr: torch.Tensor     # [N+1] int32 — CSR offsets of row
    attention: AttentionCSR  # row → col entries, masked where val <= 0
    node_count: int
    nnz: int
    # pack_kernels: the routed x[col] expand (forward stages only) on the
    # pick_grid(nnz, 2048) grid, with its K1 column over entry positions
    # (0..nnz-1), and the routed GAT's pack; None: the direct path
    pk_role: Optional[RolePack] = None
    pk_entry: Optional[torch.Tensor] = None
    gat_pk: Optional[AnyGatPack] = None
    # a rank's slice of the entries (parallel/sharding.py shard_graph),
    # whose A is not symmetric: its transpose's weights in destination
    # order, and the mesh its partials are combined over; None on one
    # device
    t_val: Optional[torch.Tensor] = None
    mesh: Optional[object] = None

    def to(self, device: DeviceLike) -> "Graph2D":
        return moved(self, device)


@dataclasses.dataclass(frozen=True)
class LogHyperGraph:
    """Ragged hypergraph: one edge per search log with >= 1 positive item."""

    inc_node: torch.Tensor     # [nnz] int32 — node ids, node-major sorted
    inc_edge: torch.Tensor     # [nnz] int32 — matching edge ids
    rowptr: torch.Tensor       # [N+1] int32 — CSR offsets of inc_node
    edge_nodes: torch.Tensor   # [nnz] int32 — node ids, edge-major
    edge_ids: torch.Tensor     # [nnz] int32 — sorted edge ids (edge-major)
    edge_rowptr: torch.Tensor  # [E+1] int32 — CSR offsets of edge_ids
    dv: torch.Tensor           # [N, 1] f32
    de: torch.Tensor           # [E, 1] f32 — edge degrees
    node_count: int
    edge_count: int
    # a rank's block of whole edges (parallel/sharding.py shard_graph):
    # the node sums are this rank's partials, combined over the mesh; None
    # on one device
    mesh: Optional[object] = None
    # the long segments of rowptr (ops/segsum.py), or None
    long_segments: Optional[LongSegments] = None

    def to(self, device: DeviceLike) -> "LogHyperGraph":
        return moved(self, device)


AnyGraph = Union[HyperGraph, Graph2D, LogHyperGraph]


def build_attention_csr(src: np.ndarray, dst: np.ndarray, node_count: int,
                        dst_count: int, mask: Optional[np.ndarray] = None
                        ) -> AttentionCSR:
    """A CPU ``AttentionCSR`` from entries sorted by destination:
    ``src``/``dst`` ids below ``node_count``/``dst_count``, ``mask`` (> 0
    live) or None. The source order is a stable sort of the destination
    order by source."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    if np.any(np.diff(dst) < 0):
        raise ValueError("attention entries must be sorted by destination")
    if len(src) and (src.min() < 0 or src.max() >= node_count
                     or dst.min() < 0 or dst.max() >= dst_count):
        raise ValueError(f"ids must lie in [0, {node_count}) (sources) and "
                         f"[0, {dst_count}) (destinations)")
    to_dst = np.argsort(src, kind="stable")
    return AttentionCSR(
        dst_rowptr=_i32(_rowptr(dst, dst_count)),
        src=_i32(src),
        dst=_i32(dst),
        src_rowptr=_i32(_rowptr(src, node_count)),
        src_dst=_i32(dst[to_dst]),
        to_dst=_i32(to_dst),
        mask=None if mask is None else torch.from_numpy(
            (np.asarray(mask) > 0).astype(np.float32)),
        node_count=int(node_count),
        dst_count=int(dst_count))


def _i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


def _global_ids(uqi: np.ndarray, user_count: int, query_count: int):
    return (uqi[:, 0].astype(np.int64),
            uqi[:, 1].astype(np.int64) + user_count,
            uqi[:, 2].astype(np.int64) + user_count + query_count)


def _check_ids(uqi: np.ndarray, user_count: int, query_count: int,
               item_count: int) -> None:
    for col, name, count in ((0, "user", user_count), (1, "query", query_count),
                             (2, "item", item_count)):
        ids = uqi[:, col]
        if len(ids) and (ids.min() < 0 or ids.max() >= count):
            raise ValueError(f"{name} ids must lie in [0, {count})")


def build_hypergraph(uqi: np.ndarray, node_count: int, user_count: int,
                     query_count: int, pack_kernels: bool = False,
                     chunk_rows_cap: int = CHUNK_ROWS_CAP) -> HyperGraph:
    """Pack positive interactions ``[P, >=3]`` of (u, q, i[, flag]) columns
    into a CPU ``HyperGraph``; the caller filters out flag <= 0.

    Edges are numbered in user-sorted order (stable), as
    ``ihgnn_tpu.graph.build_hypergraph`` numbers them, so edge ``e`` is the
    same edge in both packages.

    ``pack_kernels`` also builds the routed pack ``kp``
    (``ops/packing.py``), and the layers then run the TPU's σ-ordered
    pipeline of expands, Clos permutes and the absorbed interaction
    (``ops/hyperagg.py``). The default here is False, the direct path of
    one indexed gather and CSR sums, which is the faster one on the card;
    the JAX package's default is True. A grid of more than
    ``chunk_rows_cap`` rows (past 2,097,152 edges by default) packs as a
    ``ChunkedHyperPack``, as the JAX package packs it; ``kp`` is None
    where the JAX package refuses the pack."""
    uqi = np.asarray(uqi)
    _check_ids(uqi, user_count, query_count,
               node_count - user_count - query_count)
    u, q, i = _global_ids(uqi, user_count, query_count)
    edge_order = np.argsort(u, kind="stable")
    i3 = np.stack([u[edge_order], q[edge_order], i[edge_order]],
                  axis=1).astype(np.int32)
    graph = hypergraph_from_i3(i3, node_count)
    if pack_kernels and graph.edge_count:
        graph = dataclasses.replace(graph, kp=build_hyper_kernel_pack(
            i3, node_count, chunk_rows_cap=chunk_rows_cap))
    return graph


def hypergraph_from_i3(i3: np.ndarray, node_count: int,
                       dv: Optional[torch.Tensor] = None,
                       edge_mask: Optional[np.ndarray] = None
                       ) -> HyperGraph:
    """The CPU ``HyperGraph`` (no routed pack) of the edges ``i3`` ``[E,
    3]`` (global node ids, in edge order) over ``node_count`` nodes.

    ``dv``: the vertex degrees to keep (default: counted from ``i3``).
    ``edge_mask`` ``[E]``: 0 marks an edge a mesh pads with
    (``ihgnn_tpu/parallel/sharding.py:243-295``); its incidence entries
    target the last node (so the node-major CSR stays sorted), and phase
    2's attention leaves them out of its softmax."""
    i3 = np.ascontiguousarray(i3, np.int32)
    e_count = len(i3)
    flat_nodes = i3.reshape(-1).astype(np.int64)
    if dv is None:
        counts = np.bincount(flat_nodes, minlength=node_count).astype(
            np.float32)
        counts[counts == 0] = DEGREE_FLOOR
        dv = torch.from_numpy(counts.reshape(-1, 1))
    inc_mask = None
    if edge_mask is not None:
        edge_mask = np.asarray(edge_mask, np.float32).reshape(-1)
        if edge_mask.shape != (e_count,):
            raise ValueError(f"edge_mask must be [{e_count}]")
        flat_nodes = np.where(np.repeat(edge_mask > 0, 3), flat_nodes,
                              node_count - 1)

    # flat entry f = 3·edge + role
    order = np.argsort(flat_nodes, kind="stable")
    inc_node = flat_nodes[order]
    inc_edge = order // 3
    if edge_mask is not None:
        inc_mask = edge_mask[inc_edge]

    # phase 2: edge node N + e sends to its member nodes; the incidence is
    # already sorted by member node = destination
    phase2 = build_attention_csr(inc_edge + node_count, inc_node,
                                 node_count + e_count, node_count, inc_mask)

    return HyperGraph(
        i3=torch.from_numpy(i3),
        dv=dv,
        inc_node=phase2.dst,
        inc_edge=_i32(inc_edge),
        rowptr=phase2.dst_rowptr,
        inc_slot=_i32((order % 3) * e_count + order // 3),
        edge_rowptr=_i32(np.arange(0, 3 * e_count + 1, 3)),
        phase2=phase2,
        node_count=int(node_count),
        edge_count=int(e_count),
        edge_mask=(None if edge_mask is None else
                   torch.from_numpy(edge_mask.reshape(-1, 1).copy())),
        long_segments=long_segments(phase2.dst_rowptr),
    )


def build_graph2d(uqif: np.ndarray, node_count: int, user_count: int,
                  query_count: int, completeness: str = V.GRAPH_UQI,
                  use_self_connection: bool = False,
                  pack_kernels: bool = False) -> Graph2D:
    """Pack positive interactions ``[P, 4]`` of (u, q, i, flag) into the
    CPU 2D graph (Helpers/Graph.py:19-81, ``ihgnn_tpu.graph.build_graph2d``).

    Per interaction, symmetric entry pairs are appended by completeness
    mode (i-u entries carry the flag); COO duplicates are summed and the
    entries sorted by (row, col), with one ``np.unique`` over int64 keys.
    Vertex degrees count incidences: 2 per interaction in uqi mode, 1
    otherwise, plus 1 with self connections; without them zero degrees
    are floored at 1e-8.

    ``pack_kernels`` also builds the routed tail of
    ``ihgnn_tpu.graph.build_graph2d`` (``graph.py:225-283``): ``pk_role``
    over the sorted ``col`` ids (forward stages only: A is symmetric) and,
    where it packs, ``gat_pk`` over the destination-sorted entries, split
    by source region at ``(user_count, user_count + query_count)``. Either
    is None where the JAX package's is."""
    uqif = np.asarray(uqif)
    _check_ids(uqif, user_count, query_count,
               node_count - user_count - query_count)
    u, q, i = _global_ids(uqif, user_count, query_count)
    flag = (uqif[:, 3].astype(np.float32) if uqif.shape[1] > 3
            else np.ones(len(u), np.float32))
    ones = np.ones_like(flag)

    if completeness == V.GRAPH_UQI:
        rows = np.concatenate([u, q, i, i, q, u])
        cols = np.concatenate([q, i, u, q, u, i])
        vals = np.concatenate([ones, ones, flag, ones, ones, flag])
        deg_nodes, deg_inc = np.concatenate([u, q, i]), 2.0
    elif completeness == V.GRAPH_ONLY_UQ:
        rows, cols = np.concatenate([u, q]), np.concatenate([q, u])
        vals = np.concatenate([ones, ones])
        deg_nodes, deg_inc = np.concatenate([u, q]), 1.0
    elif completeness == V.GRAPH_ONLY_UI:
        rows, cols = np.concatenate([u, i]), np.concatenate([i, u])
        vals = np.concatenate([ones, ones])
        deg_nodes, deg_inc = np.concatenate([u, i]), 1.0
    elif completeness == V.GRAPH_ONLY_QI:
        rows, cols = np.concatenate([q, i]), np.concatenate([i, q])
        vals = np.concatenate([ones, ones])
        deg_nodes, deg_inc = np.concatenate([q, i]), 1.0
    else:
        raise ValueError(f"unknown graph completeness {completeness!r}")

    dv = (np.bincount(deg_nodes, minlength=node_count).astype(np.float32)
          * np.float32(deg_inc))
    if use_self_connection:
        loops = np.arange(node_count, dtype=np.int64)
        rows = np.concatenate([rows, loops])
        cols = np.concatenate([cols, loops])
        vals = np.concatenate([vals, np.ones(node_count, np.float32)])
        dv += 1.0
    else:
        dv[dv == 0] = DEGREE_FLOOR

    # coalesce: sum duplicates, sort by (row, col)
    uniq, inverse = np.unique(rows * node_count + cols, return_inverse=True)
    val_sum = np.bincount(inverse.reshape(-1), weights=vals,
                          minlength=len(uniq)).astype(np.float32)
    crow = uniq // node_count
    ccol = uniq % node_count
    graph = graph2d_from_coo(crow, ccol, val_sum,
                             torch.from_numpy(dv.reshape(-1, 1)), node_count)
    nnz = graph.nnz
    if not (pack_kernels and nnz):
        return graph
    dst_order = graph.dst_order.numpy()
    try:
        pk_role = role_pack(ccol, *pick_grid(nnz, 2048), with_bwd=False)
    except ValueError:
        return graph
    gat_pk = build_gat_pack(
        crow[dst_order], ccol[dst_order], node_count,
        live=val_sum[dst_order],
        src_cuts=(user_count, user_count + query_count))
    return dataclasses.replace(graph, pk_role=pk_role,
                               pk_entry=_i32(np.arange(nnz)), gat_pk=gat_pk)


def graph2d_from_coo(row: np.ndarray, col: np.ndarray, val: np.ndarray,
                     dv: torch.Tensor, node_count: int) -> Graph2D:
    """The CPU ``Graph2D`` (no routed pack) of COO entries sorted by (row,
    col), with vertex degrees ``dv``. An entry of ``val`` <= 0 (a mesh's
    padding, ``ihgnn_tpu/parallel/sharding.py:195``) is masked out of
    GAT's attention."""
    row = np.asarray(row, np.int64)
    col = np.asarray(col, np.int64)
    val = np.asarray(val, np.float32)
    dst_order = np.argsort(col, kind="stable")
    live = val[dst_order] > 0
    attention = build_attention_csr(row[dst_order], col[dst_order],
                                    node_count, node_count,
                                    None if live.all() else live)
    # the graph is symmetric, so its (row, col) order is the attention's
    # source order: the row CSR is also the attention's source side
    return Graph2D(
        row=_i32(row), col=attention.src_dst, val=torch.from_numpy(val),
        dv=dv, dst_order=_i32(dst_order), rowptr=attention.src_rowptr,
        attention=attention, node_count=int(node_count), nnz=int(len(row)))


def build_log_hypergraph(log_nodes: Sequence[Sequence[int]],
                         node_count: int) -> LogHyperGraph:
    """Pack per-log node lists (global ids, each list = {u, q, positive
    items}; lists with only {u, q} must be dropped by the caller) into a
    CPU ``LogHyperGraph`` (Helpers/Graph.py:148-189)."""
    de = np.asarray([len(nodes) for nodes in log_nodes], np.int64)
    flat_nodes = np.fromiter((n for nodes in log_nodes for n in nodes),
                             np.int64, count=int(de.sum()))
    return log_hypergraph_from_edges(flat_nodes, de, node_count)


def log_hypergraph_from_edges(flat_nodes: np.ndarray, sizes: np.ndarray,
                              node_count: int,
                              dv: Optional[torch.Tensor] = None,
                              de: Optional[torch.Tensor] = None
                              ) -> LogHyperGraph:
    """The CPU ``LogHyperGraph`` of edges laid end to end: edge e's
    members are the next ``sizes[e]`` ids of ``flat_nodes``. ``dv`` /
    ``de``: the vertex and edge degrees to keep (default: counted here;
    a mesh's slice keeps the global ``dv``, and its memberless pad edges
    the degree 1 of ``parallel/sharding.py``)."""
    sizes = np.asarray(sizes, np.int64)
    flat_nodes = np.asarray(flat_nodes, np.int64)
    e_count = len(sizes)
    if len(flat_nodes) != sizes.sum():
        raise ValueError(f"{len(flat_nodes)} member ids for edges of "
                         f"{int(sizes.sum())} members")
    if len(flat_nodes) and (flat_nodes.min() < 0
                            or flat_nodes.max() >= node_count):
        raise ValueError(f"node ids must lie in [0, {node_count})")
    edge_ids = np.repeat(np.arange(e_count, dtype=np.int64), sizes)
    if dv is None:
        counts = np.bincount(flat_nodes, minlength=node_count).astype(
            np.float32)
        counts[counts == 0] = DEGREE_FLOOR
        dv = torch.from_numpy(counts.reshape(-1, 1))
    if de is None:
        de = torch.from_numpy(sizes.astype(np.float32).reshape(-1, 1))

    node_order = np.argsort(flat_nodes, kind="stable")
    inc_node = flat_nodes[node_order]
    rowptr = _rowptr(inc_node, node_count)
    return LogHyperGraph(
        inc_node=_i32(inc_node),
        inc_edge=_i32(edge_ids[node_order]),
        rowptr=_i32(rowptr),
        edge_nodes=_i32(flat_nodes),
        edge_ids=_i32(edge_ids),
        edge_rowptr=_i32(_rowptr(edge_ids, e_count)),
        dv=dv,
        de=de,
        node_count=int(node_count),
        edge_count=int(e_count),
        long_segments=long_segments(rowptr),
    )
