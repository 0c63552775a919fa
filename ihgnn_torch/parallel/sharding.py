"""Padding for a mesh, and each rank's slice of graphs, batches and the
word bag.

Counterpart of ``ihgnn_tpu/parallel/sharding.py`` (``round_up``,
``pad_hypergraph_for_mesh`` ``:243``, ``pad_graph2d_for_mesh`` ``:195``,
``graph_sharding`` ``:139-172``, ``batch_sharding`` ``:178-189``) and of
``ops/bag.py`` ``make_sharded_bag_pack`` (``:233-333``). JAX places the
padded arrays with ``NamedSharding``s and each device reads its block; a
rank here builds its own slice on the host:

* ``pad_hypergraph_for_mesh`` / ``pad_graph2d_for_mesh`` /
  ``pad_log_hypergraph_for_mesh`` (``pad_graph_for_mesh`` picks by type)
  — the padded one-device graph: hyperedges padded to a multiple of the
  data axis by copies of the last real edge, zeroed by ``edge_mask``
  (their incidence entries target the last node, and phase 2's softmax
  leaves them out); 2D entries padded by ``val = 0`` entries at the last
  node (masked out of GAT's softmax); log edges padded by memberless
  edges of degree 1. Each gives the unpadded loss.
* ``shard_graph`` — rank r's slice: the r-th contiguous block of the
  padded edges (2D entries; whole log edges with their members), with its
  own CSRs over all N nodes and the global vertex degrees, marked with
  the mesh so the layers combine its node partials
  (``parallel/collectives.py``) and GAT's and phase 2's softmax spans the
  ranks (``ops/gatconv.py``). With ``pack_kernels`` a rank's hypergraph
  slice carries the routed σ pack of its real edges
  (``build_hyper_kernel_pack``, absorption included), chunked past
  ``chunk_rows_cap`` grid rows as the one-device pack is (its node sums,
  K1's three-region form over the CSR spanning the chunks, are the rank's
  partial): a rank's pipeline from its gather to its node partial is
  local, and the mesh's pad edges, zero by their mask, are left out of
  the pack rather than masked in it. The JAX package's per-shard packs
  are non-σ and never chunk (``ihgnn_tpu/ops/packing.py:601-622``); ROADMAP
  §3 states the departure.
* ``shard_batch`` — the rank's contiguous block of a batch's rows (of
  each ``[R]`` array, or the row axis of stacked ``[k, R]`` arrays).
* ``ShardedBag`` — the rank's slice of the queries' word bags, dummy
  empty queries padding Q to a multiple of the data axis.

Every slice is by the rank's data index (``Mesh.data_index``): the ranks
of one data index on a mesh with a model axis hold the same slice. The
tables' rows over ``model`` are ``parallel/tables.py``'s. A 2D graph's
routed packs are dropped by the padding, as the JAX package strips them
under a mesh.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ihgnn_torch.data.dataset import Batch
from ihgnn_torch.device import DeviceLike
from ihgnn_torch.graph import (Graph2D, HyperGraph, LogHyperGraph,
                               graph2d_from_coo, hypergraph_from_i3,
                               log_hypergraph_from_edges)
from ihgnn_torch.ops.bag import BagMeanFn, WordBag, make_word_bag
from ihgnn_torch.ops.packing import CHUNK_ROWS_CAP, build_hyper_kernel_pack
from ihgnn_torch.parallel.collectives import gather_slices
from ihgnn_torch.parallel.mesh import Mesh


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def pad_hypergraph_for_mesh(graph: HyperGraph,
                            data_parallel: int) -> HyperGraph:
    """``graph`` with its edge count padded to a multiple of
    ``data_parallel``: the pad edges repeat the last real edge and are
    zeroed by ``edge_mask``, their incidence entries target the last node,
    and the degrees are kept. The routed pack, built for the unpadded
    edges, is dropped. ``graph`` itself when no edge is added."""
    e = graph.edge_count
    e_pad = round_up(max(e, 1), data_parallel)
    if e_pad == e:
        return graph
    if graph.edge_mask is not None:
        raise ValueError("the graph is padded already")
    i3 = graph.i3.numpy()
    pad = np.repeat(i3[-1:], e_pad - e, axis=0) if e else np.full(
        (e_pad, 3), graph.node_count - 1, np.int32)
    mask = np.zeros(e_pad, np.float32)
    mask[:e] = 1.0
    return hypergraph_from_i3(np.concatenate([i3, pad]), graph.node_count,
                              dv=graph.dv, edge_mask=mask)


def pad_graph2d_for_mesh(graph: Graph2D, data_parallel: int) -> Graph2D:
    """``graph`` with its entry count padded to a multiple of
    ``data_parallel`` by ``val = 0`` entries at (last node, last node),
    which keep the (row, col) order, add nothing to GCN's sums and are
    masked out of GAT's softmax. The routed packs are dropped. ``graph``
    itself when no entry is added."""
    nnz = graph.nnz
    nnz_pad = round_up(max(nnz, 1), data_parallel)
    if nnz_pad == nnz:
        return graph
    last = graph.node_count - 1
    extra = nnz_pad - nnz
    return graph2d_from_coo(
        np.concatenate([graph.row.numpy(), np.full(extra, last)]),
        np.concatenate([graph.col.numpy(), np.full(extra, last)]),
        np.concatenate([graph.val.numpy(), np.zeros(extra, np.float32)]),
        graph.dv, graph.node_count)


def pad_log_hypergraph_for_mesh(graph: LogHyperGraph,
                                data_parallel: int) -> LogHyperGraph:
    """``graph`` with its edge count padded to a multiple of
    ``data_parallel`` by memberless edges of degree 1, which add nothing
    to either sum; ``graph`` itself when no edge is added."""
    e = graph.edge_count
    e_pad = round_up(max(e, 1), data_parallel)
    if e_pad == e:
        return graph
    sizes = np.diff(graph.edge_rowptr.numpy()).astype(np.int64)
    de = np.concatenate([graph.de.numpy().reshape(-1),
                         np.ones(e_pad - e, np.float32)])
    return log_hypergraph_from_edges(
        graph.edge_nodes.numpy(),
        np.concatenate([sizes, np.zeros(e_pad - e, np.int64)]),
        graph.node_count, dv=graph.dv,
        de=torch.from_numpy(de.reshape(-1, 1)))


def pad_graph_for_mesh(graph, data_parallel: int):
    """``graph`` padded for ``data_parallel`` ranks by the pad of its
    type (the module docstring)."""
    if isinstance(graph, HyperGraph):
        return pad_hypergraph_for_mesh(graph, data_parallel)
    if isinstance(graph, Graph2D):
        return pad_graph2d_for_mesh(graph, data_parallel)
    if isinstance(graph, LogHyperGraph):
        return pad_log_hypergraph_for_mesh(graph, data_parallel)
    raise TypeError(type(graph))


def shard_graph(graph, mesh: Mesh, pack_kernels: bool = False,
                chunk_rows_cap: int = CHUNK_ROWS_CAP):
    """The slice of data index ``mesh.data_index`` of the padded CPU
    ``graph`` (see the
    module docstring); its node sums are partials the layers combine over
    ``mesh``. ``pack_kernels``: a hypergraph slice carries the routed pack
    of its real edges, in chunks of at most ``chunk_rows_cap`` grid rows."""
    if getattr(graph, "mesh", None) is not None:
        raise ValueError("the graph is a rank's slice already")
    if isinstance(graph, HyperGraph):
        block = mesh.block(graph.edge_count)
        i3 = graph.i3.numpy()[block]
        mask = (None if graph.edge_mask is None
                else graph.edge_mask.numpy().reshape(-1)[block])
        if pack_kernels:
            if mask is not None:
                i3, mask = i3[mask > 0], None
            local = hypergraph_from_i3(i3, graph.node_count, dv=graph.dv)
            kp = (build_hyper_kernel_pack(i3, graph.node_count,
                                          chunk_rows_cap=chunk_rows_cap)
                  if len(i3) else None)
            return dataclasses.replace(local, kp=kp, mesh=mesh)
        if mask is not None and mask.all():
            mask = None
        local = hypergraph_from_i3(i3, graph.node_count, dv=graph.dv,
                                   edge_mask=mask)
        return dataclasses.replace(local, mesh=mesh)
    if isinstance(graph, Graph2D):
        block = mesh.block(graph.nnz)
        local = graph2d_from_coo(graph.row.numpy()[block],
                                 graph.col.numpy()[block],
                                 graph.val.numpy()[block], graph.dv,
                                 graph.node_count)
        return dataclasses.replace(
            local, t_val=local.val[local.dst_order.long()], mesh=mesh)
    if isinstance(graph, LogHyperGraph):
        block = mesh.block(graph.edge_count)
        rowptr = graph.edge_rowptr.numpy()
        members = graph.edge_nodes.numpy()[rowptr[block.start]:
                                           rowptr[block.stop]]
        local = log_hypergraph_from_edges(
            members, np.diff(rowptr[block.start:block.stop + 1]),
            graph.node_count, dv=graph.dv, de=graph.de[block].clone())
        return dataclasses.replace(local, mesh=mesh)
    raise TypeError(type(graph))


def shard_batch(batch: Batch, mesh: Mesh) -> Batch:
    """The rank's contiguous block of ``batch``'s rows (the last axis, so
    a stacked ``[k, R]`` batch keeps its k microbatches)."""
    block = mesh.block(batch.users.shape[-1])
    return Batch(*(getattr(batch, f.name)[..., block]
                   for f in dataclasses.fields(Batch)))


@dataclasses.dataclass(frozen=True)
class ShardedBag:
    """The rank's slice of the word bags: queries ``[k·Qs, (k+1)·Qs)`` of
    ``Qs = ceil(Q / S)``, dummy queries with no word past Q
    (``ShardedBagPack``, ``ihgnn_tpu/ops/bag.py:233-333``), k the data
    index. Its ``mean`` is every data index's slice of bag means
    all-gathered over the data group, the first Q rows; the vocab table's
    gradient is the rank's partial."""

    local: WordBag
    query_count: int
    mesh: Mesh

    def mean(self, vocab_table: torch.Tensor) -> torch.Tensor:
        local = BagMeanFn.apply(vocab_table, self.local)
        return gather_slices(local, self.mesh)[:self.query_count]

    def to(self, device: DeviceLike) -> "ShardedBag":
        return dataclasses.replace(self, local=self.local.to(device))


def shard_bag(query_words, query_word_counts, vocab_rows: int,
              mesh: Mesh) -> ShardedBag:
    """The rank's ``ShardedBag`` (CPU) of ``query_words`` ``[Q, L]``."""
    words = np.asarray(query_words)
    counts = np.asarray(query_word_counts)
    q = len(words)
    per = -(-max(q, 1) // mesh.data)
    lo, hi = mesh.data_index * per, min((mesh.data_index + 1) * per, q)
    mine_w = np.zeros((per, words.shape[1]), words.dtype)
    mine_c = np.zeros(per, counts.dtype)
    if hi > lo:
        mine_w[:hi - lo] = words[lo:hi]
        mine_c[:hi - lo] = counts[lo:hi]
    return ShardedBag(make_word_bag(mine_w, mine_c, vocab_rows), q, mesh)
