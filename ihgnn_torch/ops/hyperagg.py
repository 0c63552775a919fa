"""The sparse aggregations of the layers, with autograd.

Counterpart of ``ihgnn_tpu/ops/hyperagg.py`` ``make_hyper_ops`` and its
custom VJPs ``_gather_roles_pallas`` / ``_scatter_pallas``
(``hyperagg.py:403-493``). The TPU packs route both directions through
windowed expands, Clos stages and a node-tile segment-sum; on the card
each direction is one kernel, and each backward is K1 over a CSR the host
builds once (``graph.py``):

* gather  — K2 ``gather_roles`` over ``i3``: ``[N, d]`` → ``[3, E, d]``.
  Backward: K1 over ``(rowptr, inc_slot)`` from the role cotangents, read
  as ``[3E, d]``, into ``[N, d]``. ``InteractFn`` takes the ``[3, E, d]``
  roles whole and gives back their cotangent as one buffer, so no
  concatenation is needed.
* scatter — ``SpmmFn``, K1 ``csr_gather_sum`` over ``(rowptr,
  inc_edge)``: ``[E, d]`` → ``[N, d]`` = H·E, accumulated in f32.
  Backward: K1 over ``(edge_rowptr, i3.view(-1))``, ``dedge[e] =
  cot[u_e] + cot[q_e] + cot[i_e]``.

``SpmmFn`` is any CSR product A·x whose backward is Aᵀ·cot over Aᵀ's own
CSR, both K1. Besides the scatter it carries:

* ``make_spmm_op`` — GCN's 2D-graph SpMM (``hyperagg.py:1049-1145``):
  K1 with ``weight = val`` over the row CSR. A is symmetric in structure
  and values (Helpers/Graph.py:40-63), so the backward is the same call on
  the cotangent; ``val`` is graph structure and has no gradient.
* ``make_log_ops`` — the log hypergraph's incidence
  (``models/layers.py:185-192``): edge sums are K1 over the edge-major
  CSR, node sums K1 over the node-major CSR, each the other's backward.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from ihgnn_torch.graph import Graph2D, HyperGraph, LogHyperGraph
from ihgnn_torch.ops.gather import gather_roles
from ihgnn_torch.ops.segsum import csr_gather_sum


class GatherRolesFn(torch.autograd.Function):
    """``x [N, d]`` → ``[3, E, d]`` (u, q, i) endpoint rows; the gradient
    of ``x`` sums, for each node, the role cotangent rows of its edges."""

    @staticmethod
    def forward(ctx, x, i3, inc_slot, rowptr):
        ctx.save_for_backward(inc_slot, rowptr)
        return gather_roles(x, i3)

    @staticmethod
    def backward(ctx, droles):
        inc_slot, rowptr = ctx.saved_tensors
        flat = droles.contiguous().view(-1, droles.shape[2])
        return csr_gather_sum(flat, inc_slot, rowptr), None, None, None


class SpmmFn(torch.autograd.Function):
    """``out = A·x`` for the CSR ``A = (rowptr, col, weight)``; the
    gradient of ``x`` is ``Aᵀ·cot`` over ``Aᵀ = (t_rowptr, t_col,
    t_weight)``. A weight of None is 1 for every entry."""

    @staticmethod
    def forward(ctx, x, col, rowptr, weight, t_col, t_rowptr, t_weight):
        ctx.save_for_backward(t_col, t_rowptr, t_weight)
        return csr_gather_sum(x.contiguous(), col, rowptr, weight)

    @staticmethod
    def backward(ctx, cot):
        t_col, t_rowptr, t_weight = ctx.saved_tensors
        dx = csr_gather_sum(cot.contiguous(), t_col, t_rowptr, t_weight)
        return dx, None, None, None, None, None, None


def make_hyper_ops(graph: HyperGraph) -> Tuple[
        Callable[[torch.Tensor], torch.Tensor],
        Callable[[torch.Tensor], torch.Tensor]]:
    """Returns ``(gather_roles, scatter_incidence)`` bound to ``graph``,
    each through its autograd Function.

    ``gather_roles(x [N, d])`` is the ``[3, E, d]`` (u, q, i) endpoint rows
    in edge order; ``scatter_incidence(edge [E, d])`` is the ``[N, d]``
    f32 sum, per node, of the rows of the edges it belongs to."""

    def gather(x: torch.Tensor) -> torch.Tensor:
        return GatherRolesFn.apply(x, graph.i3, graph.inc_slot, graph.rowptr)

    def scatter(edge: torch.Tensor) -> torch.Tensor:
        return SpmmFn.apply(edge, graph.inc_edge, graph.rowptr, None,
                            graph.i3.view(-1), graph.edge_rowptr, None)

    return gather, scatter


def make_spmm_op(graph: Graph2D) -> Callable[[torch.Tensor], torch.Tensor]:
    """``x [N, d]`` ↦ ``A·x`` for the symmetric 2D adjacency ``A``."""
    col, rowptr, val = graph.col, graph.rowptr, graph.val

    def spmm(x: torch.Tensor) -> torch.Tensor:
        return SpmmFn.apply(x, col, rowptr, val, col, rowptr, val)

    return spmm


def make_log_ops(graph: LogHyperGraph) -> Tuple[
        Callable[[torch.Tensor], torch.Tensor],
        Callable[[torch.Tensor], torch.Tensor]]:
    """Returns ``(edge_sum, node_sum)`` over the log hypergraph's
    incidence: ``edge_sum(x [N, d])`` is ``[E, d]``, each edge's member
    rows summed; ``node_sum(edge [E, d])`` is ``[N, d]``, each node's
    edge rows summed."""
    nodes, edge_rowptr = graph.edge_nodes, graph.edge_rowptr
    edges, rowptr = graph.inc_edge, graph.rowptr

    def edge_sum(x: torch.Tensor) -> torch.Tensor:
        return SpmmFn.apply(x, nodes, edge_rowptr, None, edges, rowptr, None)

    def node_sum(edge: torch.Tensor) -> torch.Tensor:
        return SpmmFn.apply(edge, edges, rowptr, None, nodes, edge_rowptr,
                            None)

    return edge_sum, node_sum
