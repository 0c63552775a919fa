"""The gather/scatter pair of the hypergraph convolution, with autograd.

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
* scatter — K1 ``csr_gather_sum`` over ``(rowptr, inc_edge)``:
  ``[E, d]`` → ``[N, d]`` = H·E, accumulated in f32. Backward: K1 over
  ``(edge_rowptr, i3.view(-1))``, ``dedge[e] = cot[u_e] + cot[q_e] +
  cot[i_e]``.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from ihgnn_torch.graph import HyperGraph
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


class ScatterIncidenceFn(torch.autograd.Function):
    """``edge [E, d]`` → ``[N, d]`` f32 sums of each node's edge rows; the
    gradient of an edge row is the sum of its three nodes' cotangents."""

    @staticmethod
    def forward(ctx, edge, inc_edge, rowptr, i3_flat, edge_rowptr):
        ctx.save_for_backward(i3_flat, edge_rowptr)
        return csr_gather_sum(edge, inc_edge, rowptr)

    @staticmethod
    def backward(ctx, cot):
        i3_flat, edge_rowptr = ctx.saved_tensors
        dedge = csr_gather_sum(cot.contiguous(), i3_flat, edge_rowptr)
        return dedge, None, None, None, None


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
        return ScatterIncidenceFn.apply(edge, graph.inc_edge, graph.rowptr,
                                        graph.i3.view(-1), graph.edge_rowptr)

    return gather, scatter
