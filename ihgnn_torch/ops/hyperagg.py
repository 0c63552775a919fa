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
  cot[u_e] + cot[q_e] + cot[i_e]``, in K1's fixed-width form (3 entries
  an edge, no ``rowptr`` read).

``SpmmFn`` is any CSR product A·x whose backward is Aᵀ·cot over Aᵀ's own
CSR, both K1. Besides the scatter it carries:

* ``make_spmm_op`` — GCN's 2D-graph SpMM (``hyperagg.py:1049-1145``):
  K1 with ``weight = val`` over the row CSR. A is symmetric in structure
  and values (Helpers/Graph.py:40-63), so the backward is the same call on
  the cotangent; ``val`` is graph structure and has no gradient.
* ``make_log_ops`` — the log hypergraph's incidence
  (``models/layers.py:185-192``): edge sums are K1 over the edge-major
  CSR, node sums K1 over the node-major CSR, each the other's backward.

bf16 streams (``make_hyper_ops(graph, bf16_stream=True)``; the Pallas
kernels' contract, ``ihgnn_tpu/ops/hyperagg.py:950-1045`` and
``:463-476``): the gather writes bf16 roles (K2's bf16 form rounds the f32
``x`` in the copy), and its backward sums the bf16 role cotangents in f32
into an f32 ``[N, d]`` (K1, bf16 rows in). The scatter sums bf16 edge rows
in f32 into f32 node rows; its backward rounds the f32 node cotangent to
bf16, sums each edge's three rows in f32 and rounds the sum once, a bf16
edge gradient (K1's fixed-width form, bf16 in and out). The Pallas path
adds the three bf16 expansions in bf16 instead; ROADMAP §3 states the
difference. The routed path's bf16 streams are described with its chains
below.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

from ihgnn_torch.graph import Graph2D, HyperGraph, LogHyperGraph
from ihgnn_torch.ops.gather import gather_roles, gather_rows, gather_rows_t
from ihgnn_torch.ops.packing import (AnyHyperPack, HyperKernelPack, RolePack,
                                     RoleTables)
from ihgnn_torch.ops.permute import (row_local_permute,
                                     transposed_local_permute)
from ihgnn_torch.ops.segsum import csr_gather_sum, csr_segment_sum3
from ihgnn_torch.parallel.collectives import combine_nodes


class GatherRolesFn(torch.autograd.Function):
    """``x [N, d]`` → ``[3, E, d]`` (u, q, i) endpoint rows in ``dtype``
    (``x``'s when None); the gradient of ``x`` sums, for each node, the
    role cotangent rows of its edges in f32 (``long_segments``: those of
    ``rowptr``, or None)."""

    @staticmethod
    def forward(ctx, x, i3, inc_slot, rowptr, dtype=None,
                long_segments=None):
        ctx.save_for_backward(inc_slot, rowptr)
        ctx.long_segments = long_segments
        return gather_roles(x, i3, dtype)

    @staticmethod
    def backward(ctx, droles):
        inc_slot, rowptr = ctx.saved_tensors
        flat = droles.contiguous().view(-1, droles.shape[2])
        return (csr_gather_sum(flat, inc_slot, rowptr,
                               long_segments=ctx.long_segments),
                None, None, None, None, None)


class SpmmFn(torch.autograd.Function):
    """``out = A·x`` for the CSR ``A = (rowptr, col, weight)``, in f32; the
    gradient of ``x`` is ``Aᵀ·cot`` over ``Aᵀ = (t_rowptr, t_col,
    t_weight)``. A weight of None is 1 for every entry; ``t_width``, when
    given, is the entry count of every row of Aᵀ (``csr_gather_sum``'s
    ``width``); ``long`` and ``t_long`` are the long segments of ``rowptr``
    and ``t_rowptr``, or None. For a bf16 ``x`` (the scatter of bf16 edge
    rows) the gradient is bf16: ``cot`` rounded to bf16, summed in f32,
    rounded once."""

    @staticmethod
    def forward(ctx, x, col, rowptr, weight, t_col, t_rowptr, t_weight,
                t_width=None, long=None, t_long=None):
        ctx.save_for_backward(t_col, t_rowptr, t_weight)
        ctx.t_width, ctx.t_long = t_width, t_long
        ctx.bf16 = x.dtype == torch.bfloat16
        return csr_gather_sum(x.contiguous(), col, rowptr, weight,
                              long_segments=long)

    @staticmethod
    def backward(ctx, cot):
        t_col, t_rowptr, t_weight = ctx.saved_tensors
        if ctx.bf16:
            dx = csr_gather_sum(cot.to(torch.bfloat16).contiguous(), t_col,
                                t_rowptr, t_weight, width=ctx.t_width,
                                out_dtype=torch.bfloat16)
        else:
            dx = csr_gather_sum(cot.contiguous(), t_col, t_rowptr, t_weight,
                                width=ctx.t_width, long_segments=ctx.t_long)
        return dx, None, None, None, None, None, None, None, None, None


# ---------------------------------------------------------------------------
# the routed path (graph.kp): the TPU's σ-ordered kernel pipeline
# ---------------------------------------------------------------------------
#
# ``ihgnn_tpu/ops/hyperagg.py:138-320,403-649`` on the routed pack
# (``ops/packing.py``). Streams are row-major ``[e_pad, d]``, viewed as the
# ``[R, C, d]`` grid (or ``[C, R, d]`` after a transpose). Forward chains
# (role-sorted → σ order), one kernel each step:
#
#   u: gather_rows(idx)
#   q: gather_rows_t(idx) [C, R] → transposed_local_permute(p1) [R, C]
#   i: as q, then row_local_permute(p2) (stopped before it, "t1" order,
#      when the absorbed interaction applies p2 itself)
#
# and inverse chains (σ order → the stage-0 order of the node sums' ids):
#
#   q: transposed_local_permute(p1_inv, pre=True)
#   i: transposed_local_permute(p2_inv) [C, R] → transposed_local_permute(
#      p1_inv) [R, C]; from t1 order (o2 of the absorbed interaction) the
#      q form with i's p1_inv
#
# Node sums are K1's three-region form over the pack's CSR. A gather's
# backward is the inverse chains and a node sum; a scatter's backward the
# forward chains, summed over the roles.
#
# bf16 streams (the Pallas path's own, ``hyperagg.py:403-649``,
# ``:969-971``): the expands of the f32 node rows write bf16 rows (x
# rounded at the gather's entry, in the copy), the permutes copy them, and
# the node sums run in f32 into f32 rows. A gather's backward sums the bf16
# role cotangents in f32 and rounds the sum once to bf16, which the f32 x
# then takes widened: the Pallas path's ``grad.astype(cu.dtype)``
# (``:430``, ``:597``), followed here where the direct path keeps the f32
# sum. A scatter's backward expands the node cotangent rounded to bf16
# (``:468``, ``:628``); ``Scatter2Fn`` adds its u and q expansions in bf16,
# one rounding, as Pallas does, and ``RoutedScatterFn`` sums its three in
# f32 and rounds once (the direct path's departure, ROADMAP §3).


def _role_forward(x: torch.Tensor, rt, stop_pre_p2: bool = False,
                  out=None, dtype=None) -> torch.Tensor:
    """Role rows in σ order ``[R, C, d]`` (t1 order for the i role with
    ``stop_pre_p2``), in ``dtype`` (``x``'s when None), written into
    ``out`` when given. ``rt`` is a σ pack's ``RoleTables`` or a non-σ
    ``RolePack``, whose chain (expand, stage 1, stage 2) gives the rows in
    edge order (``_role_forward``, ``hyperagg.py:214-238``)."""
    last = rt.p2 is None or stop_pre_p2
    t0 = gather_rows_t(x, rt.idx, dtype=dtype)               # [C, R, d]
    t1 = transposed_local_permute(t0, rt.p1, out=out if last else None)
    if last:
        return t1
    return row_local_permute(t1, rt.p2, out=out)


def _permute_to_t1(y: torch.Tensor, rp: RolePack) -> torch.Tensor:
    """Edge order → t1 order ``[R, C, d]`` of a non-σ ``RolePack``: its
    backward route's stages 0 and 1, each with its transpose
    (``_permute_to_t1``, ``hyperagg.py:240-249``); stage 2 is absorbed in
    ``rp.seg_ids``."""
    t0 = transposed_local_permute(y, rp.bwd_p0)              # [C, R, d]
    return transposed_local_permute(t0, rp.bwd_p1)           # [R, C, d]


def _sig_inverse(y: torch.Tensor, rt: RoleTables, from_pre: bool = False,
                 out=None) -> torch.Tensor:
    """σ order (t1 order with ``from_pre``) → stage-0 order, ``[R, C, d]``,
    written into ``out`` when given."""
    if rt.p2_inv is None or from_pre:
        return transposed_local_permute(y, rt.p1_inv, pre=True, out=out)
    return transposed_local_permute(transposed_local_permute(y, rt.p2_inv),
                                    rt.p1_inv, out=out)


def _grid(t: torch.Tensor, kp: HyperKernelPack) -> torch.Tensor:
    return t.contiguous().view(kp.rows, kp.cols, t.shape[-1])


def _chunks(kp: AnyHyperPack):
    """``(chunk, rows of its streams, first edge)`` of each chunk of
    ``kp`` (the pack itself when it has no chunks): chunk k's streams are
    rows ``[offset, offset + e_pad_k)`` of the pack's ``[e_pad, d]``
    streams."""
    offset = edge = 0
    for pk in kp.packs:
        yield pk, slice(offset, offset + pk.e_pad), edge
        offset += pk.e_pad
        edge += pk.edge_count


def _rank_regions(y_q: torch.Tensor, y_i: torch.Tensor, kp: AnyHyperPack,
                  i_from_pre: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The q and i regions ``[e_pad, d]`` of a node sum: each chunk's rows
    of ``y_q`` and ``y_i`` (σ order, ``y_i`` in t1 order with
    ``i_from_pre``) through its inverse chains, written into the chunk's
    rows."""
    d = y_q.shape[-1]
    y_q, y_i = y_q.contiguous(), y_i.contiguous()
    rq, ri = torch.empty_like(y_q), torch.empty_like(y_i)
    for pk, rows, _ in _chunks(kp):
        _sig_inverse(y_q[rows].view(pk.rows, pk.cols, d), pk.q,
                     out=rq[rows].view(pk.rows, pk.cols, d))
        _sig_inverse(y_i[rows].view(pk.rows, pk.cols, d), pk.i,
                     from_pre=i_from_pre,
                     out=ri[rows].view(pk.rows, pk.cols, d))
    return rq, ri


def _segsum_regions(u, q, i, kp: AnyHyperPack,
                    out_dtype=None) -> torch.Tensor:
    """``[N, d]`` node sums of the ``[u | q | i]`` regions (each ``[e_pad,
    d]``), in f32 (rounded once to ``out_dtype`` when given); σ pads are
    dropped. On a chunked pack this one K1 over the CSR spanning the chunks
    is ``csr_segment_sum3_multi`` (``hyperagg.py:328-356``)."""
    d = u.shape[-1]
    return csr_segment_sum3(u.reshape(-1, d), q.reshape(-1, d),
                            i.reshape(-1, d), kp.seg_col, kp.seg_rowptr,
                            out_dtype)


def _gather_roles(x: torch.Tensor, kp: AnyHyperPack,
                  stop_pre_p2: bool, dtype=None) -> torch.Tensor:
    """``[3, e_pad, d]`` in ``dtype`` (``x``'s when None): u and q in σ
    order, i in σ (or t1) order; each chunk writes its rows."""
    x = x.contiguous()
    d = x.shape[1]
    roles = torch.empty(3, kp.e_pad, d, dtype=dtype or x.dtype,
                        device=x.device)
    for pk, rows, _ in _chunks(kp):
        grid = (pk.rows, pk.cols, d)
        gather_rows(x, pk.u.idx, out=roles[0, rows].view(grid))
        _role_forward(x, pk.q, out=roles[1, rows].view(grid),
                      dtype=roles.dtype)
        _role_forward(x, pk.i, stop_pre_p2, out=roles[2, rows].view(grid),
                      dtype=roles.dtype)
    return roles


def _gather_gradient(cot: torch.Tensor, kp: AnyHyperPack, from_pre: bool,
                     x_dtype) -> torch.Tensor:
    """The gradient of a gather's ``x`` (``x_dtype``) for the role
    cotangents ``cot`` ``[3, e_pad, d]``: the inverse chains' node sum,
    rounded once to bf16 for bf16 cotangents (then widened)."""
    cot = cot.contiguous()
    bf16 = cot.dtype == torch.bfloat16
    rq, ri = _rank_regions(cot[1], cot[2], kp, from_pre)
    grad = _segsum_regions(cot[0], rq, ri, kp,
                           torch.bfloat16 if bf16 else None)
    return grad.to(x_dtype)


def _scatter_gradient(cot: torch.Tensor, kp: AnyHyperPack,
                      stop_pre_p2: bool, dtype):
    """The three role expansions ``[e_pad, d]`` of a node cotangent in
    ``dtype`` (the edge stream's), each chunk writing its rows."""
    cot = cot.contiguous()
    d = cot.shape[1]
    gu, gq, gi = (torch.empty(kp.e_pad, d, dtype=dtype, device=cot.device)
                  for _ in range(3))
    for pk, rows, _ in _chunks(kp):
        grid = (pk.rows, pk.cols, d)
        gather_rows(cot, pk.u.idx, out=gu[rows].view(grid))
        _role_forward(cot, pk.q, out=gq[rows].view(grid), dtype=dtype)
        _role_forward(cot, pk.i, stop_pre_p2, out=gi[rows].view(grid),
                      dtype=dtype)
    return gu, gq, gi


class RoutedGatherFn(torch.autograd.Function):
    """``x [N, d]`` → ``[3, e_pad, d]`` role rows in σ order, in ``dtype``
    (``x``'s when None) (``_gather_roles_pallas``,
    ``hyperagg.py:403-432``); the gradient of ``x`` is the inverse chains'
    node sum. ``kp`` is a routed pack or a chunked one."""

    @staticmethod
    def forward(ctx, x, kp, dtype=None):
        ctx.kp, ctx.x_dtype = kp, x.dtype
        return _gather_roles(x, kp, stop_pre_p2=False, dtype=dtype)

    @staticmethod
    def backward(ctx, cot):
        return (_gather_gradient(cot, ctx.kp, False, ctx.x_dtype), None,
                None)


class RoutedScatterFn(torch.autograd.Function):
    """``edge [e_pad, d]`` (σ order, f32 or bf16) → ``[N, d]`` f32 node
    sums (``_scatter_pallas``, ``hyperagg.py:435-493``); the gradient of
    ``edge`` is the sum of the three role expansions of the node
    cotangent (for bf16 rows summed in f32, rounded once), zero at the σ
    pads (copies of real rows: they would reach the interaction's dW)."""

    @staticmethod
    def forward(ctx, edge, kp):
        ctx.kp, ctx.dtype = kp, edge.dtype
        edge = edge.contiguous()
        return _segsum_regions(edge, *_rank_regions(edge, edge, kp, False),
                               kp)

    @staticmethod
    def backward(ctx, cot):
        kp = ctx.kp
        gu, gq, gi = _scatter_gradient(cot, kp, False, ctx.dtype)
        if ctx.dtype == torch.bfloat16:
            grad = (gu.float() + gq + gi).to(torch.bfloat16)
        else:
            grad = gu + gq + gi
        if kp.sig_mask is not None:
            grad = grad * kp.sig_mask[:, None].to(grad.dtype)
        return grad, None


class GatherPreFn(torch.autograd.Function):
    """``RoutedGatherFn`` with the i role in t1 order, for the absorbed
    interaction (``_gather_pre_pallas``, ``hyperagg.py:556-599``); its
    backward takes the i cotangent in t1 order."""

    @staticmethod
    def forward(ctx, x, kp, dtype=None):
        ctx.kp, ctx.x_dtype = kp, x.dtype
        return _gather_roles(x, kp, stop_pre_p2=True, dtype=dtype)

    @staticmethod
    def backward(ctx, cot):
        return (_gather_gradient(cot, ctx.kp, True, ctx.x_dtype), None,
                None)


class Scatter2Fn(torch.autograd.Function):
    """``(edge, pre_i)`` → ``[N, d]`` f32: the node sums of the absorbed
    interaction's two outputs (f32 or bf16), ``edge`` in σ order for the u
    and q regions and ``pre_i`` = ρ(edge) for the i region
    (``_scatter2_pallas``, ``hyperagg.py:602-649``). Its backward leaves
    the σ pads unmasked: the absorbed interaction's backward masks the
    merged cotangent."""

    @staticmethod
    def forward(ctx, edge, pre_i, kp):
        ctx.kp, ctx.dtype = kp, edge.dtype
        edge = edge.contiguous()
        return _segsum_regions(edge, *_rank_regions(edge, pre_i, kp, True),
                               kp)

    @staticmethod
    def backward(ctx, cot):
        gu, gq, gi = _scatter_gradient(cot, ctx.kp, True, ctx.dtype)
        return gu + gq, gi, None


class SigmaToEdgeFn(torch.autograd.Function):
    """``edge [e_pad, d]`` in σ order → ``[E, d]`` in edge order, q's last
    stage (``sigma_to_edge_order``, ``hyperagg.py:284-298``), for phase 2,
    which indexes edges by id. A chunk's real edges go to its first edge's
    row, so pads in any chunk are dropped (the JAX package slices the
    chunks' concat at E, right only when no chunk but the last pads). The
    backward is the same permute by the inverse table; the σ pads get 0."""

    @staticmethod
    def forward(ctx, edge, kp):
        ctx.kp = kp
        if len(kp.packs) == 1:
            out = row_local_permute(_grid(edge, kp), kp.sig)
            return out.view(kp.e_pad, -1)[:kp.edge_count]
        edge = edge.contiguous()
        d = edge.shape[1]
        out = edge.new_empty(kp.edge_count, d)
        for pk, rows, first in _chunks(kp):
            grid = (pk.rows, pk.cols, d)
            dst = out[first:first + pk.edge_count]
            if pk.edge_count == pk.e_pad:
                row_local_permute(edge[rows].view(grid), pk.sig,
                                  out=dst.view(grid))
            else:
                dst.copy_(row_local_permute(edge[rows].view(grid), pk.sig)
                          .view(pk.e_pad, d)[:pk.edge_count])
        return out

    @staticmethod
    def backward(ctx, cot):
        kp = ctx.kp
        cot = cot.contiguous()
        d = cot.shape[1]
        grad = cot.new_empty(kp.e_pad, d)
        for pk, rows, first in _chunks(kp):
            grid = (pk.rows, pk.cols, d)
            part = cot[first:first + pk.edge_count]
            if pk.edge_count != pk.e_pad:
                full = cot.new_zeros(pk.e_pad, d)
                full[:pk.edge_count] = part
                part = full
            row_local_permute(part.view(grid), pk.sig_inv,
                              out=grad[rows].view(grid))
        return grad, None


def sigma_to_edge_order(edge: torch.Tensor,
                        kp: AnyHyperPack) -> torch.Tensor:
    """``[E, d]``: the σ-ordered ``edge`` ``[e_pad, d]`` in edge order."""
    return SigmaToEdgeFn.apply(edge, kp)


def strip_kernel_packing(graph):
    """``graph`` without its routed packs (a hypergraph's ``kp``, a 2D
    graph's ``pk_role`` and ``gat_pk``; ``hyperagg.py:78-88``): the layers
    take the direct path."""
    if isinstance(graph, Graph2D):
        return dataclasses.replace(graph, pk_role=None, pk_entry=None,
                                   gat_pk=None)
    return dataclasses.replace(graph, kp=None)


def _spmm_role(x: torch.Tensor, rp: RolePack, entry: torch.Tensor,
               rowptr: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """``A·x`` by the routed expand: ``x[col]`` in entry order by the
    non-σ role forward, then K1 over the row CSR weighted by ``val``
    (``_spmm_role_impl``, ``hyperagg.py:1076-1090``)."""
    rows = _role_forward(x.contiguous(), rp)
    return csr_gather_sum(rows.view(rp.e_pad, -1), entry, rowptr, val)


class RoutedSpmmFn(torch.autograd.Function):
    """The routed GCN SpMM (``_spmm_role_t``, ``hyperagg.py:1093-1113``):
    ``A·x`` for the symmetric 2D adjacency, whose ``x[col]`` expand runs
    the role pack ``rp`` (K2, K7, K6) and whose sum is K1 over the row CSR
    ``(entry, rowptr)`` with weight ``val``. A is symmetric in structure
    and values, so the backward is the same op on the cotangent; ``val``
    is graph structure and gets no gradient."""

    @staticmethod
    def forward(ctx, x, rp, entry, rowptr, val):
        ctx.rp = rp
        ctx.save_for_backward(entry, rowptr, val)
        return _spmm_role(x, rp, entry, rowptr, val)

    @staticmethod
    def backward(ctx, cot):
        entry, rowptr, val = ctx.saved_tensors
        return (_spmm_role(cot, ctx.rp, entry, rowptr, val), None, None,
                None, None)


def make_hyper_ops(graph: HyperGraph, bf16_stream: bool = False,
                   absorb: bool = False, combine: bool = True) -> Tuple[
        Callable[[torch.Tensor], torch.Tensor],
        Callable[[torch.Tensor], torch.Tensor]]:
    """Returns ``(gather_roles, scatter_incidence)`` bound to ``graph``,
    each through its autograd Function.

    ``gather_roles(x [N, d])`` is the ``[3, E', d]`` (u, q, i) endpoint
    rows; ``scatter_incidence(edge [E', d])`` is the ``[N, d]`` f32 sum,
    per node, of the rows of the edges it belongs to. On the direct path
    (``graph.kp`` None) E' = E and the rows are in edge order. With a
    routed pack E' = e_pad and the rows are in σ order, the σ pads holding
    copies of real rows that the scatter drops; with ``absorb`` the i rows
    are in t1 order and the scatter takes the absorbed interaction's pair
    ``(o1, o2)`` (``InteractAbsorbFn``).

    ``bf16_stream``: bf16 streams (the module docstring, and the routed
    chains' note): the role rows are bf16, and the scatter takes bf16 edge
    rows.

    On a rank's slice (``graph.mesh``, ``parallel/sharding.py``) both run
    on the rank's edges, and the scatter's node sums are the rank's
    partial, which it combines over the mesh (``combine_nodes``: f32, or
    on bf16 streams the bf16 wire when ``mesh.bf16_wire``); with
    ``combine`` False it returns the partial (the tail psum's input)."""
    kp = graph.kp
    dtype = torch.bfloat16 if bf16_stream else None
    mesh = graph.mesh
    if kp is not None and absorb:
        def gather(x):
            return GatherPreFn.apply(x, kp, dtype)

        def local(pair):
            return Scatter2Fn.apply(pair[0], pair[1], kp)
    elif kp is not None:
        def gather(x):
            return RoutedGatherFn.apply(x, kp, dtype)

        def local(edge):
            return RoutedScatterFn.apply(edge, kp)
    elif absorb:
        raise ValueError("the absorbed interaction needs a routed pack")
    else:
        def gather(x):
            return GatherRolesFn.apply(x, graph.i3, graph.inc_slot,
                                       graph.rowptr, dtype,
                                       graph.long_segments)

        def local(edge):
            return SpmmFn.apply(edge, graph.inc_edge, graph.rowptr, None,
                                graph.i3.view(-1), graph.edge_rowptr, None,
                                3, graph.long_segments)

    if mesh is None or not combine:
        return gather, local
    bf16_wire = bf16_stream and mesh.bf16_wire
    return gather, lambda edge: combine_nodes(local(edge), mesh, bf16_wire)


def make_spmm_op(graph: Graph2D) -> Callable[[torch.Tensor], torch.Tensor]:
    """``x [N, d]`` ↦ ``A·x`` for the symmetric 2D adjacency ``A``: the
    routed SpMM when the graph carries ``pk_role``
    (``hyperagg.py:1115-1145``), else ``SpmmFn``."""
    col, rowptr, val = graph.col, graph.rowptr, graph.val
    if graph.mesh is not None:
        # a rank's entries: A_r is not symmetric, so its backward runs
        # over its transpose (the destination-ordered CSR), and the
        # partial A_r·x is combined over the mesh
        att, mesh = graph.attention, graph.mesh
        return lambda x: combine_nodes(SpmmFn.apply(
            x, col, rowptr, val, att.src, att.dst_rowptr, graph.t_val),
            mesh)
    if graph.pk_role is not None:
        rp, entry = graph.pk_role, graph.pk_entry
        return lambda x: RoutedSpmmFn.apply(x, rp, entry, rowptr, val)

    def spmm(x: torch.Tensor) -> torch.Tensor:
        return SpmmFn.apply(x, col, rowptr, val, col, rowptr, val)

    return spmm


def make_log_ops(graph: LogHyperGraph) -> Tuple[
        Callable[[torch.Tensor], torch.Tensor],
        Callable[[torch.Tensor], torch.Tensor]]:
    """Returns ``(edge_sum, node_sum)`` over the log hypergraph's
    incidence: ``edge_sum(x [N, d])`` is ``[E, d]``, each edge's member
    rows summed; ``node_sum(edge [E, d])`` is ``[N, d]``, each node's
    edge rows summed. On a rank's block of whole edges (``graph.mesh``)
    ``edge_sum`` is local, and ``node_sum`` combines the rank's partial
    over the mesh (``combine_nodes``, f32)."""
    nodes, edge_rowptr = graph.edge_nodes, graph.edge_rowptr
    edges, rowptr = graph.inc_edge, graph.rowptr
    mesh, hubs = graph.mesh, graph.long_segments

    def edge_sum(x: torch.Tensor) -> torch.Tensor:
        return SpmmFn.apply(x, nodes, edge_rowptr, None, edges, rowptr, None,
                            None, None, hubs)

    def node_sum(edge: torch.Tensor) -> torch.Tensor:
        out = SpmmFn.apply(edge, edges, rowptr, None, nodes, edge_rowptr,
                           None, None, hubs)
        return out if mesh is None else combine_nodes(out, mesh)

    return edge_sum, node_sum
