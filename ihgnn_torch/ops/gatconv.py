"""GAT attention convolution over a destination-sorted edge list, with
autograd.

Counterpart of ``ihgnn_tpu/ops/gatconv.py`` ``gat_conv_t`` (``_gat_impl``,
``_gat_bwd_impl``, ``gatconv.py:243-362``) with the semantics of
``_GatCore`` (``models/layers.py:63-101``; reference:
Models/GnnLayers.py:96-115): per entry src → dst a score from the head,
LeakyReLU (slope 0.01), masked entries pinned to -1e30, a softmax over
each destination's entries, and the α-weighted sum of the source rows.

Every ``[K, d]`` row stream stays inside a kernel:

* scores — concat head ``s_src[src] + s_dst[dst] + b`` (two ``[M]``
  matvecs, then scalar gathers); product head ``<x[src] ⊙ w, x[dst]>`` by
  ``csr_edge_dot``;
* softmax — K4 ``csr_segment_max`` for the stabiliser, the scalar
  ``csr_segment_sum`` for the denominators, elementwise ``[K]`` work
  between them;
* output — K1 ``csr_gather_sum(x, src, dst_rowptr, weight=α)``.

The backward is ``_gat_bwd_impl``'s math: the source rows' gradient is K1
over the source-sorted CSR with α (reordered to source order) as weight;
``tt = α · <x[src], cot[dst]>`` is ``csr_edge_dot``; ``tsum``, ``gd`` and
``gs`` are scalar segment sums; the head's gradients are dense products.
The product head adds one K1 on each side with weight ``g``. Only α and
the LeakyReLU slope (times the mask) are saved, never a ``[K, d]`` tensor.

``x`` is ``[M, d]`` over every node an entry can read; the first
``dst_count`` rows are the destinations, so the result is
``[dst_count, d]`` (IHGNN phase 2 reads node rows out of
``[nodes | edge nodes]``).

On a rank's slice (``mesh``, ``parallel/``) a destination's entries may
lie on several ranks. The softmax then combines the ranks' scalars as a
``ChunkedGatPack`` combines its packs': K4's local maxima by a max
all-reduce and the local denominators by a sum all-reduce, both of an
``[S]`` f32 stream (``parallel/collectives.py``), so α is exact on every
rank's entries; an empty destination keeps K4's -3e38 and a 0
denominator. The weighted sum is the rank's ``[S, d]`` partial, which
``gat_conv`` combines over the mesh in f32 (``combine_nodes``). The
backward's cotangent arrives whole (the combine's backward sums it);
``tsum`` is its one more sum all-reduce, and ``dx``, the head's gradients
and the bias's are the rank's partials, summed with the other parameter
gradients once a step.

``RoutedGatConvFn`` is the routed GAT of a packed 2D graph
(``graph.gat_pk``, ``ops/gatpack.py``): ``gat_conv_t`` (``_gat_impl``,
``_gat_bwd_impl``, ``gatconv.py:190-362``), row-major, with JAX's
hand-written backward. Per pack:

* ``x[src]`` in entry order ``[K_pad, d]`` by the non-σ role forward (K2
  ``gather_rows_t``, K7, K6); rows expanded by destination by K2
  ``gather_rows`` and scalars by its d = 1 form ``gather_scalars``;
* the softmax: K4 over the destination CSR, the scalar sums for the
  denominators, elementwise ``[K_pad]`` work; the output: K1 over the
  entry rows with weight α;
* the backward's source sums ``_src_scatter``: the role's backward chain
  (two K7) to t1 order, then K1 over the source ids in t1 order.

A ``ChunkedGatPack`` runs each pack and combines their segment maxima and
sums by elementwise max and add over ``[N]`` and ``[N, d]``. The head's
score products over ``[K_pad, d]`` (``x_src · w``, the product head's
``x_src ⊙ x_dst · w``) and the backward's row dots are dense PyTorch, as
the JAX package leaves them to XLA. Only f32 (the JAX package's routed
GAT runs f32 only).
"""

from __future__ import annotations

import torch

from ihgnn_torch.config import V
from ihgnn_torch.graph import AttentionCSR
from ihgnn_torch.ops.edgedot import csr_edge_dot
from ihgnn_torch.ops.gather import gather_rows, gather_scalars
from ihgnn_torch.ops.gatpack import AnyGatPack, GatPack
from ihgnn_torch.ops.hyperagg import _permute_to_t1, _role_forward
from ihgnn_torch.ops.segmax import csr_segment_max, csr_segment_sum
from ihgnn_torch.ops.segsum import csr_gather_sum
from ihgnn_torch.parallel.collectives import (all_reduce_max, all_reduce_sum,
                                              combine_nodes)

LEAKY_SLOPE = 0.01     # torch nn.LeakyReLU default (models/common.py)
MASKED_SCORE = -1e30   # finite: an all-masked segment stays NaN-free


def _take(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``v[idx]`` of a scalar ``[*]`` stream."""
    return v.index_select(0, idx)


class GatConvFn(torch.autograd.Function):
    """``x [M, d]`` → ``[S, d]`` attention output over ``csr``; ``khead``
    is the score head's kernel (``[2d]`` concat: source half first;
    ``[d]`` product), ``bhead`` its ``[1]`` bias. With ``mesh``, ``csr``
    is a rank's entries and the result the rank's partial (the module
    docstring)."""

    @staticmethod
    def forward(ctx, x, khead, bhead, csr: AttentionCSR, head: str,
                mesh=None):
        x = x.contiguous()
        d, s_count = x.shape[1], csr.dst_count
        if head == V.CONCAT:
            s_src = x @ khead[:d]
            s_dst = x[:s_count] @ khead[d:]
            pre = _take(s_src, csr.src) + _take(s_dst, csr.dst) + bhead
        elif head == V.PRODUCT:
            pre = csr_edge_dot(x[:s_count], x * khead,
                               csr.dot_order) + bhead
        else:
            raise ValueError(f"unknown GAT head {head!r}")
        # LeakyReLU as pre · slope, where the slope is also its derivative
        slope = torch.where(pre > 0, 1.0, LEAKY_SLOPE)
        scores = pre * slope
        if csr.mask is not None:
            scores = torch.where(csr.mask > 0, scores, MASKED_SCORE)
            slope = slope * csr.mask
        m = csr_segment_max(scores, csr.dst_rowptr)
        if mesh is not None:
            m = all_reduce_max(m, mesh)
        w = torch.exp(scores - _take(m, csr.dst))
        if csr.mask is not None:
            w = w * csr.mask
        den = csr_segment_sum(w, csr.dst_rowptr)
        if mesh is not None:
            den = all_reduce_sum(den, mesh, kind="scalar",
                                 site="softmax_sum")
        alpha = w / torch.clamp(_take(den, csr.dst), min=1e-30)
        ctx.save_for_backward(x, khead, alpha, slope)
        ctx.csr, ctx.head, ctx.mesh = csr, head, mesh
        return csr_gather_sum(x, csr.src, csr.dst_rowptr, alpha)

    @staticmethod
    def backward(ctx, cot):
        x, khead, alpha, slope = ctx.saved_tensors
        csr, head = ctx.csr, ctx.head
        cot = cot.contiguous()
        d, s_count = x.shape[1], csr.dst_count
        x_dst = x[:s_count]
        tt = alpha * csr_edge_dot(cot, x, csr.dot_order)
        tsum = csr_segment_sum(tt, csr.dst_rowptr)
        if ctx.mesh is not None:
            tsum = all_reduce_sum(tsum, ctx.mesh, kind="scalar",
                                  site="grad:softmax_tsum")
        g = (tt - alpha * _take(tsum, csr.dst)) * slope
        g_src = _take(g, csr.to_dst)
        dx = csr_gather_sum(cot, csr.src_dst, csr.src_rowptr,
                            _take(alpha, csr.to_dst))
        if head == V.CONCAT:
            gd = csr_segment_sum(g, csr.dst_rowptr)
            gs = csr_segment_sum(g_src, csr.src_rowptr)
            dx += gs[:, None] * khead[:d]
            dx[:s_count] += gd[:, None] * khead[d:]
            dkhead = torch.cat([gs @ x, gd @ x_dst])
        else:
            # Σ over a source's entries of g · x[dst], and over a
            # destination's entries of g · x[src]
            g_x_dst = csr_gather_sum(x, csr.src_dst, csr.src_rowptr, g_src)
            g_x_src = csr_gather_sum(x, csr.src, csr.dst_rowptr, g)
            dx += g_x_dst * khead
            dx[:s_count] += g_x_src * khead
            dkhead = (x_dst * g_x_src).sum(0)
        return dx, dkhead, g.sum().reshape(1), None, None, None


def gat_conv(x: torch.Tensor, khead: torch.Tensor, bhead: torch.Tensor,
             attention_csr: AttentionCSR, head: str = V.CONCAT,
             mesh=None) -> torch.Tensor:
    """``[S, d]`` attention conv of ``x [M, d]`` over ``attention_csr``
    (see the module docstring); ``head`` is ``V.CONCAT`` or
    ``V.PRODUCT``. With ``mesh``, ``attention_csr`` is a rank's entries
    and the result is summed over the mesh's ranks in f32."""
    out = GatConvFn.apply(x, khead, bhead, attention_csr, head, mesh)
    return out if mesh is None else combine_nodes(out, mesh)


def _dst_sum(v: torch.Tensor, p: GatPack) -> torch.Tensor:
    """``[N]`` sums by destination of an entry-order scalar stream
    (``_seg_sum``, ``gatconv.py:196``)."""
    return csr_segment_sum(v[:p.nnz], p.dst_rowptr)


def _src_scatter(v: torch.Tensor, p: GatPack) -> torch.Tensor:
    """``[N, d]`` sums by source of entry-order rows ``v`` ``[K_pad, d]``
    (``_src_scatter``, ``gatconv.py:222-235``)."""
    t1 = _permute_to_t1(v.view(p.rows, p.cols, -1), p.src)
    return csr_gather_sum(t1.view(p.k_pad, -1), p.src_col, p.src_rowptr)


def _add(total, part):
    return part if total is None else total + part


class RoutedGatConvFn(torch.autograd.Function):
    """``x [N, d]`` (f32) → ``[N, d]`` attention output over the routed
    pack ``pk`` (``GatPack`` or ``ChunkedGatPack``); ``khead`` is the score
    head's kernel (``[2d]`` concat, source half first; ``[d]`` product),
    ``bhead`` its ``[1]`` bias (``gat_conv_t``, ``gatconv.py:342-362``)."""

    @staticmethod
    def forward(ctx, x, khead, bhead, pk: AnyGatPack, head: str):
        x = x.contiguous()
        d, n = x.shape[1], x.shape[0]
        if head == V.CONCAT:
            w_src = khead[:d]
            s_dst = x @ khead[d:]                                # [N]
        elif head != V.PRODUCT:
            raise ValueError(f"unknown GAT head {head!r}")
        xs_l, xd_l, scores_l, slope_l = [], [], [], []
        m = None
        for p in pk.packs:
            xs = _role_forward(x, p.src).view(p.k_pad, d)        # x[src]
            if head == V.CONCAT:
                xd = None
                pre = xs @ w_src + gather_scalars(s_dst, p.dst_idx).view(-1)
            else:
                xd = gather_rows(x, p.dst_idx).view(p.k_pad, d)  # x[dst]
                pre = (xs * xd) @ khead
            pre = pre + bhead
            # LeakyReLU as pre · slope; slope · mask is its derivative
            slope = torch.where(pre > 0, 1.0, LEAKY_SLOPE)
            scores = torch.where(p.mask > 0, pre * slope, MASKED_SCORE)
            mk = csr_segment_max(scores[:p.nnz], p.dst_rowptr)
            m = mk if m is None else torch.maximum(m, mk)
            xs_l.append(xs)
            xd_l.append(xd)
            scores_l.append(scores)
            slope_l.append(slope * p.mask)
        w_l, den = [], None
        for p, scores in zip(pk.packs, scores_l):
            w = torch.exp(scores - gather_scalars(m, p.dst_idx).view(-1))
            w = w * p.mask
            w_l.append(w)
            den = _add(den, _dst_sum(w, p))
        alpha_l, out = [], None
        for p, w, xs in zip(pk.packs, w_l, xs_l):
            alpha = w / torch.clamp(gather_scalars(den, p.dst_idx).view(-1),
                                    min=1e-30)
            alpha_l.append(alpha)
            out = _add(out, csr_gather_sum(xs, p.entry, p.dst_rowptr,
                                           alpha[:p.nnz].contiguous()))
        ctx.save_for_backward(x, khead)
        ctx.streams = (xs_l, xd_l, alpha_l, slope_l)
        ctx.pk, ctx.head = pk, head
        return out

    @staticmethod
    def backward(ctx, cot):
        x, khead = ctx.saved_tensors
        xs_l, xd_l, alpha_l, slope_l = ctx.streams
        pk, head = ctx.pk, ctx.head
        del ctx.streams
        cot = cot.contiguous()
        d = x.shape[1]
        packs = pk.packs
        dxs_l, tt_l, tsum = [], [], None
        for p, xs, alpha in zip(packs, xs_l, alpha_l):
            cot_e = gather_rows(cot, p.dst_idx).view(p.k_pad, d)
            dxs_l.append(alpha[:, None] * cot_e)
            tt = alpha * (xs * cot_e).sum(1)
            tt_l.append(tt)
            tsum = _add(tsum, _dst_sum(tt, p))
        g_l = [(tt - alpha * gather_scalars(tsum, p.dst_idx).view(-1)) * slope
               for p, tt, alpha, slope in zip(packs, tt_l, alpha_l, slope_l)]
        db = sum(g.sum() for g in g_l).reshape(1)
        dx = None
        if head == V.CONCAT:
            w_src, w_dst = khead[:d], khead[d:]
            gd = None
            for p, g in zip(packs, g_l):
                gd = _add(gd, _dst_sum(g, p))
            dw_src = None
            for p, xs, g, dxs in zip(packs, xs_l, g_l, dxs_l):
                dx = _add(dx, _src_scatter(dxs + g[:, None] * w_src, p))
                dw_src = _add(dw_src, (xs * g[:, None]).sum(0))
            dx = dx + gd[:, None] * w_dst
            dkhead = torch.cat([dw_src, (x * gd[:, None]).sum(0)])
        else:
            dkhead = None
            for p, xs, xd, g, dxs in zip(packs, xs_l, xd_l, g_l, dxs_l):
                dkhead = _add(dkhead, (xs * xd * g[:, None]).sum(0))
                part = (_src_scatter(dxs + khead * g[:, None] * xd, p)
                        + csr_gather_sum(xs, p.entry, p.dst_rowptr,
                                         g[:p.nnz].contiguous()) * khead)
                dx = _add(dx, part)
        return dx, dkhead, db, None, None


def routed_gat_conv(x: torch.Tensor, khead: torch.Tensor,
                    bhead: torch.Tensor, pk: AnyGatPack,
                    head: str = V.CONCAT) -> torch.Tensor:
    """``[N, d]`` routed attention conv of ``x [N, d]`` over the pack
    ``pk`` (see ``RoutedGatConvFn``)."""
    return RoutedGatConvFn.apply(x, khead, bhead, pk, head)
