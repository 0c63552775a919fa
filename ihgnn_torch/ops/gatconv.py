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
"""

from __future__ import annotations

import torch

from ihgnn_torch.config import V
from ihgnn_torch.graph import AttentionCSR
from ihgnn_torch.ops.edgedot import csr_edge_dot
from ihgnn_torch.ops.segmax import csr_segment_max, csr_segment_sum
from ihgnn_torch.ops.segsum import csr_gather_sum

LEAKY_SLOPE = 0.01     # torch nn.LeakyReLU default (models/common.py)
MASKED_SCORE = -1e30   # finite: an all-masked segment stays NaN-free


def _take(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``v[idx]`` of a scalar ``[*]`` stream."""
    return v.index_select(0, idx)


class GatConvFn(torch.autograd.Function):
    """``x [M, d]`` → ``[S, d]`` attention output over ``csr``; ``khead``
    is the score head's kernel (``[2d]`` concat: source half first;
    ``[d]`` product), ``bhead`` its ``[1]`` bias."""

    @staticmethod
    def forward(ctx, x, khead, bhead, csr: AttentionCSR, head: str):
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
        w = torch.exp(scores - _take(m, csr.dst))
        if csr.mask is not None:
            w = w * csr.mask
        den = csr_segment_sum(w, csr.dst_rowptr)
        alpha = w / torch.clamp(_take(den, csr.dst), min=1e-30)
        ctx.save_for_backward(x, khead, alpha, slope)
        ctx.csr, ctx.head = csr, head
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
        return dx, dkhead, g.sum().reshape(1), None, None


def gat_conv(x: torch.Tensor, khead: torch.Tensor, bhead: torch.Tensor,
             attention_csr: AttentionCSR, head: str = V.CONCAT
             ) -> torch.Tensor:
    """``[S, d]`` attention conv of ``x [M, d]`` over ``attention_csr``
    (see the module docstring); ``head`` is ``V.CONCAT`` or
    ``V.PRODUCT``."""
    return GatConvFn.apply(x, khead, bhead, attention_csr, head)
