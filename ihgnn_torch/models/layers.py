"""GNN layers: GCN, GAT, HGCN and IHGNN (with optional phase-2 attention).

Counterpart of ``ihgnn_tpu/models/layers.py`` (reference:
Models/GnnLayers.py). Row-major: ``x`` is ``[N, in]`` and the result
``[N, out]``. Every sparse aggregation is a kernel behind an autograd
Function (``ops/hyperagg.py``, ``ops/gatconv.py``), so each layer trains
on the card.

* ``GCNLayer``   — Dv^-1/2 · A · Dv^-1/2 · X · W over the 2D graph, the
  transform first when in_dim >= out_dim (GnnLayers.py:28-45).
* ``GATLayer``   — X' = X·W, then the attention conv over the 2D graph's
  destination-sorted entries (GnnLayers.py:96-115).
* ``HGCNLayer``  — Dv^-1/2 · H · De^-1 · Hᵀ · Dv^-1/2 · X · W over the
  hypergraph (De = 3: the mean of the three roles) or the log hypergraph
  (GnnLayers.py:142-153).
* ``IHGNNLayer`` — X' = X·W; E = FeatureInteractor(X'[u], X'[q], X'[i]);
  out = Dv⁻¹ · H · E, or with phase-2 attention a GAT over the bipartite
  graph edge node → member node on ``[X' | E]`` (GnnLayers.py:200-236).

On a 2D graph built with ``pack_kernels`` GCN takes the routed SpMM
(``RoutedSpmmFn``) and GAT the routed attention (``RoutedGatConvFn``,
``ihgnn_tpu/models/layers.py:134-148``), with the same parameters. On a
hypergraph with a routed pack (``graph.kp``, chunked or not) HGCN and
IHGNN take the routed path (``ops/hyperagg.py``): the edge rows are in σ order, and
IHGNN without phase 2 absorbs the i role's last stage into its
interaction (``ihgnn_tpu/models/layers.py:215-238``) wherever the pack's
tables stack (``kp.absorbs``: a single pack, or chunks of one grid width;
the TPU's table and block gates of ``absorb_i_ok`` do not apply here). Phase 2 puts the edge
rows back in edge order before the attention (``:254-262``).

``IHGNNLayer(bf16_stream=True)`` (``ModelConfig.bf16_stream``) runs either
path on bf16 edge streams (``ops/hyperagg.py``): bf16 role rows, a bf16
interaction output (on a routed pack K5's bf16 form, both outputs), f32
node sums; phase 2 widens the bf16 edge rows to f32 before the
``[x' | edge]`` concat (``layers.py:264``), on a routed pack after putting
them back in edge order. The parameters, the feature transforms and the
node rows stay f32.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch
from torch import nn

from ihgnn_torch.config import V
from ihgnn_torch.graph import AttentionCSR, Graph2D, HyperGraph, LogHyperGraph
from ihgnn_torch.models.common import TorchDense, TorchDenseT
from ihgnn_torch.models.initializers import xavier_uniform_
from ihgnn_torch.models.interaction import FeatureInteractor
from ihgnn_torch.ops.gatconv import LEAKY_SLOPE, gat_conv, routed_gat_conv
from ihgnn_torch.ops.hyperagg import (make_hyper_ops, make_log_ops,
                                      make_spmm_op, sigma_to_edge_order)
from ihgnn_torch.parallel.collectives import combine_rows

# torch.nn.init.calculate_gain('leaky_relu') at the default slope
LEAKY_RELU_GAIN = math.sqrt(2.0 / (1.0 + LEAKY_SLOPE ** 2))


def _masked(edge: torch.Tensor, graph: HyperGraph) -> torch.Tensor:
    """``edge`` with the rows of a mesh's pad edges zeroed (``edge_mask``,
    ``ihgnn_tpu/models/layers.py:181-182``, ``:239-240``)."""
    if graph.edge_mask is None:
        return edge
    return edge * graph.edge_mask.to(edge.dtype)


class GCNLayer(nn.Module):
    def __init__(self, in_dim: int, out_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_dim, self.out_dim = in_dim, out_dim
        self.feature_transform = TorchDenseT(in_dim, out_dim,
                                             generator=generator)

    def forward(self, x: torch.Tensor, graph: Graph2D) -> torch.Tensor:
        d_inv_sqrt = graph.dv ** -0.5
        adj = make_spmm_op(graph)

        def conv(h):
            return d_inv_sqrt * adj(d_inv_sqrt * h)

        # cheaper side first (GnnLayers.py:33-43)
        if self.in_dim >= self.out_dim:
            return conv(self.feature_transform(x))
        return self.feature_transform(conv(x))


class GatCore(nn.Module):
    """Attention scoring and destination-softmax aggregation over an
    ``AttentionCSR`` (``_GatCore``): the score head ``feature_aggregate``
    is a Linear over ``[x_src ; x_dst]`` (concat head, ``[2d] → 1``) or
    ``x_src ⊙ x_dst`` (product head, ``[d] → 1``), xavier-uniform with the
    LeakyReLU gain (GnnLayers.py:66-70)."""

    def __init__(self, out_dim: int, head: str = V.CONCAT,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if head not in (V.CONCAT, V.PRODUCT):
            raise ValueError(f"unknown GAT head {head!r}")
        self.head = head
        score_in = 2 * out_dim if head == V.CONCAT else out_dim
        self.feature_aggregate = nn.Linear(score_in, 1)
        with torch.no_grad():
            xavier_uniform_(self.feature_aggregate.weight, LEAKY_RELU_GAIN,
                            generator=generator)
            bound = 1.0 / math.sqrt(score_in)
            self.feature_aggregate.bias.uniform_(-bound, bound,
                                                 generator=generator)

    def forward(self, x: torch.Tensor, csr: AttentionCSR,
                pack=None, mesh=None) -> torch.Tensor:
        """The conv over ``csr``, or over the routed GAT pack ``pack``
        when given (the same function). With ``mesh``, ``csr`` is a
        rank's entries and the rank's partial is summed over the mesh in
        f32 (``ops/gatconv.py``); a rank's slice carries no routed pack."""
        agg = self.feature_aggregate
        if pack is not None:
            return routed_gat_conv(x, agg.weight[0], agg.bias, pack,
                                   self.head)
        return gat_conv(x, agg.weight[0], agg.bias, csr, self.head, mesh)


class GATLayer(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, head: str = V.CONCAT,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.feature_transform = TorchDense(in_dim, out_dim,
                                            generator=generator)
        self.gat = GatCore(out_dim, head, generator=generator)

    def forward(self, x: torch.Tensor, graph: Graph2D) -> torch.Tensor:
        return self.gat(self.feature_transform(x), graph.attention,
                        graph.gat_pk, graph.mesh)


class HGCNLayer(nn.Module):
    def __init__(self, in_dim: int, out_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.feature_transform = TorchDenseT(in_dim, out_dim,
                                             generator=generator)

    def forward(self, x: torch.Tensor,
                graph: Union[HyperGraph, LogHyperGraph]) -> torch.Tensor:
        d_inv_sqrt = graph.dv ** -0.5
        x = d_inv_sqrt * self.feature_transform(x)
        if isinstance(graph, HyperGraph):
            gather, scatter = make_hyper_ops(graph)
            edge = _masked(gather(x).sum(0) / 3.0, graph)
            return d_inv_sqrt * scatter(edge)
        edge_sum, node_sum = make_log_ops(graph)
        return d_inv_sqrt * node_sum(edge_sum(x) / graph.de)


class IHGNNLayer(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, interaction_order: int = 3,
                 phase2_attention: bool = False, gat_head: str = V.CONCAT,
                 bf16_stream: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.phase2_attention = phase2_attention
        self.bf16_stream = bf16_stream
        self.feature_transform = TorchDenseT(in_dim, out_dim,
                                             generator=generator)
        self.interactor = FeatureInteractor(interaction_order, out_dim,
                                            out_dim, generator=generator)
        if phase2_attention:
            self.phase2_transform = TorchDense(out_dim, out_dim,
                                               generator=generator)
            self.phase2_gat = GatCore(out_dim, gat_head, generator=generator)

    def forward(self, x: torch.Tensor, graph: HyperGraph,
                out_nodes: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``[N, out]``; on a rank's slice with ``out_nodes`` ``[K]`` (no
        phase 2), the ``[K, out]`` rows ``out_nodes`` only, their node
        partials summed over the mesh as ``[K, out]`` rows (the tail
        psum, ``ihgnn_tpu/models/layers.py:204-250``)."""
        kp = graph.kp
        absorb = kp is not None and not self.phase2_attention and kp.absorbs
        tail = out_nodes is not None and graph.mesh is not None
        gather, scatter = make_hyper_ops(graph, bf16_stream=self.bf16_stream,
                                         absorb=absorb, combine=not tail)
        x = self.feature_transform(x)
        edge = self.interactor(gather(x), absorb=kp if absorb else None)
        if not absorb:
            edge = _masked(edge, graph)
        if tail:
            nodes = out_nodes.long()
            return (combine_rows(scatter(edge), nodes, graph.mesh)
                    / graph.dv[nodes])
        if self.phase2_attention:
            if kp is not None:
                edge = sigma_to_edge_order(edge, kp)
            # GAT from edge node N + e to its member nodes over
            # [x' | edge] (bf16 edge rows widened), keeping the node rows;
            # no / dv. On a rank's slice: its own edge rows, and its
            # partial summed over the mesh in f32 whatever the wire
            both = self.phase2_transform(torch.cat([x, edge.float()], dim=0))
            return self.phase2_gat(both, graph.phase2, mesh=graph.mesh)
        # node update: Dv^-1 · H · E (GnnLayers.py:232-234); zero-degree
        # nodes sum to 0 and 0 / 1e-8 stays 0
        return scatter(edge) / graph.dv
