"""RawGnn: embeddings → L GNN layers (full graph) → concat → HEM head.

Counterpart of ``ihgnn_tpu/models/rawgnn.py`` ``RawGnn`` (reference:
Models/RawGnn.py). Serving computes ``all_features`` once and scores many
(user, query) batches against it (the ``save_features_for_test``
protocol, RawGnn.py:147-158).

Features are row-major ``[N, d·(1+L)]`` (the JAX package returns them
feature-major ``[d·(1+L), N]``). ``cfg.gnn`` picks the layer and the
graph it runs on: GCN and GAT the ``Graph2D``, HGCN the ``HyperGraph`` or
(``use_log_hypergraph``) the ``LogHyperGraph``, IHGNN the ``HyperGraph``.
IHGNN layers after the first run at interaction order 1
(RawGnn.py:76-78). ``cfg.bf16_stream`` runs the IHGNN layers on bf16 edge
streams (``models/layers.py``); ``cfg.remat`` recomputes each layer in the
backward (``torch.utils.checkpoint``), the counterpart of ``nn.checkpoint``
(``ihgnn_tpu/models/rawgnn.py:103-107``): a layer's activations are not
kept between the forward and the backward, and every kernel is
deterministic, so the gradients are those without remat, bit for bit.
The batch's rows are gathered by ``ops/rows.py`` ``take_rows``, whose
gradient adds repeated rows in a fixed order on either device.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ihgnn_torch.config import ModelConfig, V
from ihgnn_torch.graph import AnyGraph, Graph2D, HyperGraph, LogHyperGraph
from ihgnn_torch.models.embedding import EmbeddingTables, WordBag
from ihgnn_torch.models.layers import GATLayer, GCNLayer, HGCNLayer, IHGNNLayer
from ihgnn_torch.models.prediction import HemPredictionLayer
from ihgnn_torch.ops.rows import take_rows
from ihgnn_torch.utils.tracing import span


class RawGnn(nn.Module):
    """Built on the CPU from ``generator`` (seed 0 when None); move it with
    ``.to(device)``."""

    def __init__(self, cfg: ModelConfig, user_count: int, query_count: int,
                 item_count: int, vocab_size: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        self.user_count = user_count
        self.query_count = query_count
        self.item_count = item_count
        d = cfg.embedding_size
        self.embeddings = EmbeddingTables(
            user_count, item_count, vocab_size, d,
            query_transform=cfg.query_transform, generator=generator)
        self.gnns = nn.ModuleList([self._layer(cfg, layer, generator)
                                   for layer in range(cfg.gnn_layer_count)])
        self._layer_spans = tuple(f"features.layer{k}"
                                  for k in range(cfg.gnn_layer_count))
        self.prediction = HemPredictionLayer(
            item_count, lambda_muq=cfg.lambda_muq,
            use_cosine_similarity=cfg.use_cosine_similarity,
            generator=generator)

    @staticmethod
    def _layer(cfg: ModelConfig, layer: int,
               generator: torch.Generator) -> nn.Module:
        d = cfg.embedding_size
        if cfg.gnn == V.GCN:
            return GCNLayer(d, d, generator=generator)
        if cfg.gnn == V.GAT:
            return GATLayer(d, d, head=cfg.gat_head, generator=generator)
        if cfg.gnn == V.HGCN:
            return HGCNLayer(d, d, generator=generator)
        if cfg.gnn == V.IHGNN:
            return IHGNNLayer(d, d, interaction_order=cfg.layer_order(layer),
                              phase2_attention=cfg.phase2_attention,
                              gat_head=cfg.gat_head,
                              bf16_stream=cfg.bf16_stream,
                              generator=generator)
        raise ValueError(f"unknown gnn layer {cfg.gnn!r}")

    def _check_graph(self, graph: AnyGraph) -> None:
        """The layers of ``cfg.gnn`` read one graph type (``cli.py``
        ``pick_graph`` in the JAX package)."""
        gnn = self.cfg.gnn
        want = {V.GCN: Graph2D, V.GAT: Graph2D, V.IHGNN: HyperGraph,
                V.HGCN: LogHyperGraph if self.cfg.use_log_hypergraph
                else HyperGraph}[gnn]
        if not isinstance(graph, want):
            raise TypeError(f"gnn {gnn!r} runs on a {want.__name__}, got a "
                            f"{type(graph).__name__}")

    @property
    def table_rows(self) -> dict:
        """The embedding tables' logical rows (a rank's blocks hold
        fewer), as ``convert.params_from_jax`` takes them."""
        return {name: self.embeddings.rows[f"{name}_table"]
                for name in ("user", "item", "vocab")}

    @property
    def query_start(self) -> int:
        return self.user_count

    @property
    def item_start(self) -> int:
        return self.user_count + self.query_count

    def all_features(self, graph: AnyGraph, bag: WordBag) -> torch.Tensor:
        """Full-graph forward: ``[N, d·(1+L)]`` = [X0 | X1 | ... | XL].
        With ``cfg.remat`` and grad mode on, each layer runs under
        ``checkpoint`` and runs again in the backward."""
        self._check_graph(graph)
        with span("features.embed"):
            x = self.embeddings.all_features(bag)
        outs = [x]
        remat = self.cfg.remat and torch.is_grad_enabled()
        for gnn, name in zip(self.gnns, self._layer_spans):
            with span(name):
                if remat:
                    x = checkpoint(gnn, x, graph, use_reentrant=False)
                else:
                    x = gnn(x, graph)
            outs.append(x)
        with span("features.concat"):
            return torch.cat(outs, dim=1)

    def score(self, features: torch.Tensor, users: torch.Tensor,
              queries: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
        """``[R]`` scores of (user, query, item) triples (0-based ids)."""
        users, queries, items = users.long(), queries.long(), items.long()
        return self.prediction.score_rows(
            take_rows(features, users),
            take_rows(features, queries + self.query_start),
            take_rows(features, items + self.item_start), items)

    def tail_restricted(self, graph: AnyGraph) -> bool:
        """Whether ``score_tail`` applies: IHGNN layers (no phase 2) on a
        rank's slice of the hypergraph (``_tail_restricted_ok``,
        ``ihgnn_tpu/models/rawgnn.py:128-140``)."""
        return (isinstance(graph, HyperGraph) and graph.mesh is not None
                and self.cfg.gnn == V.IHGNN
                and not self.cfg.phase2_attention and len(self.gnns) >= 1)

    def score_tail(self, graph: HyperGraph, bag, users: torch.Tensor,
                   queries: torch.Tensor, items: torch.Tensor,
                   rows: slice) -> torch.Tensor:
        """The scores of batch rows ``rows`` on a rank's slice, where
        ``users``, ``queries``, ``items`` are the whole batch's (the same on
        every rank): the last layer's node partial is combined at the
        batch's ``3R`` node rows only (the tail psum,
        ``_score_tail_restricted``, ``rawgnn.py:142-169``); every earlier
        layer is combined whole, as the next one reads every node."""
        self._check_graph(graph)
        users, queries, items = users.long(), queries.long(), items.long()
        r = users.shape[0]
        nodes = torch.cat([users, queries + self.query_start,
                           items + self.item_start])
        mine = torch.arange(rows.start, rows.stop, device=nodes.device)
        pick = torch.cat([mine, mine + r, mine + 2 * r])
        with span("features.embed"):
            x = self.embeddings.all_features(bag)
            cols = [take_rows(x, nodes[pick])]
        remat = self.cfg.remat and torch.is_grad_enabled()
        last = len(self.gnns) - 1
        for k, gnn in enumerate(self.gnns):
            with span(self._layer_spans[k]):
                args = (x, graph, nodes) if k == last else (x, graph)
                out = (checkpoint(gnn, *args, use_reentrant=False) if remat
                       else gnn(*args))
                if k == last:
                    cols.append(take_rows(out, pick))
                else:
                    x = out
                    cols.append(take_rows(x, nodes[pick]))
        with span("features.concat"):
            feats = torch.cat(cols, dim=1)
        n = len(mine)
        return self.prediction.score_rows(feats[:n], feats[n:2 * n],
                                          feats[2 * n:], items[rows])

    def score_all_items(self, features: torch.Tensor, users: torch.Tensor,
                        queries: torch.Tensor) -> torch.Tensor:
        """``[B]`` (user, query) pairs → ``[B, item_count]`` scores."""
        users, queries = users.long(), queries.long()
        return self.prediction.score_all(
            features[users], features[queries + self.query_start],
            features[self.item_start:])

    def forward(self, graph: AnyGraph, bag: WordBag, users: torch.Tensor,
                queries: torch.Tensor,
                items: Optional[torch.Tensor] = None) -> torch.Tensor:
        feats = self.all_features(graph, bag)
        if items is None:
            return self.score_all_items(feats, users, queries)
        return self.score(feats, users, queries, items)
