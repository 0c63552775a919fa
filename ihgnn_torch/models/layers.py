"""IHGNN layer (without phase-2 attention).

Counterpart of ``ihgnn_tpu/models/layers.py`` ``IHGNNLayer``
(reference: Models/GnnLayers.py:221-236):

  X' = X·W;  E = FeatureInteractor(X'[u], X'[q], X'[i]);  out = Dv⁻¹ · H · E

Row-major: ``x`` is ``[N, in]`` and the result ``[N, out]``. The gather is
K2, the interaction K3 and the node update H·E K1 (``ops/hyperagg.py``),
each through its autograd Function, so the layer trains on the card.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ihgnn_torch.graph import HyperGraph
from ihgnn_torch.models.common import TorchDenseT
from ihgnn_torch.models.interaction import FeatureInteractor
from ihgnn_torch.ops.hyperagg import make_hyper_ops


class IHGNNLayer(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, interaction_order: int = 3,
                 phase2_attention: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if phase2_attention:
            raise NotImplementedError(
                "IHGNN phase-2 attention is not ported yet")
        self.feature_transform = TorchDenseT(in_dim, out_dim,
                                             generator=generator)
        self.interactor = FeatureInteractor(interaction_order, out_dim,
                                            out_dim, generator=generator)

    def forward(self, x: torch.Tensor, graph: HyperGraph) -> torch.Tensor:
        gather, scatter = make_hyper_ops(graph)
        edge = self.interactor(gather(self.feature_transform(x)))
        # node update: Dv^-1 · H · E (GnnLayers.py:232-234); zero-degree
        # nodes sum to 0 and 0 / 1e-8 stays 0
        return scatter(edge) / graph.dv
