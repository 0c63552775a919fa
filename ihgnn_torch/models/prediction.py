"""HEM-style prediction head (reference: Models/PredictionLayers.py:6-44).

Counterpart of ``ihgnn_tpu/models/prediction.py`` ``HemPredictionLayer``:

  score(u, q, i) = <i_feat, m_uq> + bias_i,   m_uq = λ·q + (1-λ)·u

or the cosine similarity in place of the dot product. ``score_rows``
scores (u, q, i) triples; ``score_all`` scores B (u, q) pairs against the
whole catalog with one ``[B, F] × [F, I]`` matmul.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ihgnn_torch.ops.rows import take_rows

COSINE_EPS = 1e-8


class HemPredictionLayer(nn.Module):
    def __init__(self, item_count: int, lambda_muq: float = 0.5,
                 use_cosine_similarity: bool = False,
                 zero_bias_init: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lambda_muq = lambda_muq
        self.use_cosine_similarity = use_cosine_similarity
        bias = torch.zeros(item_count)
        if not zero_bias_init:
            # torch init.normal_ defaults, N(0, 1) (PredictionLayers.py:17-18)
            bias.normal_(generator=generator)
        self.items_bias = nn.Parameter(bias)

    def _m_uq(self, user_feature: Optional[torch.Tensor],
              query_feature: torch.Tensor) -> torch.Tensor:
        if user_feature is None:
            return query_feature
        lam = self.lambda_muq
        return lam * query_feature + (1.0 - lam) * user_feature

    def score_rows(self, user_feature: Optional[torch.Tensor],
                   query_feature: torch.Tensor, item_feature: torch.Tensor,
                   item_indices: torch.Tensor) -> torch.Tensor:
        """``[R, F]`` rows of (u, q, i) → ``[R]`` scores."""
        m = self._m_uq(user_feature, query_feature)
        bias = take_rows(self.items_bias, item_indices)
        if self.use_cosine_similarity:
            num = (item_feature * m).sum(-1)
            den = torch.clamp(item_feature.norm(dim=-1) * m.norm(dim=-1),
                              min=COSINE_EPS)
            return num / den + bias
        return (item_feature * m).sum(-1) + bias

    def score_all(self, user_feature: Optional[torch.Tensor],
                  query_feature: torch.Tensor,
                  all_item_features: torch.Tensor) -> torch.Tensor:
        """``[B, F]`` pairs × ``[I, F]`` catalog → ``[B, I]`` scores."""
        m = self._m_uq(user_feature, query_feature)
        items = all_item_features
        if self.use_cosine_similarity:
            m = m / torch.clamp(m.norm(dim=-1, keepdim=True), min=COSINE_EPS)
            items = items / torch.clamp(items.norm(dim=-1, keepdim=True),
                                        min=COSINE_EPS)
        return torch.matmul(m, items.t()) + self.items_bias[None, :]
