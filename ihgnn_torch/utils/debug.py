"""Debug statistics, the reference's Gs.Debug surface
(Helpers/GlobalSettings.py:98-108; hooks at Models/EmbeddingLayers.py:56-61
and Models/RawGnn.py:119-121): the embedding tables' and each GNN layer's
output scale.

Counterpart of ``ihgnn_tpu/utils/debug.py`` ``embedding_info`` and
``feature_stats_from``, on the port's ``RawGnn`` and its row-major
features.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ihgnn_torch.models.rawgnn import RawGnn


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def embedding_info(model: RawGnn) -> Tuple[float, float, float]:
    """(user, vocab, item) table abs-mean (EmbeddingLayers.py:56-61); on
    a mesh with a model axis, of the full tables (every rank calls it)."""
    with torch.no_grad():
        users, items, vocab = model.embeddings.tables()
    return tuple(float(np.abs(_numpy(t)).mean()) for t in
                 (users, vocab, items))


def feature_stats_from(feats, embedding_size: int, layer_count: int
                       ) -> List[Dict[str, float]]:
    """Abs-mean and std of each layer's block of the full-graph features
    ``[N, d·(1+L)]`` (``features_fn()``'s output; block 0 is X0)."""
    feats = _numpy(feats)
    d = embedding_size
    out = []
    for layer in range(layer_count + 1):
        block = feats[:, layer * d:(layer + 1) * d]
        out.append({"layer": layer,
                    "absmean": float(np.abs(block).mean()),
                    "std": float(block.std())})
    return out
