"""The IHGNN layer in plain PyTorch (``Models/GnnLayers.py`` IHGNN,
``Models/CommonLayers.py`` FeatureInteractor).

    X' = X·Wᵀ + b
    E_e = Linear(parts(X'_u, X'_q, X'_i))       for each edge e = (u, q, i)
    out_n = (Σ_{e ∋ n} E_e) / deg(n)

with parts [u, q, i] (order 1), + [u⊙q, q⊙i, i⊙u] (order 2), + [u⊙q⊙i]
(order 3). Layers after the first run at order 1 (``Models/RawGnn.py``).
A node of degree 0 sums nothing and its row is 0.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.precision import F32, Precision
from benchmark.reference.rawgnn import node_ids

PARTS = {1: 3, 2: 6, 3: 7}


def order(model: dict, layer: int) -> int:
    o = model["feature_interaction_order"]
    return 1 if (o > 1 and layer > 0) else o


def leaves(model: dict, layer: int, prefix: str):
    d = model["embedding_size"]
    p = PARTS[order(model, layer)]
    b1, bp = 1.0 / math.sqrt(d), 1.0 / math.sqrt(p * d)
    return [(prefix + "feature_transform.weight", (d, d), "uniform", b1),
            (prefix + "feature_transform.bias", (d,), "uniform", b1),
            (prefix + "interactor.aggregation.weight", (d, p * d), "uniform",
             bp),
            (prefix + "interactor.aggregation.bias", (d,), "uniform", bp)]


def build(uqi: torch.Tensor, sizes: dict) -> dict:
    """The incidence: each edge's three node ids, and each node's
    degree."""
    n = sizes["users"] + sizes["queries"] + sizes["items"]
    ids = node_ids(uqi, sizes)
    deg = torch.bincount(ids.reshape(-1), minlength=n).float()
    return {"ids": ids, "deg": deg.clamp(min=1.0).unsqueeze(1),
            "nodes": n}


def forward(P, prefix: str, x: torch.Tensor, graph: dict, model: dict,
            layer: int, prec: Precision = F32) -> torch.Tensor:
    x = prec.linear(x, P[prefix + "feature_transform.weight"],
                    P[prefix + "feature_transform.bias"])
    ids = graph["ids"]
    u, q, i = x[ids[:, 0]], x[ids[:, 1]], x[ids[:, 2]]
    parts = [u, q, i]
    o = order(model, layer)
    if o >= 2:
        parts += [u * q, q * i, i * u]
    if o >= 3:
        parts.append(u * q * i)
    edge = prec.linear(torch.cat(parts, dim=1),
                       P[prefix + "interactor.aggregation.weight"],
                       P[prefix + "interactor.aggregation.bias"])
    out = torch.zeros(graph["nodes"], edge.shape[1], device=x.device)
    for role in range(3):
        out = out.index_add(0, ids[:, role], edge)
    return out / graph["deg"]
