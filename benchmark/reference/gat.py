"""The GAT layer in plain PyTorch (``Models/GnnLayers.py`` GAT with the
concatenation head, ``Helpers/Graph.py`` for the 2D graph).

The 2D graph of the ``uqi`` mode joins u–q, q–i and i–u of every
interaction, both ways, each pair once. For each pair ``s → t``:

    X' = X·Wᵀ + b
    a_st = LeakyReLU(<k, [X'_s ; X'_t]> + c)      (slope 0.01)
    α_st = softmax of a over the pairs into t
    out_t = Σ_s α_st · X'_s

A node that no pair enters has the row 0.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference.precision import F32, Precision
from benchmark.reference.rawgnn import node_ids

LEAKY_SLOPE = 0.01


def leaves(model: dict, layer: int, prefix: str):
    if model.get("gat_head", "concatenation") != "concatenation":
        raise NotImplementedError("the product head")
    d = model["embedding_size"]
    gain = math.sqrt(2.0 / (1.0 + LEAKY_SLOPE ** 2))
    b1 = 1.0 / math.sqrt(d)
    return [(prefix + "feature_transform.weight", (d, d), "uniform", b1),
            (prefix + "feature_transform.bias", (d,), "uniform", b1),
            # xavier-uniform with the LeakyReLU gain over (1, 2d)
            (prefix + "gat.feature_aggregate.weight", (1, 2 * d), "uniform",
             gain * math.sqrt(6.0 / (1 + 2 * d))),
            (prefix + "gat.feature_aggregate.bias", (1,), "uniform",
             1.0 / math.sqrt(2 * d))]


def build(uqi: torch.Tensor, sizes: dict) -> dict:
    """The distinct pairs ``s → t`` of the ``uqi`` 2D graph."""
    n = sizes["users"] + sizes["queries"] + sizes["items"]
    ids = node_ids(uqi, sizes)
    u, q, i = ids[:, 0], ids[:, 1], ids[:, 2]
    src = torch.cat([u, q, i, q, i, u])
    dst = torch.cat([q, i, u, u, q, i])
    keys = torch.unique(src * n + dst)
    return {"src": keys // n, "dst": keys % n, "nodes": n}


def forward(P, prefix: str, x: torch.Tensor, graph: dict, model: dict,
            layer: int, prec: Precision = F32) -> torch.Tensor:
    x = prec.linear(x, P[prefix + "feature_transform.weight"],
                    P[prefix + "feature_transform.bias"])
    d = x.shape[1]
    k = P[prefix + "gat.feature_aggregate.weight"].reshape(2 * d, 1)
    c = P[prefix + "gat.feature_aggregate.bias"]
    src, dst, n = graph["src"], graph["dst"], graph["nodes"]
    a_src = prec.mm(x, k[:d]).squeeze(1)
    a_dst = prec.mm(x, k[d:]).squeeze(1)
    a = F.leaky_relu(a_src[src] + a_dst[dst] + c, LEAKY_SLOPE)
    # the softmax's stabiliser cancels from α, so it carries no gradient
    top = torch.full((n,), -torch.inf, device=x.device).scatter_reduce(
        0, dst, a.detach(), "amax")
    w = torch.exp(a - top[dst])
    den = torch.zeros(n, device=x.device).index_add(0, dst, w)
    alpha = w / den[dst]
    return torch.zeros(n, d, device=x.device).index_add(
        0, dst, alpha.unsqueeze(1) * x[src])
