"""RawGnn in plain PyTorch: what every configuration shares.

RawGnn (``Models/RawGnn.py``): X0 = [user rows | query bag means | item
rows] (row 0 of the user and item tables is padding, entity ``k`` at row
``k + 1``; a query is the mean of its word rows), then L layers over the
whole graph, then the HEM head over [X0 | X1 | ... | XL]:

    score(u, q, i) = <F_i, λ·F_q + (1 - λ)·F_u> + bias_i

Training takes the weighted mean of the sigmoid BCE over a batch's rows
and one Adam step (β 0.9 / 0.999, ε 1e-8, no weight decay). Ranking
scores every item of the catalog for a (user, query) pair and takes
HR/NDCG/MAP/MRR@10 (``Helpers/Metrics.py``: HR over min(|truth|, 10);
MAP's hit counter in truth order; MRR of the best-ranked hit).

Parameters are a dict of tensors under the names that ``leaves`` gives
(the program's own parameter names). The layer kind is a module of this
package with ``leaves``, ``build`` and ``forward``.
"""

from __future__ import annotations

import importlib
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.precision import F32, Precision

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
TOP_K = 10


def layer_module(gnn: str):
    return importlib.import_module(f"benchmark.reference.{gnn}")


def check_model(model: dict) -> None:
    """The parts of RawGnn this reference implements."""
    if model.get("query_transform", "mean") != "mean":
        raise NotImplementedError("query_transform other than mean")
    if model.get("use_cosine_similarity", False):
        raise NotImplementedError("the cosine HEM head")
    if model.get("phase2_attention", False):
        raise NotImplementedError("IHGNN phase-2 attention")


def leaves(model: dict, sizes: dict) -> List[Tuple[str, Tuple[int, ...],
                                                   str, float]]:
    """Every parameter as ``(name, shape, init, scale)``: ``init`` is
    ``uniform`` (U(±scale)) or ``normal`` (N(0, scale²)); the user and
    item tables keep row 0 at zero."""
    check_model(model)
    d = model["embedding_size"]
    out = []
    for name, rows in (("user_table", sizes["users"] + 1),
                       ("item_table", sizes["items"] + 1),
                       ("vocab_table", sizes["vocab"] + 1)):
        # xavier-uniform over (rows, d)
        out.append((f"embeddings.{name}", (rows, d), "uniform",
                    math.sqrt(6.0 / (rows + d))))
    layer = layer_module(model["gnn"])
    for k in range(model["gnn_layer_count"]):
        out.extend(layer.leaves(model, k, f"gnns.{k}."))
    out.append(("prediction.items_bias", (sizes["items"],), "normal", 1.0))
    return out


def node_ids(uqi: torch.Tensor, sizes: dict) -> torch.Tensor:
    """``[E, 3]`` (u, q, i) entity ids → global node ids (users, then
    queries, then items)."""
    off = torch.tensor([0, sizes["users"], sizes["users"] + sizes["queries"]],
                       device=uqi.device)
    return uqi.long() + off


def bag_means(vocab: torch.Tensor, words: torch.Tensor,
              counts: torch.Tensor) -> torch.Tensor:
    """``[Q, d]``: each query's word rows (table rows, 0 is padding)
    summed and divided by max(count, 1)."""
    rows = vocab[words.long()] * (words > 0).unsqueeze(-1)
    return rows.sum(1) / counts.clamp(min=1).unsqueeze(-1).float()


def features(P: Dict[str, torch.Tensor], model: dict, sizes: dict,
             words: torch.Tensor, counts: torch.Tensor, graph,
             prec: Precision = F32) -> torch.Tensor:
    """``[N, d·(1 + L)]`` = [X0 | X1 | ... | XL] of the whole graph."""
    users, items = sizes["users"], sizes["items"]
    x = torch.cat([P["embeddings.user_table"][1:users + 1],
                   bag_means(P["embeddings.vocab_table"], words, counts),
                   P["embeddings.item_table"][1:items + 1]])
    layer = layer_module(model["gnn"])
    outs = [x]
    for k in range(model["gnn_layer_count"]):
        x = layer.forward(P, f"gnns.{k}.", x, graph, model, k, prec)
        outs.append(x)
    return torch.cat(outs, dim=1)


def mix(feats: torch.Tensor, users: torch.Tensor, queries: torch.Tensor,
        sizes: dict, lam: float) -> torch.Tensor:
    """λ·F_q + (1 - λ)·F_u of each row's user and query."""
    return (lam * feats[queries.long() + sizes["users"]]
            + (1.0 - lam) * feats[users.long()])


def score_rows(P, feats, sizes: dict, lam: float, users, queries,
               items) -> torch.Tensor:
    start = sizes["users"] + sizes["queries"]
    m = mix(feats, users, queries, sizes, lam)
    return ((feats[items.long() + start] * m).sum(-1)
            + P["prediction.items_bias"][items.long()])


def bce(logits, labels, weight) -> torch.Tensor:
    per_row = F.binary_cross_entropy_with_logits(logits, labels,
                                                 reduction="none")
    return (per_row * weight).sum() / weight.sum().clamp(min=1.0)


@torch.no_grad()
def adam(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
         state: Dict[str, Tuple[torch.Tensor, torch.Tensor]], step: int,
         lr: float) -> None:
    """One Adam step (``step`` counts from 1) on every parameter in
    place."""
    b1, b2 = ADAM_BETAS
    for name, p in params.items():
        g = grads[name]
        m, v = state.setdefault(name, (torch.zeros_like(p),
                                       torch.zeros_like(p)))
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        denom = v.sqrt() / math.sqrt(1 - b2 ** step) + ADAM_EPS
        p.addcdiv_(m, denom, value=-lr / (1 - b1 ** step))


def train_steps(P0: Dict[str, torch.Tensor], model: dict, sizes: dict,
                lr: float, words, counts, graph, batches: Sequence[dict],
                prec: Precision = F32) -> dict:
    """Adam steps from ``P0`` over ``batches`` (dicts of ``users``,
    ``queries``, ``items``, ``flags``, ``weight`` tensors), each on a
    full-graph forward. Returns each step's loss, each parameter's
    gradient norm at the first step, and each parameter's change after
    the last step (norms, by name)."""
    params = {k: v.detach().clone() for k, v in P0.items()}
    state: dict = {}
    losses, grad_norms = [], None
    lam = model["lambda_muq"]
    for t, b in enumerate(batches, start=1):
        live = {k: v.requires_grad_(True) for k, v in params.items()}
        feats = features(live, model, sizes, words, counts, graph, prec)
        logits = score_rows(live, feats, sizes, lam, b["users"],
                            b["queries"], b["items"])
        loss = bce(logits, b["flags"], b["weight"])
        names = list(live)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [live[k] for k in names])))
        del feats, logits
        for v in params.values():
            v.requires_grad_(False)
        if grad_norms is None:
            grad_norms = {k: float(g.norm()) for k, g in grads.items()}
        losses.append(float(loss.detach()))
        adam(params, grads, state, t, lr)
        del grads, loss
    change = {k: float((params[k] - P0[k]).norm()) for k in params}
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}


@torch.no_grad()
def catalog_scores(P, feats, sizes: dict, lam: float, users, queries,
                   prec: Precision = F32) -> torch.Tensor:
    """``[B, I]`` scores of every item for each (user, query) pair."""
    start = sizes["users"] + sizes["queries"]
    m = mix(feats, users, queries, sizes, lam)
    return (prec.mm(m, feats[start:].t())
            + P["prediction.items_bias"][None, :])


@torch.no_grad()
def truth_scores(P, feats, sizes: dict, lam: float, users, queries,
                 truth) -> Tuple[torch.Tensor, torch.Tensor]:
    """``([B, T] scores, [B, T] feature terms)`` of each row's truth items
    (``-1`` pads read item 0), worked out in float64 from ``feats``."""
    start = sizes["users"] + sizes["queries"]
    t = truth.long().clamp(min=0)
    m = (lam * feats[queries.long() + sizes["users"]].double()
         + (1.0 - lam) * feats[users.long()].double())
    term = (feats[t + start].double() * m[:, None, :]).sum(-1)
    return term + P["prediction.items_bias"].double()[t], term


@torch.no_grad()
def truth_ranks(scores: torch.Tensor, truth: torch.Tensor,
                tie: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each truth item (``-1`` pads), the count of items that score
    strictly above it, and whether that count could change were every
    score moved by ``tie`` (an item within ``tie`` of the truth item's
    score, in the top ``TOP_K`` region)."""
    t = truth.long().clamp(min=0)
    s = scores.gather(1, t)                                   # [B, T]
    above = torch.empty_like(t)
    ambiguous = torch.empty_like(t, dtype=torch.bool)
    for j in range(t.shape[1]):
        col = s[:, j:j + 1]
        above[:, j] = (scores > col).sum(1)
        # the rank lies in [surely_above, maybe_above] under a move of tie
        surely_above = (scores > col + tie).sum(1)
        maybe_above = (scores > col - tie).sum(1) - 1
        ambiguous[:, j] = ((maybe_above > surely_above)
                           & (surely_above < TOP_K))
    return above, ambiguous & (truth >= 0)


def metric_rows(ranks: np.ndarray, truth: np.ndarray,
                counts: np.ndarray) -> np.ndarray:
    """``[B, 4]`` (HR, NDCG, MAP, MRR)@10 of each log from the ranks of
    its truth items (``Helpers/Metrics.py``), in float64."""
    out = np.zeros((len(counts), 4))
    for r in range(len(counts)):
        c = int(counts[r])
        if c == 0:
            continue
        cap = min(c, TOP_K)
        hits = [int(ranks[r, j]) for j in range(c)
                if truth[r, j] >= 0 and ranks[r, j] < TOP_K]
        if not hits:
            continue
        idcg = sum(1.0 / math.log2(k + 2) for k in range(cap))
        out[r, 0] = len(hits) / cap
        out[r, 1] = sum(1.0 / math.log2(p + 2) for p in hits) / idcg
        out[r, 2] = sum((n + 1) / (p + 1) for n, p in enumerate(hits)) \
            / len(hits)
        out[r, 3] = 1.0 / (min(hits) + 1)
    return out
