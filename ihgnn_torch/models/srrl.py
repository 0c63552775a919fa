"""Srrl: the knowledge-graph-embedding baseline with alternating KG/PS
training.

Counterpart of ``ihgnn_tpu/models/srrl.py`` (the reference's
Models/Srrl.py). Two embedding spaces:

* ``KG`` — user and item tables and the query word-bag (vocab) table,
  trained by translation-style triple scores over a "company" context
  (``trainkg``);
* ``PS`` — user and item tables only, fused with the detached KG
  embeddings for personalized-search scoring (``forward``).

Init (Srrl.py:236-252): the tables are xavier-uniform, then L2-normalised
by row (row 0 zero in the user and item tables); every Linear kernel is
xavier-normal; every bias is zero, the HEM item bias included.

The reference's Main.py:176-181 builds Srrl with
``prediction_layer_type=None``, the 3-MLP scorer (Srrl.py:65-67, 154-158);
``prediction='hem'`` takes the HEM head instead. No kernel of the port
runs here: the layers are dense products, the gathers indexing.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ihgnn_torch.config import ModelConfig
from ihgnn_torch.models.common import leaky_relu
from ihgnn_torch.models.initializers import xavier_uniform_
from ihgnn_torch.models.prediction import HemPredictionLayer

MODE_TAIL = "tail-company-batch"
MODE_HEAD = "head-company-batch"
MODE_QUERY = "query-company-batch"
KG_MODES = (MODE_TAIL, MODE_HEAD, MODE_QUERY)


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """``x`` over its last axis's L2 norm, clamped at ``eps``
    (``F.normalize`` semantics)."""
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=eps)


@torch.no_grad()
def _normalized_table(rows: int, d: int, zero_row0: bool,
                      generator: Optional[torch.Generator]) -> nn.Parameter:
    """Xavier-uniform, then L2-normalised by row (Srrl.py:236-237); the
    padding row 0 stays zero in the user and item tables."""
    w = _l2_normalize(xavier_uniform_(torch.empty(rows, d),
                                      generator=generator))
    if zero_row0:
        w[0] = 0.0
    return nn.Parameter(w)


class SrrlDense(nn.Linear):
    """``nn.Linear`` with Srrl's init: xavier-normal weight, zero bias."""

    def __init__(self, in_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_features, out_features)
        std = math.sqrt(2.0 / (in_features + out_features))
        with torch.no_grad():
            self.weight.normal_(0.0, std, generator=generator)
            self.bias.zero_()


class SrrlMLP(nn.Module):
    """Linear(in, in) → LeakyReLU → Linear(in, out), Srrl's init."""

    def __init__(self, in_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc1 = SrrlDense(in_features, in_features, generator)
        self.fc2 = SrrlDense(in_features, out_features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(leaky_relu(self.fc1(x)))


class SrrlAggregation(nn.Module):
    """Linear(in, out) → LeakyReLU, Srrl's init."""

    def __init__(self, in_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc = SrrlDense(in_features, out_features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu(self.fc(x))


class SrrlEmbeddings(nn.Module):
    """One embedding space; ``with_vocab=False`` drops the query table
    (the PS space, Srrl.py:38-42). Entity ``i`` lives at row ``i + 1``."""

    def __init__(self, user_count: int, item_count: int, vocab_size: int,
                 embedding_size: int, with_vocab: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d = embedding_size
        self.user_count = user_count
        self.item_count = item_count
        self.user_table = _normalized_table(user_count + 1, d, True,
                                            generator)
        self.item_table = _normalized_table(item_count + 1, d, True,
                                            generator)
        if with_vocab:
            self.vocab_table = _normalized_table(vocab_size + 1, d, False,
                                                 generator)

    def embed_user(self, idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        if idx is None:
            return self.user_table[1:self.user_count + 1]
        return self.user_table[idx.long() + 1]

    def embed_item(self, idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        if idx is None:
            return self.item_table[1:self.item_count + 1]
        return self.item_table[idx.long() + 1]

    def embed_query(self, query_words: torch.Tensor,
                    query_word_counts: torch.Tensor,
                    idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``[Q, d]`` masked word sums over max(count, 1) (rows ``idx`` of
        them when given); ``query_words`` holds word rows, 0 for padding."""
        gathered = self.vocab_table[query_words.long()]          # [Q, L, d]
        mask = (query_words > 0).to(gathered.dtype)
        summed = torch.einsum("qld,ql->qd", gathered, mask)
        out = summed / torch.clamp(query_word_counts, min=1).to(
            gathered.dtype)[:, None]
        if idx is not None:
            out = out[idx.long()]
        return out


class Srrl(nn.Module):
    """The whole model, every submodule created here."""

    def __init__(self, cfg: ModelConfig, user_count: int, query_count: int,
                 item_count: int, vocab_size: int, prediction: str = "mlp",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if prediction not in ("mlp", "hem"):
            raise ValueError(f"unknown Srrl prediction {prediction!r}")
        self.cfg = cfg
        self.user_count = user_count
        self.query_count = query_count
        self.item_count = item_count
        self.prediction = prediction
        d = cfg.embedding_size
        kw = dict(user_count=user_count, item_count=item_count,
                  vocab_size=vocab_size, embedding_size=d,
                  generator=generator)
        self.KG = SrrlEmbeddings(with_vocab=True, **kw)
        self.PS = SrrlEmbeddings(with_vocab=False, **kw)
        self.kg_aggre_head = SrrlAggregation(2 * d, d, generator)
        self.kg_aggre_query = SrrlAggregation(2 * d, d, generator)
        self.kg_aggre_tail = SrrlAggregation(2 * d, d, generator)
        self.kg_mlp_pre = SrrlMLP(2 * d, d, generator)
        if cfg.srrl_kg_loss:
            # without the KG loss the PS latents are the PS tables alone,
            # and the JAX package creates no fusion parameters
            self.g_u = SrrlAggregation(2 * d, d, generator)
            self.g_i = SrrlAggregation(2 * d, d, generator)
        if prediction == "hem":
            # Srrl's init zeroes every parameter named '*bias*'
            # (Srrl.py:249-250), the item bias included
            self.prediction_layer = HemPredictionLayer(
                item_count, lambda_muq=cfg.lambda_muq, zero_bias_init=True)
        else:
            self.ps_mlp_uq = SrrlMLP(2 * d, d, generator)
            self.ps_mlp_ui = SrrlMLP(2 * d, d, generator)
            self.ps_mlp_pred = SrrlMLP(2 * d, 1, generator)

    # ---- KG phase (Srrl.py:72-98, 176-234) ----

    def trainkg(self, triples: torch.Tensor, neg_items: Optional[torch.Tensor],
                company: torch.Tensor, mode: str, query_words: torch.Tensor,
                query_word_counts: torch.Tensor) -> torch.Tensor:
        """Triple scores with company context: ``[B, 1]`` for the
        positives (``neg_items`` None), ``[B, k]`` for ``[B, k]`` negative
        items. ``triples`` is ``[B, 3]`` (u, q, i); ``company`` ``[B]``
        holds an item, a user or a query id by ``mode``. With negatives in
        the tail mode the company is the positive item (Srrl.py:187)."""
        u = self.KG.embed_user(triples[:, 0])[:, None, :]          # [B,1,d]
        q = self.KG.embed_query(query_words, query_word_counts,
                                triples[:, 1])[:, None, :]

        if mode == MODE_TAIL:
            if neg_items is None:
                items = self.KG.embed_item(triples[:, 2])[:, None, :]
                company_emb = self.KG.embed_item(company)[:, None, :]
            else:
                items = self.KG.embed_item(neg_items)              # [B,k,d]
                company_emb = self.KG.embed_item(
                    triples[:, 2])[:, None, :].expand(items.shape)
            items_cat = self.kg_aggre_tail(_l2_normalize(
                torch.cat([items, company_emb], -1)))
            ctx = self.kg_mlp_pre(_l2_normalize(torch.cat([u, q], -1)))
            return (items_cat * ctx).sum(2)

        if mode not in (MODE_HEAD, MODE_QUERY):
            raise ValueError(f"unknown KG mode {mode!r}")
        items = (self.KG.embed_item(triples[:, 2])[:, None, :]
                 if neg_items is None else self.KG.embed_item(neg_items))
        if mode == MODE_HEAD:
            u2 = self.KG.embed_user(company)[:, None, :]
            users = self.kg_aggre_head(_l2_normalize(torch.cat([u, u2], -1)))
            ctx = self.kg_mlp_pre(_l2_normalize(torch.cat([users, q], -1)))
        else:
            q2 = self.KG.embed_query(query_words, query_word_counts,
                                     company)[:, None, :]
            queries = self.kg_aggre_query(_l2_normalize(
                torch.cat([q, q2], -1)))
            ctx = self.kg_mlp_pre(_l2_normalize(torch.cat([u, queries], -1)))
        return (items * ctx).sum(2)

    # ---- PS phase (Srrl.py:101-159) ----

    @staticmethod
    def _fuse(ps_emb: torch.Tensor, kg_emb: torch.Tensor,
              g: nn.Module) -> torch.Tensor:
        return g(_l2_normalize(torch.cat([ps_emb, kg_emb.detach()], -1)))

    def latent_features(self, query_words: torch.Tensor,
                        query_word_counts: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """All-entity latents ``[U, d]``, ``[Q, d]``, ``[I, d]``
        (Srrl.py:162-169)."""
        if self.cfg.srrl_kg_loss:
            u = self._fuse(self.PS.embed_user(), self.KG.embed_user(),
                           self.g_u)
            i = self._fuse(self.PS.embed_item(), self.KG.embed_item(),
                           self.g_i)
        else:
            u = self.PS.embed_user()
            i = self.PS.embed_item()
        q = self.KG.embed_query(query_words, query_word_counts)
        return u, q, i

    def _score_rows(self, u_latent, q_latent, i_latent,
                    items) -> torch.Tensor:
        if self.prediction == "hem":
            return self.prediction_layer.score_rows(u_latent, q_latent,
                                                    i_latent, items)
        uq = self.ps_mlp_uq(_l2_normalize(torch.cat([u_latent, q_latent],
                                                    -1)))
        ui = self.ps_mlp_ui(_l2_normalize(torch.cat([u_latent, i_latent],
                                                    -1)))
        return self.ps_mlp_pred(_l2_normalize(torch.cat([uq, ui],
                                                        -1)))[..., 0]

    def forward(self, query_words: torch.Tensor,
                query_word_counts: torch.Tensor, users: torch.Tensor,
                queries: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
        """PS-phase scores of ``[R]`` (u, q, i) rows."""
        u_all, q_all, i_all = self.latent_features(query_words,
                                                   query_word_counts)
        users, queries, items = users.long(), queries.long(), items.long()
        return self._score_rows(u_all[users], q_all[queries], i_all[items],
                                items)

    def all_features(self, query_words: torch.Tensor,
                     query_word_counts: torch.Tensor) -> torch.Tensor:
        """``[U + Q + I, d]`` latents for the shared eval pipeline."""
        return torch.cat(self.latent_features(query_words,
                                              query_word_counts), 0)

    def score_all_items(self, features: torch.Tensor, users: torch.Tensor,
                        queries: torch.Tensor,
                        item_chunk: int = 8192) -> torch.Tensor:
        """``[B]`` (u, q) pairs → ``[B, I]`` catalog scores.

        The MLP scorer is pairwise in (row, item). Its (u, q) branch does
        not depend on the item, so it runs once a row; the items go in
        blocks of ``item_chunk`` (the last one zero-padded, then cut), so
        an intermediate holds ``B · item_chunk · 2d`` values, not
        ``B · I · 2d``."""
        users, queries = users.long(), queries.long()
        u_lat = features[users]
        q_lat = features[queries + self.user_count]
        i_lat = features[self.user_count + self.query_count:]
        if self.prediction == "hem":
            return self.prediction_layer.score_all(u_lat, q_lat, i_lat)

        B, d = u_lat.shape
        n_items = i_lat.shape[0]
        uq = self.ps_mlp_uq(_l2_normalize(torch.cat([u_lat, q_lat], -1)))
        c = min(n_items, item_chunk)
        n_chunks = -(-n_items // c)
        i_pad = torch.nn.functional.pad(i_lat, (0, 0, 0,
                                                n_chunks * c - n_items))
        u_b = u_lat[:, None, :].expand(B, c, d)
        uq_b = uq[:, None, :].expand(B, c, uq.shape[-1])
        blocks = []
        for k in range(n_chunks):
            i_b = i_pad[k * c:(k + 1) * c][None, :, :].expand(B, c, d)
            ui = self.ps_mlp_ui(_l2_normalize(torch.cat([u_b, i_b], -1)))
            blocks.append(self.ps_mlp_pred(_l2_normalize(
                torch.cat([uq_b, ui], -1)))[..., 0])               # [B, c]
        return torch.cat(blocks, 1)[:, :n_items]
