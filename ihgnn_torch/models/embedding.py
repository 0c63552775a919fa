"""Entity embedding tables: users, items, query word bags.

Counterpart of ``ihgnn_tpu/models/embedding.py`` ``EmbeddingTables``
(reference: Models/EmbeddingLayers.py):

* user/item tables have count+1 rows; row 0 is padding and is zero, and
  entity ``i`` lives at row ``i+1`` (Dataset.py:149-155).
* the query vector is the mean of its word vectors
  (``nn.EmbeddingBag(mode='mean')``, EmbeddingLayers.py:100-104), computed
  by ``ops/bag.py`` ``BagMeanFn`` (K1 both ways) over a ``WordBag``: one
  CSR row per query, one entry per non-padding word, weight
  1/max(count, 1).
* optional Linear + ReLU on query vectors (``query_transform ==
  'activation'``, EmbeddingLayers.py:38-48).

Tables are row-major ``[rows, d]`` (the JAX package stores them
feature-major ``[d, rows]``), xavier-uniform over (rows, d). On a mesh
with a model axis a rank holds a block of each table's rows
(``parallel/tables.py`` ``shard_tables``, which sets ``table_mesh``), and
``tables()`` gathers the full tables from every rank's blocks.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ihgnn_torch.config import V
from ihgnn_torch.models.common import TorchDense
from ihgnn_torch.models.initializers import xavier_uniform_
from ihgnn_torch.ops.bag import WordBag, make_word_bag

__all__ = ["EmbeddingTables", "WordBag", "make_word_bag"]


def _table(rows: int, d: int, zero_row0: bool,
           generator: Optional[torch.Generator]) -> nn.Parameter:
    w = xavier_uniform_(torch.empty(rows, d), generator=generator)
    if zero_row0:
        w[0] = 0.0
    return nn.Parameter(w)


class EmbeddingTables(nn.Module):
    def __init__(self, user_count: int, item_count: int, vocab_size: int,
                 embedding_size: int, query_transform: str = V.MEAN,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d = embedding_size
        self.user_count = user_count
        self.item_count = item_count
        self.query_transform = query_transform
        # the tables' logical rows; a rank's blocks hold fewer
        self.rows = {"user_table": user_count + 1,
                     "item_table": item_count + 1,
                     "vocab_table": vocab_size + 1}
        self.table_mesh = None
        self.user_table = _table(user_count + 1, d, True, generator)
        self.item_table = _table(item_count + 1, d, True, generator)
        # EmbeddingBag has no padding_idx in the reference; row 0 is only
        # ever dropped from the bags
        self.vocab_table = _table(vocab_size + 1, d, False, generator)
        if query_transform == V.ACTIVATION:
            self.query_mlp = TorchDense(d, d, generator=generator)
        elif query_transform != V.MEAN:
            raise ValueError(f"unknown query transform {query_transform!r}")

    def tables(self):
        """``(user, item, vocab)`` tables, whole: the parameters, or on a
        mesh with a model axis the full tables gathered from every rank's
        blocks (``GatherTablesFn``)."""
        if self.table_mesh is None:
            return self.user_table, self.item_table, self.vocab_table
        from ihgnn_torch.parallel.tables import TABLES, gather_tables
        return gather_tables(self.table_mesh,
                             [self.rows[n] for n in TABLES],
                             [getattr(self, n) for n in TABLES])

    def embed_query(self, bag: WordBag,
                    vocab_table: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
        """``[Q, d]`` bag means of ``vocab_table`` (default: the module's
        whole table) (then Linear + ReLU under 'activation'); ``bag`` is a
        ``WordBag`` or a rank's ``ShardedBag`` (``parallel/sharding.py``),
        which all-gathers the ranks' slices."""
        if vocab_table is None:
            vocab_table = self.tables()[2]
        out = bag.mean(vocab_table)
        if self.query_transform == V.ACTIVATION:
            out = torch.relu(self.query_mlp(out))
        return out

    def all_features(self, bag: WordBag) -> torch.Tensor:
        """X0 = [users | queries | items] in global node order, ``[N, d]``
        (RawGnn.py:112)."""
        users, items, vocab = self.tables()
        return torch.cat([
            users[1:self.user_count + 1],
            self.embed_query(bag, vocab),
            items[1:self.item_count + 1],
        ], dim=0)
