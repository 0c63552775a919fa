"""The query word-bag mean, with autograd.

Counterpart of ``ihgnn_tpu/ops/bag.py`` ``_bag_mean_single`` and its
gradient ``_bag_grad_impl`` (``bag.py:171-216``). The TPU routes the word
stream through Clos stages into a segment-sum in both directions; here
both directions are K1 (``ops/segsum.py``) over a CSR the host builds once:

* forward — query-major: query q sums ``w · vocab[word]`` over its words;
* backward — word-major, the transpose: vocab row v sums ``w · cot[q]``
  over the queries that hold v. Row 0 (padding) has no entries and stays
  0.

Both weigh an entry by 1/max(count_q, 1), as the JAX package's masked
mean does (``models/embedding.py:133-137``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ihgnn_torch.device import DeviceLike, resolve_device
from ihgnn_torch.ops.segsum import csr_gather_sum


@dataclasses.dataclass(frozen=True)
class WordBag:
    """The query word bags as CSR: query ``q`` owns entries
    ``[rowptr[q], rowptr[q+1])`` of ``col`` (vocab table rows); its
    transpose ``t_*`` gives vocab row ``v`` the entries
    ``[t_rowptr[v], t_rowptr[v+1])`` of ``t_col`` (query ids, ascending)."""

    rowptr: torch.Tensor     # [Q+1] int32
    col: torch.Tensor        # [K] int32 — word table row (word id + 1)
    weight: torch.Tensor     # [K] f32 — 1 / max(count, 1) of the entry's query
    t_rowptr: torch.Tensor   # [vocab_rows + 1] int32 — offsets per vocab row
    t_col: torch.Tensor      # [K] int32 — query id of each word-major entry
    t_weight: torch.Tensor   # [K] f32

    @property
    def vocab_rows(self) -> int:
        return self.t_rowptr.shape[0] - 1

    def mean(self, vocab_table: torch.Tensor) -> torch.Tensor:
        """``[Q, d]`` bag means of ``vocab_table`` (``BagMeanFn``)."""
        return BagMeanFn.apply(vocab_table, self)

    def to(self, device: DeviceLike) -> "WordBag":
        dev = resolve_device(device)
        return WordBag(*(getattr(self, f.name).to(dev)
                         for f in dataclasses.fields(self)))


def make_word_bag(query_words, query_word_counts, vocab_rows: int) -> WordBag:
    """CPU ``WordBag`` from ``query_words`` ``[Q, L]`` (word table rows,
    0-padded) and ``query_word_counts`` ``[Q]``. Entries whose word is 0
    are dropped; every entry of query q weighs 1/max(count_q, 1).
    ``vocab_rows`` is the vocab table's row count (V + 1): the transpose
    has one segment per table row, so the backward's gradient has the
    table's shape."""
    qw = np.asarray(query_words, np.int64)
    qc = np.asarray(query_word_counts, np.int64)
    mask = qw > 0
    per_query = mask.sum(axis=1)
    rowptr = np.zeros(len(qw) + 1, np.int64)
    np.cumsum(per_query, out=rowptr[1:])
    inv = (1.0 / np.maximum(qc, 1)).astype(np.float32)
    col = qw[mask]
    weight = np.repeat(inv, per_query)
    if col.size and col.max() >= vocab_rows:
        raise ValueError(f"word rows must lie in [0, {vocab_rows})")
    # word-major transpose; a stable sort keeps query ids ascending
    queries = np.repeat(np.arange(len(qw), dtype=np.int64), per_query)
    order = np.argsort(col, kind="stable")
    t_rowptr = np.zeros(vocab_rows + 1, np.int64)
    np.cumsum(np.bincount(col, minlength=vocab_rows), out=t_rowptr[1:])
    return WordBag(
        rowptr=torch.from_numpy(rowptr.astype(np.int32)),
        col=torch.from_numpy(col.astype(np.int32)),
        weight=torch.from_numpy(weight),
        t_rowptr=torch.from_numpy(t_rowptr.astype(np.int32)),
        t_col=torch.from_numpy(queries[order].astype(np.int32)),
        t_weight=torch.from_numpy(weight[order]))


class BagMeanFn(torch.autograd.Function):
    """``vocab_table [V+1, d]`` → ``[Q, d]`` bag means over ``bag``; the
    table's gradient is the word-major sum of the query cotangents."""

    @staticmethod
    def forward(ctx, vocab_table, bag: WordBag):
        if bag.vocab_rows != vocab_table.shape[0]:
            raise ValueError(f"the bag was built for {bag.vocab_rows} vocab "
                             f"rows; the table has {vocab_table.shape[0]}")
        ctx.bag = bag
        return csr_gather_sum(vocab_table, bag.col, bag.rowptr, bag.weight)

    @staticmethod
    def backward(ctx, cot):
        bag = ctx.bag
        grad = csr_gather_sum(cot.contiguous(), bag.t_col, bag.t_rowptr,
                              bag.t_weight)
        return grad, None
