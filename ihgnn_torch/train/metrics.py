"""Ranking metrics: HR@10, NDCG@10, MAP@10 (+ MRR@10).

Counterpart of ``ihgnn_tpu/train/metrics.py``:

* ``ranking_metrics`` — batched: ``[B, I]`` scores → per-log metric rows.
* ``Metrics`` — the reference's accumulator API (Helpers/Metrics.py:8-109),
  with ``calculate_on_all_items`` as the host golden implementation;
* ``MetricsCollection`` — per-epoch test/valid metrics and the best epoch
  (Helpers/Metrics.py:112-162), with each epoch's loss and times
  (``EpochStats``, the port's addition).

Reference quirks kept exactly:
* the HR denominator is min(|truth|, 10) (Metrics.py:80);
* MAP walks the ground-truth items in their given order, and its hit
  counter j counts in that order, not by rank (Metrics.py:105-109);
* graded NDCG (flags not all 1) takes its IDCG over the flags of the hit
  items only, sorted descending (Metrics.py:77,86);
* the DCG discount is 1/log2(rank+2), written log(2, base)
  (Metrics.py:91-103).

MRR@10, an addition, is the reciprocal rank of the best-ranked truth item
within the top 10, else 0.
"""

from __future__ import annotations

import dataclasses
import math
from typing import (Any, Callable, Iterable, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

K = 10


def ranking_metrics(scores: torch.Tensor, truth: torch.Tensor,
                    truth_counts: torch.Tensor, k: int = K) -> torch.Tensor:
    """Per-log metrics from full-catalog scores.

    Args:
      scores: ``[B, I]`` model scores, one row per search log.
      truth: ``[B, T]`` ground-truth item ids, -1 padded.
      truth_counts: ``[B]`` number of valid truth entries.
    Returns:
      ``[B, 4]`` f32 rows of (HR@k, NDCG@k, MAP@k, MRR@k); rows with
      ``truth_counts == 0`` are zero.
    """
    top = torch.topk(scores, k, dim=1).indices                # [B, k]
    truth = truth.long()
    valid = truth >= 0
    eq = top[:, None, :] == truth[:, :, None]                 # [B, T, k]
    hit = eq.any(-1) & valid                                  # [B, T]
    # argmax returns the first maximal index: the rank of the match
    pos = torch.where(hit, eq.to(torch.int8).argmax(-1),
                      torch.full_like(truth, k)).float()      # [B, T]

    capped = torch.clamp(torch.clamp(truth_counts.long(), max=k), min=1)
    n_hit = hit.sum(-1).float()
    hr = n_hit / capped.float()

    # NDCG with all-1 relevance: eval clamps flags to 1 (Dataset.py:310-313)
    discount = torch.where(hit, 1.0 / torch.log2(pos + 2.0),
                           torch.zeros_like(pos))
    dcg = discount.sum(-1)
    r = torch.arange(truth.shape[1], dtype=torch.float32,
                     device=scores.device)
    idcg_prefix = torch.cumsum(1.0 / torch.log2(r + 2.0), dim=0)
    idcg = torch.clamp(idcg_prefix[capped - 1], min=1e-12)
    ndcg = dcg / idcg

    # MAP with the reference's truth-order hit counter
    j = torch.cumsum(hit.float(), dim=-1)
    ap_terms = torch.where(hit, j / (pos + 1.0), torch.zeros_like(pos))
    ap = torch.where(n_hit > 0,
                     ap_terms.sum(-1) / torch.clamp(n_hit, min=1.0),
                     torch.zeros_like(n_hit))

    best = torch.where(hit, pos, torch.full_like(pos, k)).amin(-1)
    mrr = torch.where(best < k, 1.0 / (best + 1.0), torch.zeros_like(best))

    return torch.stack([hr, ndcg, ap, mrr], dim=1)


class Metrics:
    """Accumulator with the reference's API (Helpers/Metrics.py:8-109),
    extended with MRR@10."""

    title = "HitRatio@10 NDCG@10 MAP@10 MRR@10"

    def __init__(self):
        self.HitRatio_at10 = 0.0
        self.NDCG_at10 = 0.0
        self.MAP_at10 = 0.0
        self.MRR_at10 = 0.0

    def add_to_self(self, m: "Metrics") -> None:
        self.HitRatio_at10 += m.HitRatio_at10
        self.NDCG_at10 += m.NDCG_at10
        self.MAP_at10 += m.MAP_at10
        self.MRR_at10 += m.MRR_at10

    def divide_and_get_new(self, count: float) -> "Metrics":
        return Metrics.from_row([v / count for v in self.as_row()])

    def as_row(self) -> List[float]:
        return [self.HitRatio_at10, self.NDCG_at10, self.MAP_at10,
                self.MRR_at10]

    def to_string(self, no_title: bool = False) -> str:
        line = " ".join(f"{v:.4f}" for v in self.as_row())
        return line if no_title else self.title + "\n" + line

    __str__ = to_string
    __repr__ = to_string

    @classmethod
    def from_row(cls, row: Sequence[float]) -> "Metrics":
        m = cls()
        m.HitRatio_at10, m.NDCG_at10, m.MAP_at10, m.MRR_at10 = \
            float(row[0]), float(row[1]), float(row[2]), float(row[3])
        return m

    @staticmethod
    def calculate_on_all_items(model_outputs: np.ndarray,
                               interacted_items: List[int],
                               flags: Optional[List[int]],
                               flags_are_all_1: bool) -> "Metrics":
        """Host golden implementation (Helpers/Metrics.py:47-88)."""
        scores = np.asarray(model_outputs)
        order = np.argsort(-scores, kind="stable")[:K]
        rank_of = {int(item): pos for pos, item in enumerate(order)}

        indices_hit: List[int] = []
        flags_hit: List[int] = []
        if flags_are_all_1:
            for item in interacted_items:
                if item in rank_of:
                    indices_hit.append(rank_of[item])
        else:
            for item, flag in zip(interacted_items, flags):
                if item in rank_of:
                    indices_hit.append(rank_of[item])
                    flags_hit.append(flag)

        truth_in_10 = min(len(interacted_items), K)
        m = Metrics()
        m.HitRatio_at10 = len(indices_hit) / truth_in_10
        m.MAP_at10 = Metrics._map_all1(indices_hit)
        if flags_are_all_1:
            m.NDCG_at10 = (Metrics._dcg_graded(indices_hit, None)
                           / Metrics._idcg_all1(truth_in_10))
        else:
            idcg = Metrics._idcg_graded(sorted(flags_hit, reverse=True))
            m.NDCG_at10 = (Metrics._dcg_graded(indices_hit, flags_hit) / idcg
                           if idcg else 0.0)
        m.MRR_at10 = 1.0 / (min(indices_hit) + 1) if indices_hit else 0.0
        return m

    # log(2, base) == 1/log2(base): the DCG discount (Metrics.py:91-103)
    @staticmethod
    def _idcg_all1(truth_count: int) -> float:
        return sum(math.log(2, r) for r in range(2, 2 + truth_count))

    @staticmethod
    def _dcg_graded(indices_hit: List[int],
                    flags_hit: Optional[List[int]]) -> float:
        """DCG; ``flags_hit`` None means all-1 relevance (gain 1)."""
        if flags_hit is None:
            return sum(math.log(2, i + 2) for i in indices_hit)
        return sum(math.log(2, i + 2) * (2 ** r - 1)
                   for i, r in zip(indices_hit, flags_hit))

    @staticmethod
    def _idcg_graded(flags_descending: List[int]) -> float:
        return sum(math.log(2, i + 2) * (2 ** r - 1)
                   for i, r in enumerate(flags_descending))

    @staticmethod
    def _map_all1(indices_hit: List[int]) -> float:
        n = len(indices_hit)
        if n == 0:
            return 0.0
        return sum(j / (i + 1)
                   for i, j in zip(indices_hit, range(1, n + 1))) / n


@dataclasses.dataclass(frozen=True)
class EpochStats:
    """One epoch of a CLI run: its average loss, its train pass (steps and
    seconds, until the losses reached the host) and, on a test epoch, the
    seconds of the whole evaluation (the shared forward, test and valid);
    None otherwise. A Srrl epoch's ``avg_loss`` and ``steps`` are its PS
    pass's, ``kg_avg_loss``, ``kg_steps`` and ``kg_s`` its KG pass's (None,
    0 and None without one); ``train_s`` covers both."""

    epoch: int
    avg_loss: float
    steps: int
    train_s: float
    eval_s: Optional[float] = None
    kg_avg_loss: Optional[float] = None
    kg_steps: int = 0
    kg_s: Optional[float] = None


class MetricsCollection:
    """Per-epoch test/valid metric tracking with best-epoch selection
    (Helpers/Metrics.py:112-162); ``epoch_stats`` holds every epoch's
    ``EpochStats`` in the order run."""

    def __init__(self, has_valid: bool = False):
        self.has_valid = has_valid
        self._epochs: List[int] = []
        self._tests: List[Metrics] = []
        self._valids: List[Metrics] = []
        self.epoch_stats: List[EpochStats] = []

    def add(self, epoch: int, m_test: Metrics,
            m_valid: Optional[Metrics] = None) -> None:
        if self.has_valid != (m_valid is not None):
            raise ValueError(f"has_valid is {self.has_valid}")
        self._epochs.append(epoch)
        self._tests.append(m_test)
        if m_valid is not None:
            self._valids.append(m_valid)

    def get_valid_best(self, key: Callable[[Metrics], Any],
                       max_is_best: bool = True
                       ) -> Tuple[int, Metrics, Metrics]:
        """(epoch, test, valid) of the first epoch whose valid metrics
        are best under ``key``."""
        if not self.has_valid:
            raise ValueError("has_valid is False")
        pick = max if max_is_best else min
        i = self._valids.index(pick(self._valids, key=key))
        return self._epochs[i], self._tests[i], self._valids[i]

    def get_test_best(self, key: Callable[[Metrics], Any],
                      max_is_best: bool = True):
        pick = max if max_is_best else min
        i = self._tests.index(pick(self._tests, key=key))
        if self.has_valid:
            return self._epochs[i], self._tests[i], self._valids[i]
        return self._epochs[i], self._tests[i]

    def iter_epoch_test(self) -> Iterable[Tuple[int, Metrics]]:
        return zip(self._epochs, self._tests)

    def iter_epoch_test_valid(self) -> Iterable[Tuple[int, Metrics,
                                                      Metrics]]:
        if not self.has_valid:
            raise ValueError("has_valid is False")
        return zip(self._epochs, self._tests, self._valids)
