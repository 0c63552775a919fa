"""Srrl's knowledge-graph sampler: meta-path indexes and host-side batch
draws.

Counterpart of ``ihgnn_tpu/data/srrl_sampler.py`` (the reference's
SrrlDataset.py), with the same draws in the same order from
``np.random.default_rng(seed)``, so one seed gives both packages the same
batches:

* ``MetaPaths`` — positive and negative company lists keyed by (u, q),
  (q, i) and (u, i), deduplicated (SrrlDataset.py:22-76);
* ``SrrlKGSampler`` — each step a batch of positive triples with uniform
  negative items (with replacement, SrrlDataset.py:112), word2vec
  subsampling weights sqrt(1 / (3 + count(u, q))) (SrrlDataset.py:97-109)
  and one random "true company" a row (SrrlDataset.py:159-170). The mode
  rotates tail → head → query company a step (OneShotIterator,
  SrrlDataset.py:190-213).
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Tuple

import numpy as np

from ihgnn_torch.data.dataset import GraphData
from ihgnn_torch.models.srrl import KG_MODES


class MetaPaths:
    def __init__(self, data: GraphData):
        self.data = data
        self.positive_interactions: List[Tuple[int, int, int]] = [
            (int(u), int(q), int(i)) for u, q, i, _ in data.pos_uqif]

        self.positive_tails: Dict[Tuple[int, int], List[int]] = {}
        self.positive_heads: Dict[Tuple[int, int], List[int]] = {}
        self.positive_queries: Dict[Tuple[int, int], List[int]] = {}
        for u, q, i in self.positive_interactions:
            self.positive_tails.setdefault((u, q), []).append(i)
            self.positive_heads.setdefault((q, i), []).append(u)
            self.positive_queries.setdefault((u, i), []).append(q)

        self.negative_tails: Dict[Tuple[int, int], List[int]] = {}
        self.negative_heads: Dict[Tuple[int, int], List[int]] = {}
        self.negative_queries: Dict[Tuple[int, int], List[int]] = {}
        for u, q, i in data.neg_interactions:
            self.negative_tails.setdefault((u, q), []).append(i)
            self.negative_heads.setdefault((q, i), []).append(u)
            self.negative_queries.setdefault((u, i), []).append(q)

        # list(set(...)): the order of a set of ints is fixed by their
        # values, so both packages draw companies from equal lists
        for d in (self.positive_tails, self.positive_heads,
                  self.positive_queries, self.negative_tails,
                  self.negative_heads, self.negative_queries):
            for k, v in d.items():
                d[k] = list(set(v))

        # subsampling frequency: 3 + count(u, q) (SrrlDataset.py:97-100)
        counts: Dict[Tuple[int, int], int] = {}
        for u, q, _ in self.positive_interactions:
            counts[(u, q)] = counts.get((u, q), 3) + 1
        self.head_query_frequency = counts


class SrrlKGSampler:
    def __init__(self, meta_paths: MetaPaths, batch_size: int,
                 negative_sample_size: int, seed: int = 0,
                 only_random_negatives: bool = True):
        self.mp = meta_paths
        self.batch_size = batch_size
        self.neg_size = negative_sample_size
        self.rng = np.random.default_rng(seed)
        self.only_random = only_random_negatives
        self.step_count = 0
        self._triples = np.asarray(self.mp.positive_interactions, np.int64)
        self._weights = np.asarray(
            [np.sqrt(1.0 / self.mp.head_query_frequency[(u, q)])
             for u, q, _ in self.mp.positive_interactions], np.float32)
        # a shuffled walk a mode: the reference cycles each mode's
        # DataLoader(shuffle=True) forever, so every triple comes once a
        # mode-epoch
        self._walk = {m: iter(()) for m in KG_MODES}

    def _next_idx(self, mode) -> np.ndarray:
        out = np.empty(self.batch_size, np.int64)
        have = 0
        while have < self.batch_size:
            take = list(itertools.islice(self._walk[mode],
                                         self.batch_size - have))
            out[have:have + len(take)] = take
            have += len(take)
            if have < self.batch_size:
                self._walk[mode] = iter(
                    self.rng.permutation(len(self._triples)))
        return out

    @property
    def steps_per_epoch(self) -> int:
        # ceil(P / batch) (Main.py:183-184)
        return -(-len(self._triples) // self.batch_size)

    def next(self):
        """One KG step's batch: (mode, triples [B, 3], neg_items [B, k],
        weights [B], company [B]), NumPy arrays. The mode rotates a call."""
        mode = KG_MODES[self.step_count % 3]
        self.step_count += 1

        idx = self._next_idx(mode)
        triples = self._triples[idx].astype(np.int32)
        weights = self._weights[idx]
        if self.only_random:
            negs = self.rng.integers(0, self.mp.data.item_count,
                                     (self.batch_size, self.neg_size)
                                     ).astype(np.int32)
        else:
            # the logged negative tails, drawn or topped up to size
            # (SrrlDataset.py:146-157)
            negs = np.zeros((self.batch_size, self.neg_size), np.int32)
            for r, (u, q, i) in enumerate(triples):
                pool = self.mp.negative_tails.get((int(u), int(q)), [])
                if not pool:
                    negs[r] = self.rng.integers(0, self.mp.data.item_count,
                                                self.neg_size)
                elif len(pool) > self.neg_size:
                    negs[r] = self.rng.choice(pool, self.neg_size,
                                              replace=False)
                else:
                    negs[r] = list(pool) + list(self.rng.choice(
                        pool, self.neg_size - len(pool), replace=True))

        company = np.zeros(self.batch_size, np.int32)
        for r, (u, q, i) in enumerate(triples):
            key = (int(u), int(q), int(i))
            if mode == KG_MODES[0]:      # tail company from (u, q)
                pool = self.mp.positive_tails.get((key[0], key[1]), [])
                company[r] = self.rng.choice(pool) if pool else i
            elif mode == KG_MODES[1]:    # head company from (q, i)
                pool = self.mp.positive_heads.get((key[1], key[2]), [])
                company[r] = self.rng.choice(pool) if pool else u
            else:                        # query company from (u, i)
                pool = self.mp.positive_queries.get((key[0], key[2]), [])
                company[r] = self.rng.choice(pool) if pool else q
        return mode, triples, negs, weights, company
