"""Runtime dataset: Step-3 artifacts → arrays, training and eval batches.

Counterpart of ``ihgnn_tpu/data/dataset.py`` (reference: Dataset.py):

* ``GraphData``    — the training split as NumPy arrays: flat positive
  interactions, the logged negatives (flat and per (u, q)), each user's
  time-sorted history, and the hypergraph, the 2D graph and the log
  hypergraph, each built once on first use.
* ``TrainSampler`` — host-side uniform negative sampling into fixed-shape
  ``Batch``es; it draws from ``np.random.default_rng(seed)`` exactly as
  the JAX sampler does, so one seed gives the same batches in both.
* ``prefetch``     — a background thread that builds batches ahead.
* ``EvalLogs``     — valid/test logs as padded truth matrices
  (Dataset.py:297-329).

Entity ids are 0-based (embedding-table row = id + 1, Dataset.py:149-155).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ihgnn_torch.config import V
from ihgnn_torch.data.collections import SearchLogCollection
from ihgnn_torch.data.schema import PosInteraction
from ihgnn_torch.graph import (Graph2D, HyperGraph, LogHyperGraph,
                               build_graph2d, build_hypergraph,
                               build_log_hypergraph)
from ihgnn_torch.utils.tracing import count, span


@dataclasses.dataclass(frozen=True)
class Batch:
    """One fixed-shape training batch: B positives then B*K negatives.

    ``weight`` masks padded rows (the reference's last partial batch,
    DataLoader drop_last=False) out of the loss mean. A stack of k batches
    (``Batch.stack``) has ``[k, R]`` arrays."""

    users: np.ndarray    # [R] int32 (0-based entity ids)
    queries: np.ndarray  # [R] int32
    items: np.ndarray    # [R] int32
    flags: np.ndarray    # [R] f32 (1 for positives, 0 for negatives)
    weight: np.ndarray   # [R] f32 (0 on padded rows)

    @staticmethod
    def stack(batches: Sequence["Batch"]) -> "Batch":
        return Batch(*(np.stack([getattr(b, f.name) for b in batches])
                       for f in dataclasses.fields(Batch)))

    def unstack(self) -> List["Batch"]:
        """The k batches of a stack; ``[self]`` for one batch."""
        if self.users.ndim == 1:
            return [self]
        return [Batch(*(getattr(self, f.name)[m]
                        for f in dataclasses.fields(Batch)))
                for m in range(self.users.shape[0])]


class GraphData:
    """Training split (replaces Dataset.py:11-293), as
    ``ihgnn_tpu.data.dataset.GraphData`` without its routed word-bag pack
    (the port's bag is ``ops.bag.BagMeanFn`` on K1).
    ``graph_completeness`` picks the 2D graph's mode (uqi/uq/ui/qi);
    ``user_history_limit`` truncates each user's history (-1: none)."""

    def __init__(self, user_count: int, query_count: int, item_count: int,
                 vocab_size: int, query_words: np.ndarray,
                 query_word_counts: np.ndarray,
                 search_logs: SearchLogCollection,
                 graph_completeness: str = V.GRAPH_UQI,
                 user_history_limit: int = 500):
        self.user_count = int(user_count)
        self.query_count = int(query_count)
        self.item_count = int(item_count)
        self.vocab_size = int(vocab_size)
        self.node_count = self.user_count + self.query_count + self.item_count
        self.query_start = self.user_count
        self.item_start = self.user_count + self.query_count

        # [Q, Lmax] word rows (= word index + 1), 0-padded; [Q] bag sizes
        self.query_words = np.asarray(query_words, np.int32)
        self.query_word_counts = np.asarray(query_word_counts, np.int32)
        self.search_logs = search_logs
        self.graph_completeness = graph_completeness
        self.user_history_limit = user_history_limit

        # positives with flags clamped to 1 (Dataset.py:200 treat_all_1),
        # and the logged negatives, flat (u, q, i) and per (u, q)
        # (Dataset.py:201-209)
        pos = []
        neg_interactions: List[Tuple[int, int, int]] = []
        neg_items_for_uq: Dict[Tuple[int, int], List[int]] = {}
        for log in search_logs:
            pos.extend(p.uqif() for p in
                       PosInteraction.from_search_log(log, treat_all_1=True))
            negs = neg_items_for_uq.setdefault((log.user, log.query), [])
            for item, flag in zip(log.items, log.interactions):
                if flag <= 0:
                    neg_interactions.append((log.user, log.query, item))
                    negs.append(item)
        self.pos_uqif = np.asarray(pos, np.int32).reshape(-1, 4)   # [P, 4]
        self.neg_interactions = neg_interactions
        self.neg_items_for_uq = neg_items_for_uq
        self._hypergraph: Optional[HyperGraph] = None
        self._graph2d: Optional[Graph2D] = None
        self._log_hypergraph: Optional[LogHyperGraph] = None
        self._user_history: Optional[Tuple[List[List[int]],
                                           List[List[int]]]] = None

    @property
    def pos_count(self) -> int:
        return len(self.pos_uqif)

    @property
    def hypergraph(self) -> HyperGraph:
        """The CPU hypergraph of the positives, built once."""
        if self._hypergraph is None:
            self._hypergraph = build_hypergraph(
                self.pos_uqif, self.node_count, self.user_count,
                self.query_count)
        return self._hypergraph

    @property
    def graph2d(self) -> Graph2D:
        """The CPU 2D graph of the positives in ``graph_completeness``
        mode, built once."""
        if self._graph2d is None:
            self._graph2d = build_graph2d(
                self.pos_uqif, self.node_count, self.user_count,
                self.query_count, completeness=self.graph_completeness)
        return self._graph2d

    @property
    def log_hypergraph(self) -> LogHyperGraph:
        """The CPU log hypergraph, built once: one edge per log with at
        least one positive item; logs with only {u, q} are dropped."""
        if self._log_hypergraph is None:
            log_nodes = []
            for log in self.search_logs:
                nodes = [log.user, log.query + self.query_start]
                nodes.extend(i + self.item_start for i, f in
                             zip(log.items, log.interactions) if f > 0)
                if len(nodes) > 2:
                    log_nodes.append(nodes)
            self._log_hypergraph = build_log_hypergraph(log_nodes,
                                                        self.node_count)
        return self._log_hypergraph

    def user_history(self) -> Tuple[List[List[int]], List[List[int]]]:
        """Each user's queries and positively interacted items, sorted by
        time and truncated to ``user_history_limit`` (Dataset.py:227-245);
        built once."""
        if self._user_history is None:
            qhis: List[List[Tuple[str, int]]] = [[] for _ in
                                                 range(self.user_count)]
            ihis: List[List[Tuple[str, int]]] = [[] for _ in
                                                 range(self.user_count)]
            for log in self.search_logs:
                qhis[log.user].append((log.search_time, log.query))
                ihis[log.user].extend(
                    (t, i) for t, i, f in
                    zip(log.times, log.items, log.interactions) if f > 0)
            limit = self.user_history_limit
            q_out, i_out = [], []
            for u in range(self.user_count):
                qs = [q for _, q in sorted(qhis[u])]
                its = [i for _, i in sorted(ihis[u])]
                if limit != -1:
                    qs, its = qs[:limit], its[:limit]
                q_out.append(qs)
                i_out.append(its)
            self._user_history = (q_out, i_out)
        return self._user_history

    def user_history_tensors(self) -> Tuple[np.ndarray, np.ndarray]:
        """The histories as ``[U, longest]`` int32 arrays (queries, items),
        -1 padded (Dataset.py:246-258)."""
        qhis, ihis = self.user_history()
        q_arr, _ = pad_ragged(qhis, pad_value=-1)
        i_arr, _ = pad_ragged(ihis, pad_value=-1)
        return q_arr, i_arr

    @classmethod
    def from_files(cls, data_dir: str, split: str = "train",
                   graph_completeness: str = V.GRAPH_UQI,
                   user_history_limit: int = 500) -> "GraphData":
        """Load graph_info.txt + queries_multihot.txt + {split}_data.csv
        (the Step-3 artifact layout,
        PreProcess/Step3-ConvertToOnehot.py:136-158)."""
        with open(os.path.join(data_dir, "graph_info.txt"), "r",
                  encoding="utf-8") as f:
            user_count, query_count, item_count, vocab_size = \
                [int(p) for p in f.readline().strip().split()]
        rows: List[List[int]] = []
        with open(os.path.join(data_dir, "queries_multihot.txt"), "r",
                  encoding="utf-8") as f:
            for line in f:
                if line.strip():
                    rows.append([int(p) + 1 for p in line.strip().split()])
        if len(rows) != query_count:
            raise ValueError(f"queries_multihot has {len(rows)} rows, "
                             f"expected {query_count}")
        query_words, query_word_counts = pad_ragged(rows)
        logs = SearchLogCollection.read(
            os.path.join(data_dir, f"{split}_data.csv"))
        return cls(user_count, query_count, item_count, vocab_size,
                   query_words, query_word_counts, logs, graph_completeness,
                   user_history_limit)


def pad_ragged(rows: Sequence[Sequence[int]], pad_value: int = 0,
               min_width: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Ragged int lists → ([N, Lmax] padded matrix, [N] lengths)."""
    counts = np.asarray([len(r) for r in rows], np.int32)
    width = max(int(counts.max()) if len(rows) else 0, min_width)
    out = np.full((len(rows), width), pad_value, np.int32)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out, counts


class TrainSampler:
    """Host-side epoch sampler with uniform negative sampling.

    Per positive interaction, draws ``rand_neg`` distinct random item ids
    (Dataset.py:107-109 random.sample semantics) plus optionally
    ``nonrand_neg`` log-provided negatives with random top-up
    (Dataset.py:110-119). Emits fixed-shape ``Batch``es; the final partial
    batch is zero-weight padded."""

    def __init__(self, data: GraphData, batch_size: int, rand_neg: int,
                 nonrand_neg: int = 0, seed: int = 0, shuffle: bool = True,
                 row_multiple: int = 1):
        self.data = data
        self.batch_size = batch_size
        self.rand_neg = rand_neg
        self.nonrand_neg = nonrand_neg
        self.neg_total = rand_neg + nonrand_neg
        self.rng = np.random.default_rng(seed)
        self.shuffle = shuffle
        rows = batch_size * (1 + self.neg_total)
        self.rows = -(-rows // row_multiple) * row_multiple

    @property
    def steps_per_epoch(self) -> int:
        return -(-self.data.pos_count // self.batch_size)

    def _draw_random_negatives(self, n_rows: int, k: int) -> np.ndarray:
        """[n_rows, k] uniform item ids, distinct within each row."""
        item_count = self.data.item_count
        if k == 0:
            return np.zeros((n_rows, 0), np.int32)
        draw = self.rng.integers(0, item_count, size=(n_rows, k),
                                 dtype=np.int64)
        if k > 1 and item_count > k:
            # redraw the (rare) rows that hold a duplicate
            bad = (np.diff(np.sort(draw, axis=1), axis=1) == 0).any(axis=1)
            for r in np.nonzero(bad)[0]:
                draw[r] = self.rng.choice(item_count, size=k, replace=False)
        return draw.astype(np.int32)

    def epoch(self) -> Iterator[Batch]:
        data = self.data
        P, B, K = data.pos_count, self.batch_size, self.neg_total
        order = self.rng.permutation(P) if self.shuffle else np.arange(P)

        for start in range(0, P, B):
            idx = order[start:start + B]
            n = len(idx)
            pos = data.pos_uqif[idx]                                # [n, 4]

            if self.nonrand_neg == 0:
                negs = self._draw_random_negatives(n, self.rand_neg)
            else:
                negs = np.zeros((n, K), np.int32)
                for r in range(n):
                    u, q = int(pos[r, 0]), int(pos[r, 1])
                    provided = data.neg_items_for_uq.get((u, q), [])
                    if len(provided) < self.nonrand_neg:
                        top_up = K - len(provided)
                        row = list(self.rng.choice(data.item_count,
                                                   size=top_up,
                                                   replace=False)) + provided
                    else:
                        row = list(self.rng.choice(provided,
                                                   size=self.nonrand_neg,
                                                   replace=False))
                        row += list(self.rng.choice(data.item_count,
                                                    size=self.rand_neg,
                                                    replace=False))
                    negs[r] = row

            # fixed-shape rows: positives, then their negatives
            users = np.zeros(self.rows, np.int32)
            queries = np.zeros(self.rows, np.int32)
            items = np.zeros(self.rows, np.int32)
            flags = np.zeros(self.rows, np.float32)
            weight = np.zeros(self.rows, np.float32)
            users[:n] = pos[:, 0]
            queries[:n] = pos[:, 1]
            items[:n] = pos[:, 2]
            flags[:n] = pos[:, 3].astype(np.float32)
            weight[:n] = 1.0
            users[B:B + n * K] = np.repeat(pos[:, 0], K)
            queries[B:B + n * K] = np.repeat(pos[:, 1], K)
            items[B:B + n * K] = negs.reshape(-1)
            weight[B:B + n * K] = 1.0
            yield Batch(users=users, queries=queries, items=items,
                        flags=flags, weight=weight)


def prefetch(iterator: Iterator, depth: int = 2) -> Iterator:
    """Drain ``iterator`` on a daemon thread into a bounded queue, so batch
    assembly on the host overlaps the step on the card. Exceptions of the
    producer are raised in the consumer. Counts ``feed.batches`` (items
    taken) and ``feed.waited`` (items the queue did not hold yet when
    asked); the wait for each is the span ``feed.wait``."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    end = object()

    def produce():
        try:
            for item in iterator:
                q.put(item)
            q.put(end)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            q.put(e)

    threading.Thread(target=produce, daemon=True).start()
    while True:
        if q.empty():
            count("feed.waited")
        with span("feed.wait"):
            item = q.get()
        if item is end:
            return
        if isinstance(item, BaseException):
            raise item
        count("feed.batches")
        yield item


class EvalLogs:
    """Valid/test logs as padded arrays for the full-catalog scorer.

    Keeps only logs with at least one positive interaction
    (Dataset.py:312-313); the ground truth is the unique positive items in
    first-seen order (``SearchLog.get_interacted_items``)."""

    def __init__(self, logs: SearchLogCollection):
        users, queries, truths = [], [], []
        self.line_count = len(logs)
        for log in logs:
            if sum(log.interactions) > 0:
                items, _, _ = log.get_interacted_items()
                users.append(log.user)
                queries.append(log.query)
                truths.append(items)
        self.users = np.asarray(users, np.int32)
        self.queries = np.asarray(queries, np.int32)
        self.truth, self.truth_counts = pad_ragged(truths, pad_value=-1)
        self.count = len(users)

    @classmethod
    def from_file(cls, filename: str) -> "EvalLogs":
        return cls(SearchLogCollection.read(filename))

    def batches(self, batch_size: int) -> Iterator[Tuple[
            np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
        """Yield (users, queries, truth, truth_counts, weight) padded to
        ``batch_size`` rows; ``weight`` is 0 on padding."""
        for start in range(0, self.count, batch_size):
            end = min(start + batch_size, self.count)
            n = end - start
            users = np.zeros(batch_size, np.int32)
            queries = np.zeros(batch_size, np.int32)
            truth = np.full((batch_size, self.truth.shape[1]), -1, np.int32)
            counts = np.zeros(batch_size, np.int32)
            weight = np.zeros(batch_size, np.float32)
            users[:n] = self.users[start:end]
            queries[:n] = self.queries[start:end]
            truth[:n] = self.truth[start:end]
            counts[:n] = self.truth_counts[start:end]
            weight[:n] = 1.0
            yield users, queries, truth, counts, weight
