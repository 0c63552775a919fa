"""Synthetic search-log generator.

Counterpart of ``ihgnn_tpu/data/synthetic.py``: small fixture datasets for
tests and the quality set of ``ihgnn_torch.quality_parity``. It makes the
same draws from ``np.random.default_rng(seed)`` in the same order, so one
seed gives the same logs in both packages.

Item and query popularity is Zipf-like, so the graphs have a realistic
degree skew.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ihgnn_torch.config import V
from ihgnn_torch.data.collections import SearchLogCollection
from ihgnn_torch.data.dataset import EvalLogs, GraphData, pad_ragged
from ihgnn_torch.data.schema import SearchLog


def _zipf_choice(rng: np.random.Generator, n: int, size,
                 alpha: float = 0.8) -> np.ndarray:
    ranks = np.arange(1, n + 1, dtype=np.float64)
    p = ranks ** -alpha
    p /= p.sum()
    return rng.choice(n, size=size, p=p)


def make_synthetic_logs(user_count: int = 30, query_count: int = 20,
                        item_count: int = 50, vocab_size: int = 40,
                        log_count: int = 200, items_per_log: int = 5,
                        positive_rate: float = 0.5, seed: int = 0
                        ) -> Tuple[SearchLogCollection, np.ndarray,
                                   np.ndarray]:
    """Returns (logs, query_words, query_word_counts). Every user gets at
    least one log and every log a positive; flags are 0/1; times are
    sortable strings."""
    rng = np.random.default_rng(seed)

    # queries: 1-4 distinct words each, stored as word index + 1
    q_rows = []
    for _ in range(query_count):
        n_words = int(rng.integers(1, 5))
        words = rng.choice(vocab_size, size=n_words, replace=False)
        q_rows.append([int(w) + 1 for w in words])
    query_words, query_word_counts = pad_ragged(q_rows)

    logs = SearchLogCollection()
    users = np.concatenate([np.arange(user_count),
                            rng.integers(0, user_count,
                                         max(log_count - user_count, 0))])
    rng.shuffle(users)
    for li in range(log_count):
        u = int(users[li])
        q = int(_zipf_choice(rng, query_count, ()))
        n_items = int(rng.integers(1, items_per_log + 1))
        items = [int(x) for x in _zipf_choice(rng, item_count, n_items)]
        flags = [int(rng.random() < positive_rate) for _ in range(n_items)]
        if sum(flags) == 0:
            flags[int(rng.integers(0, n_items))] = 1
        t = f"t{li:08d}"
        logs.append(SearchLog(
            user=u, query=q, search_time=t,
            items=items,
            pages=[1] * n_items,
            positions=list(range(n_items)),
            interactions=flags,
            times=[f"{t}.{k}" for k in range(n_items)],
        ))
    return logs, query_words, query_word_counts


def make_synthetic_data(user_count: int = 30, query_count: int = 20,
                        item_count: int = 50, vocab_size: int = 40,
                        log_count: int = 200, items_per_log: int = 5,
                        positive_rate: float = 0.5, seed: int = 0,
                        graph_completeness: str = V.GRAPH_UQI) -> GraphData:
    logs, qw, qc = make_synthetic_logs(user_count, query_count, item_count,
                                       vocab_size, log_count, items_per_log,
                                       positive_rate, seed)
    return GraphData(user_count, query_count, item_count, vocab_size,
                     qw, qc, logs, graph_completeness=graph_completeness)


def make_synthetic_splits(seed: int = 0, **kw
                          ) -> Tuple[GraphData, EvalLogs, EvalLogs]:
    """(train ``GraphData``, valid ``EvalLogs``, test ``EvalLogs``): the
    valid and test logs are drawn from seeds ``seed + 1`` and ``seed + 2``
    over the same counts."""
    train = make_synthetic_data(seed=seed, **kw)
    counts = dict(user_count=train.user_count, query_count=train.query_count,
                  item_count=train.item_count, vocab_size=train.vocab_size)
    rest = {k: v for k, v in {**kw, **counts}.items() if k != "log_count"}
    valid_logs, _, _ = make_synthetic_logs(
        log_count=max(20, kw.get("log_count", 200) // 10), seed=seed + 1,
        **rest)
    test_logs, _, _ = make_synthetic_logs(
        log_count=max(20, kw.get("log_count", 200) // 5), seed=seed + 2,
        **rest)
    return train, EvalLogs(valid_logs), EvalLogs(test_logs)
