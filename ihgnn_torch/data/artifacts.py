"""Writing the Step-3 artifact directory that training reads.

Counterpart of ``ihgnn_tpu/data/artifacts.py``; the files are byte for
byte the JAX package's. The layout (the reference's
PreProcess/Step3-ConvertToOnehot.py:136-158):

  graph_info.txt            one line: "<users> <queries> <items> <vocab>"
  queries_multihot.txt      a row per query: space-separated word indices
  train/valid/test_data.csv SearchLog CSV (``schema.SearchLog`` format)
  vocabulary.txt            one word per line (optional for training)
  item_titles_multihot.txt  a row per item: word indices (optional)
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

from ihgnn_torch.data.collections import SearchLogCollection
from ihgnn_torch.data.synthetic import make_synthetic_logs


def write_graph_info(data_dir: str, user_count: int, query_count: int,
                     item_count: int, vocab_size: int) -> None:
    with open(os.path.join(data_dir, "graph_info.txt"), "w",
              encoding="utf-8") as f:
        f.write(f"{user_count} {query_count} {item_count} {vocab_size}\n")


def write_multihot(path: str, rows: Sequence[Sequence[int]]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for row in rows:
            f.write(" ".join(str(w) for w in row) + "\n")


def write_lines(path: str, lines: Sequence[str]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for line in lines:
            f.write(str(line) + "\n")


def write_split_artifacts(data_dir: str,
                          train: SearchLogCollection,
                          valid: SearchLogCollection,
                          test: SearchLogCollection,
                          user_count: int, query_count: int, item_count: int,
                          vocab_size: int,
                          query_words: Sequence[Sequence[int]],
                          vocabulary: Optional[Sequence[str]] = None,
                          item_titles: Optional[Sequence[Sequence[int]]] = None
                          ) -> None:
    """Write the whole artifact directory. ``query_words`` rows are raw
    word indices (not index + 1)."""
    os.makedirs(data_dir, exist_ok=True)
    write_graph_info(data_dir, user_count, query_count, item_count,
                     vocab_size)
    write_multihot(os.path.join(data_dir, "queries_multihot.txt"),
                   query_words)
    train.write(os.path.join(data_dir, "train_data.csv"))
    valid.write(os.path.join(data_dir, "valid_data.csv"))
    test.write(os.path.join(data_dir, "test_data.csv"))
    if vocabulary is not None:
        write_lines(os.path.join(data_dir, "vocabulary.txt"), vocabulary)
    if item_titles is not None:
        write_multihot(os.path.join(data_dir, "item_titles_multihot.txt"),
                       item_titles)


def write_synthetic_dataset(data_dir: str, seed: int = 0, **kw) -> None:
    """Generate (``make_synthetic_logs(seed=seed, **kw)``) and write a
    whole synthetic dataset directory, split per user in time order: the
    first 70 % of a user's logs (at least one) train, the last 20 % test,
    the rest valid."""
    logs, query_words, _ = make_synthetic_logs(seed=seed, **kw)
    by_user: Dict[int, List] = {}
    for log in logs:
        by_user.setdefault(log.user, []).append(log)
    train, valid, test = (SearchLogCollection(), SearchLogCollection(),
                          SearchLogCollection())
    for ulogs in by_user.values():
        ulogs.sort(key=lambda log: log.search_time)
        m = len(ulogs)
        n_train = max(int(m * 0.7), 1)
        n_test = int(m * 0.2)
        for log in ulogs[:n_train]:
            train.append(log)
        for log in ulogs[n_train:m - n_test]:
            valid.append(log)
        for log in ulogs[m - n_test:]:
            test.append(log)

    # the query rows hold word index + 1; the artifact holds the index
    rows = [[int(w) - 1 for w in row if w > 0] for row in query_words]
    vocab_size = kw.get("vocab_size", 40)
    write_split_artifacts(data_dir, train, valid, test,
                          kw.get("user_count", 30), kw.get("query_count", 20),
                          kw.get("item_count", 50), vocab_size, rows,
                          vocabulary=[f"word{i}" for i in range(vocab_size)])
