"""Intermediate artifact directory shared between preprocessing steps.

Counterpart of ``ihgnn_tpu/data/preprocess/intermediate.py``, writing
the same files byte for byte.

Layout (written by Step 1, filtered by Step 2, consumed by Step 3 — see
the reference's PreProcess/ scripts):

  user_ids.txt              one user id per line
  item_ids.txt              one item id per line
  item_title_segments.txt   space-joined title tokens, row-aligned to items
  queries.txt               one query string per line
  query_segments.txt        space-joined query tokens, row-aligned
  vocabulary_item.txt       item-title token vocabulary
  vocabulary_query.txt      query token vocabulary
  search_logs_raw.csv       RawSearchLog TSV
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterable, List

from ihgnn_torch.data.collections import RawSearchLogCollection


def write_lines(path: str, lines: Iterable[str]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for line in lines:
            f.write(str(line) + "\n")


def read_lines(path: str) -> List[str]:
    with open(path, "r", encoding="utf-8") as f:
        return [line.rstrip("\n") for line in f]


@dataclasses.dataclass
class IntermediateData:
    user_ids: List[str]
    item_ids: List[str]
    item_title_segments: List[str]
    queries: List[str]
    query_segments: List[str]
    vocabulary_item: List[str]
    vocabulary_query: List[str]
    logs: RawSearchLogCollection

    def write(self, result_dir: str) -> None:
        os.makedirs(result_dir, exist_ok=True)
        write_lines(os.path.join(result_dir, "user_ids.txt"), self.user_ids)
        write_lines(os.path.join(result_dir, "item_ids.txt"), self.item_ids)
        write_lines(os.path.join(result_dir, "item_title_segments.txt"),
                    self.item_title_segments)
        write_lines(os.path.join(result_dir, "queries.txt"), self.queries)
        write_lines(os.path.join(result_dir, "query_segments.txt"),
                    self.query_segments)
        write_lines(os.path.join(result_dir, "vocabulary_item.txt"),
                    self.vocabulary_item)
        write_lines(os.path.join(result_dir, "vocabulary_query.txt"),
                    self.vocabulary_query)
        self.logs.write(os.path.join(result_dir, "search_logs_raw.csv"))

    @classmethod
    def read(cls, source_dir: str) -> "IntermediateData":
        j = lambda n: os.path.join(source_dir, n)
        return cls(
            user_ids=read_lines(j("user_ids.txt")),
            item_ids=read_lines(j("item_ids.txt")),
            item_title_segments=read_lines(j("item_title_segments.txt")),
            queries=read_lines(j("queries.txt")),
            query_segments=read_lines(j("query_segments.txt")),
            vocabulary_item=read_lines(j("vocabulary_item.txt")),
            vocabulary_query=read_lines(j("vocabulary_query.txt")),
            logs=RawSearchLogCollection.read(j("search_logs_raw.csv")),
        )
