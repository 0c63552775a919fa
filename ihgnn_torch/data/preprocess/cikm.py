"""Step 1 (CIKM Cup 2016 Track 2): raw query/click logs → intermediate dir.

Counterpart of ``ihgnn_tpu/data/preprocess/cikm.py``, writing the same
files byte for byte.

Mirrors PreProcess/Step1-CikmCup2016Track2.py: parses products.csv (title
segments → item vocab), train-queries.csv in query mode (and optionally
category mode), joins train-clicks.csv to set interaction flags and times,
and rewrites category browses as single-token queries whose token id is
offset past the existing vocabulary (Helpers/SearchLog.py:282-288).

CLI: python -m ihgnn_torch.data.preprocess.cikm --queries train-queries.csv \
       --products products.csv --clicks train-clicks.csv --result out/ \
       [--no_category]
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Set, Tuple

from ihgnn_torch.data.collections import RawSearchLogCollection
from ihgnn_torch.data.preprocess.intermediate import IntermediateData
from ihgnn_torch.data.preprocess.text import reverse_lookup
from ihgnn_torch.data.schema import CikmSearchLog
from ihgnn_torch.utils.logging import log_print


def step1_cikm(queries_path: str, products_path: str, clicks_path: str,
               with_category: bool = True) -> IntermediateData:
    raw_item_ids: List[str] = []
    raw_item_titles: List[str] = []
    vocabulary_item: Set[str] = set()

    log_print(f"reading {products_path}...")
    with open(products_path, "r", encoding="utf-8") as f:
        f.readline()
        for line in f:
            item_id, _price, title = line.strip().split(";")
            tokens = title.split(",")
            raw_item_ids.append(item_id)
            raw_item_titles.append(" ".join(tokens))
            vocabulary_item.update(tokens)
    raw_item_rdict = reverse_lookup(raw_item_ids)
    log_print(f"{len(raw_item_ids)} products")

    cikm_logs: List[CikmSearchLog] = []
    vocabulary_query: Set[str] = set()
    user_ids: Set[str] = set()
    item_ids: Set[str] = set()
    queries: Set[str] = set()

    log_print(f"reading {queries_path} (query rows)...")
    with open(queries_path, "r", encoding="utf-8") as f:
        f.readline()
        for line in f:
            log = CikmSearchLog.from_cikm_line(line, category_mode=False)
            if log is None:
                continue
            cikm_logs.append(log)
            vocabulary_query.update(log.query_segment)
            user_ids.add(log.user_id)
            item_ids.update(log.item_ids)
            queries.add(log.query_str)

    if with_category:
        log_print(f"reading {queries_path} (category rows)...")
        with open(queries_path, "r", encoding="utf-8") as f:
            f.readline()
            for line in f:
                log = CikmSearchLog.from_cikm_line(line, category_mode=True)
                if log is None:
                    continue
                cikm_logs.append(log)
                user_ids.add(log.user_id)
                item_ids.update(log.item_ids)

    # sorted: set iteration order is hash-randomized across runs; the
    # query/item index assignment must be reproducible (amazon.py sorts too)
    queries = sorted(queries)
    item_ids = sorted(item_ids)
    item_titles = [raw_item_titles[raw_item_rdict[i]] for i in item_ids]

    log_print(f"reading {clicks_path}...")
    click_tuples: List[Tuple[str, str, str]] = []
    with open(clicks_path, "r", encoding="utf-8") as f:
        f.readline()
        for line in f:
            query_id, timeframe, item_id = line.strip().split(";")
            click_tuples.append((query_id, item_id,
                                 "0000-00-00" + timeframe.rjust(15, "0")))

    by_search_id: Dict[str, CikmSearchLog] = {}
    for log in cikm_logs:
        assert log.search_id not in by_search_id
        by_search_id[log.search_id] = log

    click_count = 0
    for query_id, item_id, itime in click_tuples:
        log = by_search_id.get(query_id)
        if log is None:
            continue
        try:
            i = log.item_ids.index(item_id)
        except ValueError:
            continue
        if log.item_interactions[i] == 0:
            log.item_interactions[i] = 1
            log.item_times[i] = itime
            click_count += 1
    log_print(f"{click_count} valid clicks applied")

    if with_category:
        # rewrite category browses as single-token queries past the vocab
        vocabulary = vocabulary_item | vocabulary_query
        max_token = 1 + max(map(int, vocabulary))
        new_vocab: Set[str] = set()
        for log in cikm_logs:
            if not log.is_query:
                log.to_query(max_token)
                new_vocab.add(log.query_str)
        vocabulary_query.update(new_vocab)
        queries.extend(sorted(new_vocab))

    logs = RawSearchLogCollection(log.to_raw_search_log() for log in cikm_logs)
    return IntermediateData(
        user_ids=sorted(user_ids),
        item_ids=item_ids,
        item_title_segments=item_titles,
        queries=queries,
        # CIKM query strings already are their own token segments
        query_segments=queries,
        vocabulary_item=sorted(vocabulary_item),
        vocabulary_query=sorted(vocabulary_query),
        logs=logs,
    )


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--queries", required=True)
    p.add_argument("--products", required=True)
    p.add_argument("--clicks", required=True)
    p.add_argument("--result", required=True)
    p.add_argument("--no_category", action="store_true", default=False)
    a = p.parse_args(argv)
    data = step1_cikm(a.queries, a.products, a.clicks,
                      with_category=not a.no_category)
    data.write(a.result)
    log_print(f"{len(data.logs)} raw search logs written to {a.result}")


if __name__ == "__main__":
    main()
