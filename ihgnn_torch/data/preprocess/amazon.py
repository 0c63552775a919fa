"""Step 1 (Amazon): product metadata + 5-core reviews → intermediate dir.

Counterpart of ``ihgnn_tpu/data/preprocess/amazon.py``, writing the same
files byte for byte.

Mirrors PreProcess/Step1-Amazon.py: queries are the preprocessed category
paths of items; each review becomes one single-item search log per query of
the reviewed item, with interaction=1 at the review time. Reviews whose
item is missing from the metadata are dropped (Step1-Amazon.py:91-96).

CLI: python -m ihgnn_torch.data.preprocess.amazon --item meta.json \
       --search reviews.json --result out_dir/
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Set, Tuple

from ihgnn_torch.data.collections import RawSearchLogCollection
from ihgnn_torch.data.preprocess.intermediate import IntermediateData
from ihgnn_torch.data.preprocess.text import TextPreprocessor, iter_json_lines
from ihgnn_torch.data.schema import RawSearchLog
from ihgnn_torch.utils.logging import log_print


def step1_amazon(item_path: str, search_path: str) -> IntermediateData:
    text = TextPreprocessor()

    item_ids: Set[str] = set()
    queries: Set[str] = set()
    vocabulary_query: Set[str] = set()
    item_queries: Dict[str, Set[str]] = {}

    log_print(f"processing item metadata: {item_path}")
    for index, rec in enumerate(iter_json_lines(item_path)):
        if index and index % 50000 == 0:
            log_print(f"  row {index}...")
        item_id = rec["asin"]
        categories = rec.get("category") or rec.get("categories") or []
        if isinstance(categories, list) and categories and isinstance(categories[0], list):
            categories = categories[0]  # some dumps nest category paths
        if not categories:
            continue
        cat_strs = [" ".join(text.preprocess(str(c))) for c in categories]
        query = " ".join(cat_strs)
        words = [w for c in cat_strs for w in c.split(" ") if w]
        if not words:
            continue
        item_ids.add(item_id)
        queries.add(query)
        vocabulary_query.update(words)
        item_queries.setdefault(item_id, set()).add(query)

    log_print(f"processing reviews: {search_path}")
    user_ids: Set[str] = set()
    item_ids_useful: Set[str] = set()
    user_items_times: Dict[str, List[Tuple[str, str]]] = {}
    review_count = invalid = 0
    for index, rec in enumerate(iter_json_lines(search_path)):
        if index and index % 100000 == 0:
            log_print(f"  row {index}...")
        review_count += 1
        item_id = rec["asin"]
        if item_id not in item_ids:
            invalid += 1
            continue
        item_ids_useful.add(item_id)
        user_id = rec["reviewerID"]
        user_ids.add(user_id)
        user_items_times.setdefault(user_id, []).append(
            (item_id, str(rec["unixReviewTime"])))

    log_print(f"{review_count} reviews, {invalid} with unknown item ids; "
              f"{len(user_ids)} users, {len(queries)} queries, "
              f"{len(item_ids_useful)} interacted items")

    # one single-item log per (user, review, query-of-item)
    logs = RawSearchLogCollection()
    search_id = 0
    for user_id, pairs in user_items_times.items():
        for item_id, review_time in pairs:
            for query in sorted(item_queries[item_id]):
                log = RawSearchLog(str(search_id), user_id, query, review_time)
                log.add_item(item_id, 1, 1, 1, review_time)
                logs.append(log)
                search_id += 1

    queries_list = sorted(queries)
    return IntermediateData(
        user_ids=sorted(user_ids),
        item_ids=sorted(item_ids_useful),
        # Amazon items carry no titles; a single placeholder token keeps the
        # item-title channel shape-compatible (Step1-Amazon.py:115,123)
        item_title_segments=["<span"] * len(item_ids_useful),
        queries=queries_list,
        query_segments=queries_list,
        vocabulary_item=["<span"],
        vocabulary_query=sorted(vocabulary_query),
        logs=logs,
    )


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--item", required=True, help="item metadata json(.gz)")
    p.add_argument("--search", required=True, help="5-core reviews json(.gz)")
    p.add_argument("--result", required=True, help="output directory")
    a = p.parse_args(argv)
    data = step1_amazon(a.item, a.search)
    data.write(a.result)
    log_print(f"{len(data.logs)} raw search logs written to {a.result}")


if __name__ == "__main__":
    main()
