"""Step 3: intermediate dataset → final integer-encoded training artifacts.

Counterpart of ``ihgnn_tpu/data/preprocess/onehot.py``, writing the same
files byte for byte.

Mirrors PreProcess/Step3-ConvertToOnehot.py: sort logs per user by time,
split ~0.7/0.1/0.2 (or via presplit search-id files), write the
reproducibility files ``search_ids_{train,valid,test}.txt``, map string ids
to integer indices, and emit the artifact directory the trainer consumes
(train/valid/test_data.csv, vocabulary.txt, item_titles_multihot.txt,
queries_multihot.txt, graph_info.txt).

The combined vocabulary is the union of item and query vocabularies; we
sort it (the reference leaves python-set order — an arbitrary but fixed
permutation; sorting is the reproducible choice and only permutes word
indices).

CLI: python -m ihgnn_torch.data.preprocess.onehot --source in/ --result out/ \
       [--split '0.7,0.1,0.2'] [--presplit dir/] [--no_reserve]
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional, Set

from ihgnn_torch.data.preprocess.intermediate import IntermediateData, write_lines
from ihgnn_torch.data.preprocess.text import reverse_lookup
from ihgnn_torch.utils.logging import log_print


def _read_id_set(path: str) -> Set[str]:
    with open(path, "r", encoding="utf-8") as f:
        return {line.strip() for line in f}


def step3_convert(data: IntermediateData, result_dir: str,
                  split_ratios=(0.7, 0.1, 0.2),
                  presplit_dir: Optional[str] = None,
                  reserve_at_least_one_in_train: bool = True) -> None:
    os.makedirs(result_dir, exist_ok=True)

    vocabulary = sorted(set(data.vocabulary_item) | set(data.vocabulary_query))
    user_rdict = reverse_lookup(data.user_ids)
    query_rdict = reverse_lookup(data.queries)
    item_rdict = reverse_lookup(data.item_ids)
    vocab_rdict = reverse_lookup(vocabulary)

    data.logs.sort_by_user_and_time()

    presplit = None
    if presplit_dir:
        presplit = [
            _read_id_set(os.path.join(presplit_dir, "search_ids_train.txt")),
            _read_id_set(os.path.join(presplit_dir, "search_ids_valid.txt")),
            _read_id_set(os.path.join(presplit_dir, "search_ids_test.txt")),
        ]
        log_print(f"using presplit ids from {presplit_dir}")
    else:
        log_print(f"split ratios {split_ratios}, reserve>=1 in train: "
                  f"{reserve_at_least_one_in_train}")

    train_raw, valid_raw, test_raw = data.logs.split_to_train_valid_test(
        *split_ratios, presplit_search_ids=presplit,
        reserve_at_least_one_in_train=reserve_at_least_one_in_train)
    total = len(data.logs)
    log_print(f"split {total} logs -> {len(train_raw)}/{len(valid_raw)}/"
              f"{len(test_raw)} "
              f"({len(train_raw)/total:.3f}/{len(valid_raw)/total:.3f}/"
              f"{len(test_raw)/total:.3f})")

    train_raw.write_search_ids(os.path.join(result_dir, "search_ids_train.txt"))
    valid_raw.write_search_ids(os.path.join(result_dir, "search_ids_valid.txt"))
    test_raw.write_search_ids(os.path.join(result_dir, "search_ids_test.txt"))

    train = train_raw.to_onehot(user_rdict, item_rdict, query_rdict)
    valid = valid_raw.to_onehot(user_rdict, item_rdict, query_rdict)
    test = test_raw.to_onehot(user_rdict, item_rdict, query_rdict)

    pos = sum(sum(1 for f in log.interactions if f > 0) for log in train)
    neg = sum(sum(1 for f in log.interactions if f <= 0) for log in train)
    log_print(f"train positives {pos}, negatives {neg} "
              f"({neg / max(pos, 1):.4f} neg per pos)")

    train.write(os.path.join(result_dir, "train_data.csv"))
    valid.write(os.path.join(result_dir, "valid_data.csv"))
    test.write(os.path.join(result_dir, "test_data.csv"))

    write_lines(os.path.join(result_dir, "vocabulary.txt"), vocabulary)

    def multihot_rows(segments: List[str]) -> List[str]:
        return [" ".join(str(vocab_rdict[w]) for w in seg.split())
                for seg in segments]

    write_lines(os.path.join(result_dir, "item_titles_multihot.txt"),
                multihot_rows(data.item_title_segments))
    write_lines(os.path.join(result_dir, "queries_multihot.txt"),
                multihot_rows(data.query_segments))

    with open(os.path.join(result_dir, "graph_info.txt"), "w",
              encoding="utf-8") as f:
        f.write(f"{len(data.user_ids)} {len(data.queries)} "
                f"{len(data.item_ids)} {len(vocabulary)}")
    log_print(f"artifacts written to {result_dir}: U={len(data.user_ids)} "
              f"Q={len(data.queries)} I={len(data.item_ids)} "
              f"V={len(vocabulary)}")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--source", required=True)
    p.add_argument("--result", required=True)
    p.add_argument("--split", default="",
                   help="e.g. '0.7,0.1' or '0.7,0.1,0.2'")
    p.add_argument("--presplit", default="")
    p.add_argument("--no_reserve", action="store_true", default=False)
    a = p.parse_args(argv)
    assert a.source != a.result, "source and result must differ"
    ratios = (0.7, 0.1, 0.2)
    if a.split:
        parts = [float(r.strip()) for r in a.split.split(",")]
        if len(parts) == 2:
            parts.append(1 - sum(parts))
        ratios = tuple(parts)
    data = IntermediateData.read(a.source)
    step3_convert(data, a.result, ratios, a.presplit or None,
                  reserve_at_least_one_in_train=not a.no_reserve)


if __name__ == "__main__":
    main()
