"""Step 2: N-core subsetting of an intermediate dataset.

Counterpart of ``ihgnn_tpu/data/preprocess/subset.py``, writing the same
files byte for byte.

Mirrors PreProcess/Step2-GenerateSubset.py: drop items with fewer than
``n_core_item`` positive interactions (then logs emptied by that filter),
drop users with fewer than ``n_core_user`` positives (or randomly sample
``rand_user`` users), then rebuild consistent query/item/vocabulary subsets.

CLI: python -m ihgnn_torch.data.preprocess.subset --source in/ --result out/ \
       [--nitem 5] [--nuser 5 | --rand_user 20000]
"""

from __future__ import annotations

import argparse
import random
from typing import Dict, List, Set

from ihgnn_torch.data.collections import RawSearchLogCollection
from ihgnn_torch.data.preprocess.intermediate import IntermediateData
from ihgnn_torch.data.preprocess.text import reverse_lookup
from ihgnn_torch.utils.logging import log_print


def step2_subset(data: IntermediateData,
                 n_core_item: int = 0,
                 n_core_user: int = 0,
                 rand_user: int = 0) -> IntermediateData:
    if n_core_user and rand_user:
        raise ValueError("nuser and rand_user are mutually exclusive")
    logs = data.logs

    item_subset: Set[str] = set()
    user_subset: Set[str] = set()

    if n_core_item:
        log_print(f"item {n_core_item}-core filter...")
        counts: Dict[str, int] = {i: 0 for i in data.item_ids}
        for log in logs:
            for iid, flag in zip(log.item_ids, log.interactions):
                if flag > 0:
                    counts[iid] += 1
        item_subset = {i for i, c in counts.items() if c >= n_core_item}
        kept = RawSearchLogCollection()
        for log in logs:
            sub = log.subset(item_subset)
            if len(sub.item_ids) > 0:
                kept.append(sub)
        logs = kept
        log_print(f"{len(item_subset)} items kept; {len(logs)} logs remain")

    if n_core_user:
        log_print(f"user {n_core_user}-core filter...")
        ucounts: Dict[str, int] = {u: 0 for u in data.user_ids}
        for log in logs:
            ucounts[log.user_id] += sum(1 for f in log.interactions if f > 0)
        user_subset = {u for u, c in ucounts.items() if c >= n_core_user}
    elif rand_user:
        log_print(f"sampling {rand_user} random users...")
        user_subset = set(random.sample(data.user_ids, rand_user))

    if n_core_user or rand_user:
        kept = RawSearchLogCollection()
        for log in logs:
            if log.user_id in user_subset:
                kept.append(log)
        logs = kept
        log_print(f"{len(user_subset)} users kept; {len(logs)} logs remain")

    # rebuild consistent subsets from the surviving logs
    # (Step2-GenerateSubset.py:167-203)
    query_rdict = reverse_lookup(data.queries)
    item_rdict = reverse_lookup(data.item_ids)

    if n_core_user or rand_user or not n_core_item:
        item_subset = set()
    query_seg_subset: Dict[str, str] = {}
    vocab_query_subset: Set[str] = set()
    for log in logs:
        if n_core_user or rand_user or not n_core_item:
            item_subset.update(log.item_ids)
        if not (n_core_user or rand_user):
            user_subset.add(log.user_id)
        if log.query not in query_seg_subset:
            seg = data.query_segments[query_rdict[log.query]]
            query_seg_subset[log.query] = seg
            vocab_query_subset.update(seg.split())

    item_ids = sorted(item_subset)
    item_titles: List[str] = []
    vocab_item_subset: Set[str] = set()
    for iid in item_ids:
        seg = data.item_title_segments[item_rdict[iid]]
        item_titles.append(seg)
        vocab_item_subset.update(seg.split())

    return IntermediateData(
        user_ids=sorted(user_subset),
        item_ids=item_ids,
        item_title_segments=item_titles,
        queries=list(query_seg_subset.keys()),
        query_segments=list(query_seg_subset.values()),
        vocabulary_item=sorted(vocab_item_subset),
        vocabulary_query=sorted(vocab_query_subset),
        logs=logs,
    )


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--source", required=True)
    p.add_argument("--result", required=True)
    p.add_argument("--nitem", type=int, default=0)
    p.add_argument("--nuser", type=int, default=0)
    p.add_argument("--rand_user", type=int, default=0)
    a = p.parse_args(argv)
    assert a.source != a.result, "source and result must differ"
    data = IntermediateData.read(a.source)
    out = step2_subset(data, a.nitem, a.nuser, a.rand_user)
    out.write(a.result)
    log_print(f"subset written to {a.result}: {len(out.logs)} logs")


if __name__ == "__main__":
    main()
