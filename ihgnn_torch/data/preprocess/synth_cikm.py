"""A CIKM-shaped dataset through the real preprocessing pipeline: the
quality set of ``PARITY.json``'s ``cikm`` runs.

    python -m ihgnn_torch.data.preprocess.synth_cikm --out DIR [--raw DIR]
        [--seed 3] [--users 800] [--products 2500] [--sessions 18]
        [--categories 40] [--graded_frac 0.3]

The port's own copy of ``tools/make_cikm_synth.py``, with the same files
byte for byte: ``write_raw_files`` writes raw CIKM Cup 2016 Track 2 files
(``products.csv``; ``train-queries.csv`` with query rows, category-browse
rows and two rows the parser skips; ``train-clicks.csv``), Step 1
(``cikm.step1_cikm``, category browses becoming single-token queries past
the vocabulary, the SearchLog.py:282-288 quirk) reads them, a share of the
clicked interactions is bumped to graded flags 2 or 3 (drawn from
``random.Random(seed + 1)``, so the reference's flag clamp and min/max
dedup run in training), and Step 3 (``onehot.step3_convert``, its split
drawn after ``random.seed(seed + 2)``) writes the artifacts.
"""

from __future__ import annotations

import argparse
import os
import random
import time
from typing import Dict, Optional, Tuple

import numpy as np

from ihgnn_torch.data.collections import SearchLogCollection
from ihgnn_torch.data.preprocess.cikm import step1_cikm
from ihgnn_torch.data.preprocess.onehot import step3_convert

CIKM_SET = dict(seed=3, users=800, products=2500, sessions=18,
                categories=40, graded_frac=0.3)


def write_raw_files(raw_dir: str, seed: int, users: int, products: int,
                    sessions_per_user: int, cat_count: int,
                    words_per_title: int = 4) -> Tuple[str, str, str]:
    """The raw files under ``raw_dir``; returns the paths of the queries,
    products and clicks files."""
    rng = np.random.default_rng(seed)
    os.makedirs(raw_dir, exist_ok=True)
    vocab_lo, vocab_hi = 100, 100 + 600          # item/query token id space

    products_path = os.path.join(raw_dir, "products.csv")
    with open(products_path, "w") as f:
        f.write("itemId;pricelog2;product.name.tokens\n")
        for i in range(products):
            tokens = ",".join(str(t) for t in rng.integers(
                vocab_lo, vocab_hi, words_per_title))
            f.write(f"P{i};{int(rng.integers(1, 12))};{tokens}\n")

    # popularity-skewed item draws (zipf-ish) so that N-core structure
    # emerges, and a shared query pool so that queries repeat across users
    pop = 1.0 / np.arange(1, products + 1) ** 0.8
    pop /= pop.sum()
    query_pool = [",".join(str(t) for t in rng.integers(
        vocab_lo, vocab_hi, int(rng.integers(1, 4))))
        for _ in range(max(50, users // 2))]

    queries_path = os.path.join(raw_dir, "train-queries.csv")
    clicks = []
    qid = 0
    with open(queries_path, "w") as f:
        f.write("queryId;sessionId;userId;timeframe;duration;eventdate;"
                "searchstring.tokens;categoryId;items;is.test\n")
        for u in range(users):
            for s in range(sessions_per_user):
                shown = rng.choice(products, size=5, replace=False, p=pop)
                items = ",".join(f"P{i}" for i in shown)
                date = f"2016-05-{(qid % 27) + 1:02d}"
                if s % 3 == 2:
                    cat = int(rng.integers(0, cat_count))
                    f.write(f"{qid};S{qid};U{u};{qid * 7};100;{date};"
                            f";{cat};{items};FALSE\n")
                else:
                    q = query_pool[int(rng.integers(0, len(query_pool)))]
                    f.write(f"{qid};S{qid};U{u};{qid * 7};100;{date};"
                            f"{q};;{items};FALSE\n")
                # 1-2 clicks a session on shown items
                for c in range(int(rng.integers(1, 3))):
                    clicks.append((qid, int(qid) * 13 + c,
                                   f"P{shown[int(rng.integers(0, 5))]}"))
                qid += 1
        # rows the parser must skip: a test row and an NA-user row
        f.write(f"{qid};S{qid};U0;5;100;2016-05-01;101,102;;P1,P2;TRUE\n")
        f.write(f"{qid + 1};S{qid + 1};NA;5;100;2016-05-01;101,102;;P1,P2;"
                f"FALSE\n")

    clicks_path = os.path.join(raw_dir, "train-clicks.csv")
    with open(clicks_path, "w") as f:
        f.write("queryId;timeframe;itemId\n")
        for q, t, it in clicks:
            f.write(f"{q};{t};{it}\n")
    return queries_path, products_path, clicks_path


def make_cikm_set(out_dir: str, raw_dir: Optional[str] = None,
                  seed: int = 3, users: int = 800, products: int = 2500,
                  sessions: int = 18, categories: int = 40,
                  graded_frac: float = 0.3) -> Dict[str, float]:
    """Raw files into ``raw_dir`` (default ``out_dir + "_raw"``), Steps 1
    and 3 into ``out_dir``; returns each part's host seconds and the
    number of bumped interactions. Raises ``ValueError`` if no graded flag
    reaches the train split."""
    raw_dir = raw_dir or out_dir + "_raw"
    times = {}
    t0 = time.perf_counter()
    paths = write_raw_files(raw_dir, seed, users, products, sessions,
                            categories)
    times["raw_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    inter = step1_cikm(*paths, with_category=True)
    times["step1_s"] = time.perf_counter() - t0

    rng = random.Random(seed + 1)
    bumped = 0
    for log in inter.logs:
        for i, flag in enumerate(log.interactions):
            if flag > 0 and rng.random() < graded_frac:
                log.interactions[i] = rng.choice((2, 3))
                bumped += 1
    print(f"bumped {bumped} clicked interactions to graded flags 2/3")

    random.seed(seed + 2)   # Step 3's fractional split draws
    t0 = time.perf_counter()
    step3_convert(inter, out_dir)
    times["step3_s"] = time.perf_counter() - t0
    with open(os.path.join(out_dir, "graph_info.txt")) as fh:
        print("graph_info:", fh.read().strip())
    train = SearchLogCollection.read(os.path.join(out_dir, "train_data.csv"))
    flags = {f for log in train for f in log.interactions}
    print(f"train flag values: {sorted(flags)}")
    if max(flags) <= 1:
        raise ValueError("no graded flag reached the Step-3 train split")
    return {**times, "bumped": bumped}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m ihgnn_torch.data.preprocess.synth_cikm")
    ap.add_argument("--out", required=True)
    ap.add_argument("--raw", default=None)
    ap.add_argument("--seed", type=int, default=CIKM_SET["seed"])
    ap.add_argument("--users", type=int, default=CIKM_SET["users"])
    ap.add_argument("--products", type=int, default=CIKM_SET["products"])
    ap.add_argument("--sessions", type=int, default=CIKM_SET["sessions"])
    ap.add_argument("--categories", type=int,
                    default=CIKM_SET["categories"])
    ap.add_argument("--graded_frac", type=float,
                    default=CIKM_SET["graded_frac"],
                    help="share of clicked interactions bumped to flag 2/3")
    a = ap.parse_args(argv)
    make_cikm_set(a.out, a.raw, a.seed, a.users, a.products, a.sessions,
                  a.categories, a.graded_frac)


if __name__ == "__main__":
    main()
