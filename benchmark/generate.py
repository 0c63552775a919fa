"""The general traffic generator: a cell's inputs from its seed.

A traffic mix is a JSON file of parameters (``benchmark/traffic/``); the
configuration gives the deployment's sizes. Every draw comes from
``numpy.random.SeedSequence(seed)``, one stream per kind of input, so one
seed gives the same inputs whatever else a run draws, and every seed
gives the same sizes.

* ``interactions``: the graph's positive (u, q, i) rows. Each column is
  ``uniform`` or ``{"zipf": α}``: each popularity rank takes its Zipf
  share of the rows exactly, and the ranks lie on ids drawn from the
  seed, so every seed has the same hubs (and the same step time) at other
  ids.
* ``query_words``: each query's words, table rows 1..V.
* ``train_batches``: ``batch_positives`` rows a batch, taken in a shuffled
  order of the graph's rows (each epoch a new order, whole batches only),
  each with ``random_negatives`` uniform items, distinct within the row
  (the draw of ``TrainSampler``).
* ``premade``: the first ``premade_batches`` of a stream of batches,
  drawn in set-up, then handed out again in that order, so that the
  feed's thread takes no time of the host while the window runs.
* ``eval_logs``: ``logs`` (user, query) pairs, uniform, each with 1 to
  ``truth_max`` distinct truth items, padded to batches of
  ``batch_logs``. With probability ``truth_top_share`` a log's first truth
  item is one of ``top_items`` (the catalog's best-scored items, which the
  caller gives), the rest uniform: with random weights the model ranks no
  uniform item near the top, and these give the metric rows hits to
  rank.
"""

from __future__ import annotations

import itertools
from typing import Iterator, Optional

import numpy as np

STREAMS = ("interactions", "words", "batches", "logs", "sample")


def streams(seed: int) -> dict:
    """One ``numpy`` generator per kind of input."""
    kids = np.random.SeedSequence(int(seed)).spawn(len(STREAMS))
    return {name: np.random.default_rng(k) for name, k in zip(STREAMS, kids)}


def _column(rng: np.random.Generator, n: int, size: int, dist) -> np.ndarray:
    if dist == "uniform":
        return rng.integers(0, n, size)
    # Zipf: popularity rank k takes round(size · p_k) of the rows (largest
    # remainders), so every seed has the same degree sequence; the seed
    # lays the ranks on the ids and shuffles the rows
    alpha = float(dist["zipf"])
    p = np.arange(1, n + 1, dtype=np.float64) ** -alpha
    share = p / p.sum() * size
    counts = np.floor(share).astype(np.int64)
    counts[np.argsort(counts - share)[:size - counts.sum()]] += 1
    ids = np.repeat(rng.permutation(n), counts)
    return ids[rng.permutation(size)]


def interactions(sizes: dict, traffic: dict, rng: np.random.Generator
                 ) -> np.ndarray:
    """``[E, 3]`` int32 (u, q, i) entity ids."""
    dist = traffic.get("interactions", {})
    e = sizes["interactions"]
    cols = [_column(rng, sizes[kind], e, dist.get(kind, "uniform"))
            for kind in ("users", "queries", "items")]
    return np.stack(cols, axis=1).astype(np.int32)


def query_words(sizes: dict, rng: np.random.Generator):
    """``([Q, W] int32 word rows in 1..V, [Q] int32 counts)``: every query
    has ``words_per_query`` words."""
    q, w = sizes["queries"], sizes["words_per_query"]
    words = rng.integers(1, sizes["vocab"] + 1, (q, w)).astype(np.int32)
    return words, np.full(q, w, np.int32)


def _distinct_rows(rng, draw: np.ndarray, n: int, valid=None) -> np.ndarray:
    """Redraw (uniform over ``n``) the rows of ``draw`` that hold a
    repeated id among their first ``valid[r]`` entries."""
    k = draw.shape[1]
    if k < 2:
        return draw
    while True:
        srt = np.sort(np.where(
            np.arange(k) < (k if valid is None else valid[:, None]),
            draw, -1 - np.arange(k)), axis=1)
        bad = np.nonzero((np.diff(srt, axis=1) == 0).any(axis=1))[0]
        if len(bad) == 0:
            return draw
        draw[bad] = rng.integers(0, n, (len(bad), k))


def train_batches(uqi: np.ndarray, sizes: dict, traffic: dict,
                  rng: np.random.Generator,
                  stop=None) -> Iterator[dict]:
    """Endless batches of host arrays ``users``, ``queries``, ``items``
    (int32), ``flags``, ``weight`` (float32), ``[B·(1 + k)]`` rows: B
    positives, then each positive's k negatives. Ends once ``stop`` (a
    ``threading.Event``) is set."""
    b = traffic["batch_positives"]
    k = traffic["random_negatives"]
    items = sizes["items"]
    rows = b * (1 + k)
    while True:
        order = rng.permutation(len(uqi))
        for start in range(0, len(uqi) - b + 1, b):
            if stop is not None and stop.is_set():
                return
            pos = uqi[order[start:start + b]]
            negs = _distinct_rows(rng, rng.integers(0, items, (b, k)), items)
            flags = np.zeros(rows, np.float32)
            flags[:b] = 1.0
            yield {"users": np.concatenate([pos[:, 0],
                                            np.repeat(pos[:, 0], k)]),
                   "queries": np.concatenate([pos[:, 1],
                                              np.repeat(pos[:, 1], k)]),
                   "items": np.concatenate([pos[:, 2], negs.reshape(-1)]
                                           ).astype(np.int32),
                   "flags": flags, "weight": np.ones(rows, np.float32)}


def premade(batches: Iterator[dict], count: int, stop=None
            ) -> Iterator[dict]:
    """The first ``count`` of ``batches``, drawn now, then yielded in
    that order again and again until ``stop`` (a ``threading.Event``) is
    set."""
    made = list(itertools.islice(batches, count))

    def replay():
        while True:
            for b in made:
                if stop is not None and stop.is_set():
                    return
                yield b
    return replay()


def eval_logs(sizes: dict, traffic: dict, rng: np.random.Generator,
              top_items: Optional[np.ndarray] = None) -> dict:
    """The test epoch as batches: ``users``, ``queries`` ``[n, B]``,
    ``truth`` ``[n, B, T]`` (-1 pads), ``counts`` ``[n, B]``, ``weight``
    ``[n, B]`` (0 on the last batch's padding), and ``logs``."""
    logs, bsz = traffic["logs"], traffic["batch_logs"]
    tmax, items = traffic["truth_max"], sizes["items"]
    users = rng.integers(0, sizes["users"], logs)
    queries = rng.integers(0, sizes["queries"], logs)
    counts = rng.integers(1, tmax + 1, logs)
    truth = rng.integers(0, items, (logs, tmax))
    if top_items is not None and len(top_items):
        pick = rng.random(logs) < traffic["truth_top_share"]
        truth[pick, 0] = rng.choice(top_items, int(pick.sum()))
    truth = _distinct_rows(rng, truth, items, counts)
    truth[np.arange(tmax)[None, :] >= counts[:, None]] = -1
    n = -(-logs // bsz)
    pad = n * bsz - logs

    def padded(a, fill):
        return np.concatenate([a, np.full((pad,) + a.shape[1:], fill,
                                          a.dtype)]).reshape(
            (n, bsz) + a.shape[1:])

    return {"users": padded(users.astype(np.int32), 0),
            "queries": padded(queries.astype(np.int32), 0),
            "truth": padded(truth.astype(np.int32), -1),
            "counts": padded(counts.astype(np.int32), 0),
            "weight": padded(np.ones(logs, np.float32), 0),
            "logs": logs}
