"""Full-catalog evaluation: the serving path.

Counterpart of ``ihgnn_tpu/train/eval.py`` (reference:
TrainTestHelper.py:37-102):

1. ``features_fn`` — one full-graph forward, reused for the whole eval
   (the ``save_features_for_test`` protocol, RawGnn.py:147-155).
2. ``metrics_fn``  — B logs at a time: ``[B, I]`` catalog scores with one
   matmul, top-10, and the HR/NDCG/MAP/MRR rows.

The host only sums the rows of real (unpadded) logs.
"""

from __future__ import annotations

import itertools
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ihgnn_torch.data.dataset import EvalLogs
from ihgnn_torch.device import DeviceLike, model_device
from ihgnn_torch.graph import AnyGraph
from ihgnn_torch.models.embedding import make_word_bag
from ihgnn_torch.models.rawgnn import RawGnn
from ihgnn_torch.parallel.mesh import Mesh
from ihgnn_torch.parallel.sharding import shard_bag
from ihgnn_torch.train.metrics import Metrics, ranking_metrics
from ihgnn_torch.utils.tracing import span


def make_eval_fns(model: RawGnn, graph: AnyGraph, query_words,
                  query_word_counts, device: DeviceLike = "cuda",
                  mesh: Optional[Mesh] = None
                  ) -> Tuple[Callable[[], torch.Tensor], Callable]:
    """``(features_fn, metrics_fn)`` on ``device``; the model must already
    be there (``model.to(device)``).

    ``features_fn()`` is the ``[N, d·(1+L)]`` full-graph forward; with
    ``mesh``, on a rank's slice of the graph (``shard_graph``), whose node
    sums every layer combines: every rank calls it, and every rank gets
    the same features.
    ``metrics_fn(features, users, queries, truth, truth_counts)`` takes
    host arrays of one eval batch and returns its ``[B, 4]`` metric rows
    on ``device``."""
    dev = model_device(model, device)
    if graph.node_count != (model.user_count + model.query_count
                            + model.item_count):
        raise ValueError(f"the graph has {graph.node_count} nodes; the model "
                         "has users + queries + items = "
                         f"{model.user_count + model.query_count + model.item_count}")
    words = np.asarray(query_words)
    vocab_rows = model.embeddings.rows["vocab_table"]
    if len(words) != model.query_count or (words.size and (
            words.min() < 0 or words.max() >= vocab_rows)):
        raise ValueError(f"query_words must be [{model.query_count}, L] "
                         f"word rows in [0, {vocab_rows})")
    graph = graph.to(dev)
    bag = (make_word_bag(words, query_word_counts, vocab_rows)
           if mesh is None else
           shard_bag(words, query_word_counts, vocab_rows, mesh)).to(dev)

    def features_fn() -> torch.Tensor:
        with torch.inference_mode(), span("eval.refresh"):
            return model.all_features(graph, bag)

    def put(a):
        return torch.as_tensor(np.asarray(a)).to(dev)

    batches = itertools.count()

    def metrics_fn(features, users, queries, truth, truth_counts):
        with torch.inference_mode(), span("eval.batch", next(batches)):
            with span("eval.put"):
                users, queries = put(users), put(queries)
            with span("eval.score"):
                scores = model.score_all_items(features, users, queries)
            # a pageable copy waits for the stream, here for the scores
            with span("eval.put"):
                truth, truth_counts = put(truth), put(truth_counts)
            return ranking_metrics(scores, truth, truth_counts)

    return features_fn, metrics_fn


def evaluate(features_fn, metrics_fn, logs: EvalLogs, batch_size: int,
             collect_rows: bool = False,
             features: Optional[torch.Tensor] = None
             ) -> Tuple[Metrics, Optional[np.ndarray], float]:
    """Average metrics over all logs of ``logs``.

    Returns (avg_metrics, per-log rows or None, elapsed seconds). Pass
    ``features`` to share one full-graph forward between evaluations."""
    start = time.perf_counter()
    if features is None:
        features = features_fn()

    sums = np.zeros(4, np.float64)
    count = 0
    rows_out = [] if collect_rows else None
    for users, queries, truth, counts, weight in logs.batches(batch_size):
        rows = metrics_fn(features, users, queries, truth, counts)
        rows = rows.cpu().numpy()
        n = int(weight.sum())
        sums += rows[:n].sum(axis=0)
        count += n
        if collect_rows:
            rows_out.append(rows[:n])

    m = Metrics.from_row(sums / max(count, 1))
    per_log = np.concatenate(rows_out, axis=0) if collect_rows else None
    return m, per_log, time.perf_counter() - start
