"""Full-catalog ranking: a test epoch of logs, repeated.

Set-up builds the graph and the model with the seed's weights, the eval
functions of ``make_eval_fns``, and the epoch's logs (the first truth
item of a share of them among the catalog's best-scored items, which the
seed's item biases decide); it refreshes the features once and ranks
``warm_batches`` batches. The window runs passes: a ``features_fn()``
refresh, timed to a synchronise, then the epoch's batches, each timed
from its ``metrics_fn`` call to its rows on the host, until ``seconds``
have passed. ``checked_batches`` of the epoch's batches are drawn from
the seed before the window; the first time the window ranks one of them,
the catalog scores of its truth items are kept as ``metrics_fn`` hands
them to the ranking (a gather on the device). Once the program is freed,
the reference computes the features, those batches' truth scores and
metric rows, and they are compared with the last refresh and with what
the window produced.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import compare, faults, generate, program, trace, weights
from benchmark.loops.train import inputs
from benchmark.reference import rawgnn
from benchmark.reference.precision import F32, Precision
from benchmark.work import common as work


def top_items(run, w) -> np.ndarray:
    bias = w["prediction.items_bias"]
    k = min(run.traffic["top_items"], bias.numel())
    return torch.topk(bias, k).indices.cpu().numpy()


def build(run, data: dict, model: dict, graph=None) -> dict:
    if graph is None:
        graph = program.build_graph(model, run.sizes, data["uqi"])
        run.mark("graph")
    w = weights.draw(model, run.sizes, run.seed, run.device)
    logs = generate.eval_logs(run.sizes, run.traffic, data["rngs"]["logs"],
                              top_items(run, w))
    net = program.make_model(model, run.sizes, w, run.device)
    del w
    features_fn, metrics_fn = program.make_eval(
        net, graph, data["words"], data["counts"], run.device)
    return {"graph": graph, "net": net, "features_fn": features_fn,
            "metrics_fn": metrics_fn, "logs": logs}


def batch(logs: dict, j: int) -> tuple:
    return (logs["users"][j], logs["queries"][j], logs["truth"][j],
            logs["counts"][j])


def sample(run, n: int) -> np.ndarray:
    """``checked_batches`` of the epoch's ``n`` batches, drawn from the
    seed."""
    rng = generate.streams(run.seed)["sample"]
    k = min(run.traffic["checked_batches"], n)
    return np.sort(rng.choice(n, k, replace=False))


class TruthScores:
    """The scores of the truth items of the batches in ``picked``, the
    first time the eval path ranks each (``program.watch_scores``):
    ``at`` is the batch being ranked, ``got`` maps it to a ``[B, T]``
    tensor on the device."""

    def __init__(self, picked):
        self.picked = set(int(j) for j in picked)
        self.at = None
        self.got = {}

    def __call__(self, scores, truth):
        j = self.at
        if j in self.picked and j not in self.got:
            self.got[j] = scores.gather(1, truth.long().clamp(min=0))

    def host(self) -> dict:
        return {j: t.float().cpu().numpy() for j, t in self.got.items()}


def reference(run, data: dict, logs: dict, rows: np.ndarray,
              scores: dict, features, prec: Precision = F32) -> dict:
    """The readings of ``features`` (the program's), and of the truth
    scores ``scores[j]`` and metric rows ``rows[j]`` of each batch ``j``
    of ``scores``."""
    dev = run.device
    graph = rawgnn.layer_module(run.model["gnn"]).build(
        torch.as_tensor(data["uqi"], device=dev), run.sizes)
    w = weights.draw(run.model, run.sizes, run.seed, dev)
    with torch.no_grad():
        want = rawgnn.features(w, run.model, run.sizes,
                               torch.as_tensor(data["words"], device=dev),
                               torch.as_tensor(data["counts"], device=dev),
                               graph, prec)
    del graph
    gap = compare.feature_gap(features, want,
                              run.model["embedding_size"])
    mismatched, ambiguous, worst, at = 0, 0, 0.0, None
    lam = run.model["lambda_muq"]
    for j in sorted(scores):
        users, queries, truth, counts = batch(logs, j)
        u, q, t = (torch.as_tensor(a, device=dev)
                   for a in (users, queries, truth))
        exact, term = rawgnn.truth_scores(w, want, run.sizes, lam, u, q, t)
        sg = compare.score_gap(torch.as_tensor(scores[j], device=dev),
                               exact, term, t >= 0)
        if not sg <= worst:
            worst, at = sg, j
        catalog = rawgnn.catalog_scores(w, want, run.sizes, lam, u, q, prec)
        ranks, amb = rawgnn.truth_ranks(catalog, t, compare.TIE)
        del catalog
        ref_rows = rawgnn.metric_rows(ranks.cpu().numpy(), truth, counts)
        amb = amb.any(1).cpu().numpy()
        bad = np.abs(rows[j].astype(np.float64) - ref_rows).max(1) \
            > compare.ROW_TOL
        mismatched += int((bad & ~amb).sum())
        ambiguous += int(amb.sum())
    return {"feature_gap": gap,
            "score_gap": (worst, f"batch {at} of {len(scores)}"),
            "row_mismatches": (float(mismatched),
                               f"{len(scores)} batches, {ambiguous} rows "
                               "left out as ties")}


def shapes(run) -> dict:
    return dict(run.sizes, d=run.model["embedding_size"],
                layers=run.model["gnn_layer_count"], gnn=run.model["gnn"],
                order=run.model.get("feature_interaction_order", 1),
                batch_logs=run.traffic["batch_logs"],
                truth_max=run.traffic["truth_max"])


def run(run) -> dict:
    data = inputs(run)
    run.mark("inputs")
    program.build_kernels(run.device)
    run.mark("kernels")
    rec = {"kind": "rank"}
    with faults.planted("rank", run.fault):
        prog = build(run, data, run.model)
        run.mark("program")
        logs, features_fn, metrics_fn = (prog["logs"], prog["features_fn"],
                                         prog["metrics_fn"])
        n = logs["users"].shape[0]
        feats = features_fn()
        for j in range(run.traffic["warm_batches"]):
            metrics_fn(feats, *batch(logs, j % n)).cpu()
        run.sync()
        run.mark("warm batches")
        rec["setup_s"] = run.now() - run.started
        rec["setup_peak_bytes"] = run.peak_bytes()
        run.reset_peak()
        rows = np.zeros(logs["truth"].shape[:2] + (4,), np.float32)
        seen = TruthScores(sample(run, n))
        refresh, batch_s, ranked = [], [], 0
        j = n
        with program.watch_scores(seen):
            t0 = run.now()
            while True:
                if j == n:
                    r0 = run.now()
                    feats = features_fn()
                    run.sync()
                    refresh.append(run.now() - r0)
                    j = 0
                b0 = run.now()
                seen.at = j
                rows[j] = metrics_fn(feats, *batch(logs, j)).cpu().numpy()
                batch_s.append(run.now() - b0)
                ranked += int(logs["weight"][j].sum())
                j += 1
                if run.now() - t0 >= run.seconds:
                    break
            rec["window_s"] = run.now() - t0
        rec["batches"] = len(batch_s)
        rec["logs_ranked"] = ranked
        rec["batch_s"] = batch_s
        rec["refresh_s"] = refresh
        rec["window_peak_bytes"] = run.peak_bytes()
        if run.trace:
            k = [j % n]

            def one():
                metrics_fn(feats, *batch(logs, k[0])).cpu()
                k[0] = (k[0] + 1) % n
            rec["trace"] = trace.profile(one, run.traffic["profiled_batches"],
                                         run.sync)
        rec["memory_peak_bytes"] = max(rec["setup_peak_bytes"],
                                       rec["window_peak_bytes"])
        features, truth_scores = feats, seen.host()
        del prog, features_fn, metrics_fn, seen
        run.free()
    s = shapes(run)
    batch_ops, fwd_ops = work.rank_batch(s), work.forward(s)
    rec["work"] = {
        "window_flops": (work.total_flops(batch_ops) * rec["batches"]
                         + work.total_flops(fwd_ops) * len(refresh)),
        "bound_s_per_unit": work.total_bound_s(batch_ops)}
    readings = reference(run, data, logs, rows, truth_scores, features)
    rec["checks"] = compare.checks(readings, run.limits)
    rec["correct"] = compare.verdict(rec["checks"])
    rec["attempted"] = rec["batches"]
    rec["failed"] = 0
    return rec
