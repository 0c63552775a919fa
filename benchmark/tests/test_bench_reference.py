"""The plain reference against the port's CPU path at a tiny size:
features, loss, first gradients and one Adam step of IHGNN and GAT, and
the rank cell's metric rows."""

import numpy as np
import pytest
import torch

from benchmark import compare, generate, program, weights
from benchmark.loops import rank, train
from benchmark.harness import Run
from benchmark.reference import rawgnn
from conftest import tiny

CPU = torch.device("cpu")
SEED = 4_000_000_007


def _run(name):
    return Run(tiny(name), SEED, 0, False, CPU, 0.0)


def _port_features(run, data):
    net = program.make_model(run.model, run.sizes,
                             weights.draw(run.model, run.sizes, run.seed,
                                          CPU), CPU)
    graph = program.build_graph(run.model, run.sizes, data["uqi"])
    features_fn, metrics_fn = program.make_eval(net, graph, data["words"],
                                                data["counts"], CPU)
    return features_fn(), metrics_fn


def _ref_features(run, data):
    graph = rawgnn.layer_module(run.model["gnn"]).build(
        torch.as_tensor(data["uqi"]), run.sizes)
    w = weights.draw(run.model, run.sizes, run.seed, CPU)
    with torch.no_grad():
        return w, rawgnn.features(w, run.model, run.sizes,
                                  torch.as_tensor(data["words"]),
                                  torch.as_tensor(data["counts"]), graph)


@pytest.mark.parametrize("cell", ["ihgnn.train", "gat.train"])
def test_features_match_the_port(cell):
    run = _run(cell)
    data = train.inputs(run)
    got, _ = _port_features(run, data)
    _, want = _ref_features(run, data)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cell", ["ihgnn.train", "gat.train"])
def test_one_step_matches_the_port(cell):
    """The loss, every first gradient (from Adam's first moment) and every
    parameter after one Adam step."""
    run = _run(cell)
    run.traffic["checked_steps"] = 1
    data = train.inputs(run)
    prog = train.build(run, data, run.model)
    got, batches = train.first_steps(run, prog)
    params = {k: p.detach().clone()
              for k, p in prog["net"].named_parameters()}
    train.close_feed(prog)
    want = train.reference(run, data, batches)
    assert got["losses"] == pytest.approx(want["losses"], rel=1e-6)
    # a gradient that is nought to rounding (the score head's bias under
    # the softmax) is held to the median leaf's scale, and Adam moves it
    # by round-off alone, so its step is not compared (compare.MOVED)
    med = float(np.median(list(want["grad_norms"].values())))
    for k, v in want["grad_norms"].items():
        assert got["grad_norms"][k] == pytest.approx(v, rel=1e-5,
                                                     abs=1e-6 * med)
    w = weights.draw(run.model, run.sizes, run.seed, CPU)
    tb = [{k: torch.as_tensor(v) for k, v in b.items()} for b in batches]
    graph = rawgnn.layer_module(run.model["gnn"]).build(
        torch.as_tensor(data["uqi"]), run.sizes)
    live = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    feats = rawgnn.features(live, run.model, run.sizes,
                            torch.as_tensor(data["words"]),
                            torch.as_tensor(data["counts"]), graph)
    loss = rawgnn.bce(rawgnn.score_rows(
        live, feats, run.sizes, run.model["lambda_muq"], tb[0]["users"],
        tb[0]["queries"], tb[0]["items"]), tb[0]["flags"], tb[0]["weight"])
    grads = dict(zip(live, torch.autograd.grad(loss, list(live.values()))))
    stepped = {k: v.detach().clone() for k, v in w.items()}
    rawgnn.adam(stepped, grads, {}, 1, run.train["learning_rate"])
    for k, v in stepped.items():
        if want["grad_norms"][k] < compare.MOVED * med:
            continue
        # elements whose gradient is round-off within their leaf (the
        # destination half of the GAT score head, constant under each
        # destination's softmax) move by ±lr on either side's rounding
        g = grads[k].abs()
        live_el = g >= 1e-3 * g.max()
        torch.testing.assert_close(params[k][live_el], v[live_el], rtol=0,
                                   atol=2e-6, msg=lambda m, k=k: f"{k}: {m}")
        change = float((params[k] - w[k]).norm())
        assert change == pytest.approx(float((v - w[k]).norm()), rel=1e-3)


def test_rank_rows_match_the_port():
    run = _run("ihgnn.rank")
    data = train.inputs(run)
    w, feats = _ref_features(run, data)
    got_feats, metrics_fn = _port_features(run, data)
    logs = generate.eval_logs(run.sizes, run.traffic, data["rngs"]["logs"],
                              rank.top_items(run, w))
    hits = 0
    for j in range(logs["users"].shape[0]):
        users, queries, truth, counts = rank.batch(logs, j)
        got = metrics_fn(got_feats, users, queries, truth, counts).numpy()
        scores = rawgnn.catalog_scores(w, feats, run.sizes,
                                       run.model["lambda_muq"],
                                       torch.as_tensor(users),
                                       torch.as_tensor(queries))
        ranks, amb = rawgnn.truth_ranks(scores, torch.as_tensor(truth),
                                        compare.TIE)
        want = rawgnn.metric_rows(ranks.numpy(), truth, counts)
        ok = ~amb.any(1).numpy()
        np.testing.assert_allclose(got[ok], want[ok], rtol=0,
                                   atol=compare.ROW_TOL)
        hits += int((want[:, 0] > 0).sum())
    # the logs' truth reaches the top ten often enough to test the ranks
    assert hits > logs["logs"] // 10


def test_truth_scores_match_the_port():
    """The scores the port's ``metrics_fn`` ranks, seen at the truth
    items, against the reference's float64 scores."""
    run = _run("ihgnn.rank")
    data = train.inputs(run)
    w, feats = _ref_features(run, data)
    got_feats, metrics_fn = _port_features(run, data)
    logs = generate.eval_logs(run.sizes, run.traffic, data["rngs"]["logs"],
                              rank.top_items(run, w))
    n = logs["users"].shape[0]
    seen = rank.TruthScores(range(n))
    with program.watch_scores(seen):
        for j in range(n):
            seen.at = j
            metrics_fn(got_feats, *rank.batch(logs, j))
    assert sorted(seen.got) == list(range(n))
    for j, got in seen.host().items():
        users, queries, truth, _ = rank.batch(logs, j)
        t = torch.as_tensor(truth)
        exact, term = rawgnn.truth_scores(w, feats, run.sizes,
                                          run.model["lambda_muq"],
                                          torch.as_tensor(users),
                                          torch.as_tensor(queries), t)
        assert compare.score_gap(torch.as_tensor(got), exact, term,
                                 t >= 0) < 1e-4

