"""Full-graph training: ``make_train_step``'s step on batches from the
seed, fed through the program's ``prefetch``.

Set-up builds the graph, the model with the seed's weights, Adam, the
step and its feed (``premade_batches`` batches drawn ahead, then
replayed through the program's ``prefetch``, so that drawing them takes
no host time from the window's steps), and drives that same step through
its first ``checked_steps`` batches from the window's own feed, reading
each step's loss, the first gradient from Adam's first moment
(m₁ = (1 - β₁)·g) and each parameter's change after the last of them;
then ``warm_steps`` more. The
window runs steps until ``seconds`` have passed and ends in a
synchronise. Once the program is freed, the reference takes the same
weights (drawn again from the seed) through the same batches.
"""

from __future__ import annotations

import threading

import torch

from benchmark import compare, faults, generate, program, trace, weights
from benchmark.reference import rawgnn
from benchmark.reference.precision import F32, Precision
from benchmark.work import common as work

BETA1 = rawgnn.ADAM_BETAS[0]


def inputs(run) -> dict:
    """The cell's graph rows, query words and seeded streams."""
    rngs = generate.streams(run.seed)
    uqi = generate.interactions(run.sizes, run.traffic, rngs["interactions"])
    words, counts = generate.query_words(run.sizes, rngs["words"])
    return {"uqi": uqi, "words": words, "counts": counts, "rngs": rngs}


def build(run, data: dict, model: dict, graph=None) -> dict:
    """The program: graph (built here unless given), model, Adam, step and
    feed."""
    if graph is None:
        graph = program.build_graph(model, run.sizes, data["uqi"])
        run.mark("graph")
    w = weights.draw(model, run.sizes, run.seed, run.device)
    net = program.make_model(model, run.sizes, w, run.device)
    del w
    opt, step = program.make_train(net, graph, data["words"],
                                   data["counts"], run.train, run.device)
    stop = threading.Event()
    feed = program.prefetch(generate.premade(
        generate.train_batches(data["uqi"], run.sizes, run.traffic,
                               data["rngs"]["batches"]),
        run.traffic["premade_batches"], stop))
    return {"graph": graph, "net": net, "opt": opt, "step": step,
            "feed": feed, "stop": stop}


def close_feed(prog: dict) -> None:
    """Stop the feed's producer and drain it until the thread ends."""
    prog["stop"].set()
    for _ in prog["feed"]:
        pass


def first_steps(run, prog: dict) -> tuple:
    """``(readings, batches)``: the program's first steps through the
    window's own call and feed."""
    params = dict(prog["net"].named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    batches, losses, grad_norms = [], [], None
    for _ in range(run.traffic["checked_steps"]):
        b = next(prog["feed"])
        batches.append(b)
        losses.append(float(prog["step"](program.as_batch(b))))
        if grad_norms is None:
            grad_norms = {}
            for k, p in params.items():
                m = prog["opt"].state.get(p, {}).get("exp_avg")
                grad_norms[k] = (0.0 if m is None
                                 else float(m.norm()) / (1 - BETA1))
    change = {k: float((p.detach() - start[k]).norm())
              for k, p in params.items()}
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}, batches


def reference(run, data: dict, batches, prec: Precision = F32) -> dict:
    """The reference's readings over ``batches`` from the seed's
    weights."""
    dev = run.device
    graph = rawgnn.layer_module(run.model["gnn"]).build(
        torch.as_tensor(data["uqi"], device=dev), run.sizes)
    w = weights.draw(run.model, run.sizes, run.seed, dev)
    tb = [{k: torch.as_tensor(v, device=dev) for k, v in b.items()}
          for b in batches]
    return rawgnn.train_steps(
        w, run.model, run.sizes, run.train["learning_rate"],
        torch.as_tensor(data["words"], device=dev),
        torch.as_tensor(data["counts"], device=dev), graph, tb, prec)


def shapes(run, data: dict) -> dict:
    s = dict(run.sizes, d=run.model["embedding_size"],
             layers=run.model["gnn_layer_count"], gnn=run.model["gnn"],
             order=run.model.get("feature_interaction_order", 1),
             rows=run.traffic["batch_positives"]
             * (1 + run.traffic["random_negatives"]))
    if run.model["gnn"] == "gat":
        graph = rawgnn.layer_module("gat").build(
            torch.as_tensor(data["uqi"], device=run.device), run.sizes)
        s["entries"] = int(graph["src"].numel())
    return s


def run(run) -> dict:
    data = inputs(run)
    run.mark("inputs")
    program.build_kernels(run.device)
    run.mark("kernels")
    rec = {"kind": "train"}
    with faults.planted("train", run.fault):
        prog = build(run, data, run.model)
        run.mark("program")
        got, batches = first_steps(run, prog)
        run.mark("checked steps")
        step, feed = prog["step"], prog["feed"]
        for _ in range(run.traffic["warm_steps"]):
            step(program.as_batch(next(feed)))
        run.sync()
        run.mark("warm steps")
        rec["setup_s"] = run.now() - run.started
        rec["setup_peak_bytes"] = run.peak_bytes()
        run.reset_peak()
        program.zero_launches()
        host, losses = [], []
        t0 = run.now()
        while True:
            b = program.as_batch(next(feed))
            h0 = run.now()
            losses.append(step(b))
            host.append(run.now() - h0)
            if run.now() - t0 >= run.seconds:
                break
        run.sync()
        rec["window_s"] = run.now() - t0
        rec["steps"] = len(losses)
        rec["host_issue_s"] = host
        rec["launches"] = program.launch_counts()
        rec["window_peak_bytes"] = run.peak_bytes()
        failed = int((~torch.isfinite(torch.stack(losses))).sum())
        if run.trace:
            rec["trace"] = trace.profile(
                lambda: step(program.as_batch(next(feed))),
                run.traffic["profiled_steps"], run.sync)
        rec["memory_peak_bytes"] = max(rec["setup_peak_bytes"],
                                       rec["window_peak_bytes"])
        close_feed(prog)
        del prog, step, feed, losses
        run.free()
    s = shapes(run, data)
    ops = work.train_step(s)
    rec["work"] = {"window_flops": work.total_flops(ops) * rec["steps"],
                   "bound_s_per_unit": work.total_bound_s(ops)}
    want = reference(run, data, batches)
    readings = compare.train_readings(got, want)
    rec["checks"] = compare.checks(readings, run.limits)
    rec["correct"] = compare.verdict(rec["checks"]) and failed == 0
    rec["attempted"] = rec["steps"]
    rec["failed"] = failed
    return rec
