"""Rank bodies of ``tests/test_torch_sharding.py`` that a spawned rank
imports: this module imports the port and never JAX, so a rank starts in
seconds. Each body runs on one rank of ``ihgnn_torch.parallel.ranks``
(``job(mesh, device)``) and returns CPU tensors; ``run_cli`` starts the
CLI's ranks with torchrun."""

from __future__ import annotations

import os

import numpy as np
import torch

from ihgnn_torch.config import ModelConfig
from ihgnn_torch.graph import build_attention_csr, build_hypergraph
from ihgnn_torch.models.rawgnn import RawGnn
from ihgnn_torch.ops.bag import make_word_bag
from ihgnn_torch.parallel.collectives import reduce_gradients
from ihgnn_torch.parallel.sharding import (pad_hypergraph_for_mesh,
                                           shard_bag, shard_graph)


def bag_job(words, counts, vocab_rows, table, cot, mesh, device):
    """The bag means of ``table`` and the table's gradient for the
    cotangent ``cot`` ``[Q, d]`` of the means: a rank's ``ShardedBag``
    (the gradient summed over the ranks), or with no mesh the
    ``WordBag``."""
    table = table.clone().requires_grad_(True)
    bag = (make_word_bag(words, counts, vocab_rows) if mesh is None
           else shard_bag(words, counts, vocab_rows, mesh))
    means = bag.mean(table)
    (means * cot).sum().backward()
    if mesh is not None:
        reduce_gradients([table], mesh)
    return {"means": means.detach(), "grad": table.grad}


def tail_job(counts, uqi, words, word_counts, state, batch, mesh, device):
    """A rank's logits of its rows and the parameters' gradients of their
    sum, through the tail psum (``score_tail``) and through the full node
    combine of every layer (``RawGnn.forward``)."""
    users, queries, items, vocab = counts
    graph = build_hypergraph(uqi, users + queries + items, users, queries)
    graph = shard_graph(pad_hypergraph_for_mesh(graph, mesh.data), mesh)
    model = RawGnn(ModelConfig(embedding_size=8), users, queries, items,
                   vocab)
    model.load_state_dict(state)
    bag = shard_bag(words, word_counts, vocab + 1, mesh)
    rows = mesh.block(len(batch.users))
    u, q, i = (torch.from_numpy(np.asarray(a))
               for a in (batch.users, batch.queries, batch.items))
    out = {"tail": model.tail_restricted(graph)}
    for name, run in (("tail", lambda: model.score_tail(graph, bag, u, q, i,
                                                         rows)),
                      ("full", lambda: model(graph, bag, u[rows], q[rows],
                                             i[rows]))):
        model.zero_grad(set_to_none=True)
        logits = run()
        logits.sum().backward()
        reduce_gradients(model.parameters(), mesh)
        out[name] = (logits.detach(),
                     {n: p.grad.clone() for n, p in model.named_parameters()})
    return out


def softmax_job(entries, node_count, dst_count, x, heads, cot, mesh,
                device):
    """The attention conv ``gat_conv`` of ``x`` over the entries of
    ``entries`` ``[(rank, src, dst, live)]`` (sorted by destination), for
    each head of ``heads`` ``{head: (khead, bhead)}``: with a mesh over
    the rank's own entries (the output summed over the ranks), else over
    all. Returns ``{head: (out, dx, dkhead, dbhead)}``: the output and the
    gradients of ``(out * cot).sum()``, each rank back-propagating its
    share and the gradients summed over the ranks."""
    from ihgnn_torch.ops.gatconv import gat_conv
    mine = [e for e in entries if mesh is None or e[0] == mesh.rank]
    src, dst, live = (np.asarray([e[k] for e in mine], np.int64)
                      for k in (1, 2, 3))
    csr = build_attention_csr(src, dst, node_count, dst_count,
                              None if live.all() else live)
    share = 1 if mesh is None else mesh.data
    out = {}
    for head, (khead, bhead) in heads.items():
        params = [t.clone().requires_grad_(True) for t in (x, khead, bhead)]
        y = gat_conv(*params, csr, head, mesh)
        ((y * cot).sum() / share).backward()
        if mesh is not None:
            reduce_gradients(params, mesh)
        out[head] = (y.detach(), *(p.grad for p in params))
    return out


def run_cli(world, argvs, out_dir, timeout=300):
    """``torchrun --standalone --nproc_per_node world -m ihgnn_torch.cli
    *argv --run_record DIR`` for each ``argv`` of ``argvs`` in turn, as a
    user starts it (torchrun finds a free port itself); returns each
    rank's runs, a run's ``(epoch, avg_loss)`` list. A run that outlasts
    ``timeout`` seconds is stopped and raises."""
    import json
    import subprocess
    import sys
    runs = [[] for _ in range(world)]
    for k, argv in enumerate(argvs):
        record = os.path.join(out_dir, f"record{k}")
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", str(world), "-m", "ihgnn_torch.cli", *argv,
             "--run_record", record],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env={**os.environ, "OMP_NUM_THREADS": "1"})
        try:
            log, _ = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.terminate()       # torchrun stops its workers
            log, _ = proc.communicate(timeout=30)
            raise RuntimeError(f"torchrun timed out: {log[-3000:]}")
        if proc.returncode != 0:
            raise RuntimeError(f"torchrun rc {proc.returncode}: "
                               f"{log[-3000:]}")
        for r in range(world):
            with open(os.path.join(record, f"rank{r}.json")) as f:
                runs[r].append([(e["epoch"], e["avg_loss"])
                                for e in json.load(f)["epochs"]])
    return runs
