"""Entry points of the port: a forward scoring function, and one sharded
train step on n ranks.

Counterpart of ``__graft_entry__.py`` (``_build_tiny`` ``:16-61``,
``entry`` ``:64-78``, ``dryrun_multichip`` ``:81-115``), on the same tiny
model: ``RawGnn`` with two IHGNN layers (order 3, then 1), d = 16, on the
synthetic data of 20 users, 12 queries, 30 items, 25 words and 150 logs
(seed 0), a batch of 16 positives × 4 negatives (sampler seed 1).

* ``entry()`` — ``(forward, (params, users, queries, items))``:
  ``forward`` scores the batch's rows with the weights ``params`` (a
  ``RawGnn`` state dict, as the JAX function takes flax params).
* ``dryrun_multichip(n)`` — one train step of the tiny model on n spawned
  ranks (``parallel/ranks.py``): the model axis 2 when n is even and at
  least 4, else 1, the rest of the ranks on ``data``; the tables' rows
  over ``model``, each rank's slice with its routed pack. It asserts a
  finite loss, prints the JAX function's line and returns every rank's
  ``run_job`` result (losses, launches, collectives).

``python -m ihgnn_torch.entry [--device cuda|cpu]`` runs both, the dry
run on 4 ranks, the least mesh with a model axis (on the card by
default: the ranks share it unless each has a card).
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from ihgnn_torch.config import ModelConfig
from ihgnn_torch.device import DeviceLike, resolve_device

TINY = dict(user_count=20, query_count=12, item_count=30, vocab_size=25,
            log_count=150)


def _build_tiny(row_multiple: int = 1, seed: int = 0):
    """(ModelConfig, GraphData, the first batch) of the tiny model."""
    from ihgnn_torch.data.dataset import TrainSampler
    from ihgnn_torch.data.synthetic import make_synthetic_data
    cfg = ModelConfig(embedding_size=16, gnn_layer_count=2,
                      feature_interaction_order=3)
    data = make_synthetic_data(seed=seed, **TINY)
    sampler = TrainSampler(data, 16, 4, seed=1, row_multiple=row_multiple)
    return cfg, data, next(sampler.epoch())


def entry(device: DeviceLike = "cuda"):
    """``(forward, (params, users, queries, items))`` on ``device``:
    ``forward(params, users, queries, items)`` is the ``[R]`` scores of
    the batch's (user, query, item) rows under the weights ``params``."""
    from ihgnn_torch.models.embedding import make_word_bag
    from ihgnn_torch.models.rawgnn import RawGnn
    dev = resolve_device(device)
    cfg, data, batch = _build_tiny()
    model = RawGnn(cfg, data.user_count, data.query_count, data.item_count,
                   data.vocab_size,
                   generator=torch.Generator().manual_seed(0)).to(dev)
    graph = data.hypergraph.to(dev)
    bag = make_word_bag(data.query_words, data.query_word_counts,
                        data.vocab_size + 1).to(dev)

    def forward(params, users, queries, items):
        with torch.no_grad():
            return torch.func.functional_call(
                model, params, (graph, bag, users, queries, items))

    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    rows = tuple(torch.as_tensor(np.asarray(a)).to(dev)
                 for a in (batch.users, batch.queries, batch.items))
    return forward, (params, *rows)


def dryrun_multichip(n_ranks: int, device: DeviceLike = "cuda") -> list:
    """One sharded train step of the tiny model on ``n_ranks`` spawned
    ranks on ``device`` (module docstring); returns ``[rank][0]``
    results (``parallel/ranks.py`` ``run_jobs``)."""
    from ihgnn_torch.parallel.ranks import TrainJob, run_jobs
    dev = resolve_device(device)
    if dev.type == "cuda":
        # the ranks load the kernels; they never build them
        from ihgnn_torch.ops import _build
        _build.build()
    from ihgnn_torch.ops import native
    native.load()
    model_axis = 2 if n_ranks % 2 == 0 and n_ranks >= 4 else 1
    data_axis = n_ranks // model_axis
    cfg, data, batch = _build_tiny(row_multiple=data_axis)
    job = TrainJob("dryrun", cfg, (data.user_count, data.query_count,
                                   data.item_count, data.vocab_size),
                   np.asarray(data.pos_uqif), data.query_words,
                   data.query_word_counts, [batch], pack_kernels=True,
                   model_axis=model_axis)
    ranks = run_jobs(n_ranks, [job], dev.type)
    loss = ranks[0][0]["losses"][0]
    assert all(math.isfinite(r[0]["losses"][0]) for r in ranks), \
        f"non-finite loss {[r[0]['losses'] for r in ranks]}"
    print(f"dryrun_multichip({n_ranks}): mesh data={data_axis} "
          f"model={model_axis}, one train step OK, loss={loss:.4f}")
    return ranks


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    fn, args = entry(a.device)
    out = fn(*args)
    if out.device.type == "cuda":
        torch.cuda.synchronize(out.device)
    print(f"entry(): forward OK, {tuple(out.shape)} scores")
    dryrun_multichip(4, a.device)


if __name__ == "__main__":
    main()
