"""The training step: full-graph forward, weighted BCE, Adam.

Counterpart of ``ihgnn_tpu/train/train.py``. Each step recomputes the
full-graph convolution (the reference's per-step semantics, SURVEY.md
§3.1), scores the batch's padded positive + negative rows, takes the
weighted-mean BCE-with-logits (Main.py:191, TrainTestHelper.py:126-134),
backpropagates through the kernels' autograd Functions and applies one
Adam update with torch-style (coupled) weight decay. The learning rate is
the optimizer's ``lr``, changed on the host between epochs
(TrainTestHelper.py:155-159).

The Adam update and the BCE are PyTorch calls, as the JAX package leaves
them to XLA.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ihgnn_torch.config import TrainConfig
from ihgnn_torch.data.dataset import Batch
from ihgnn_torch.device import DeviceLike, model_device
from ihgnn_torch.graph import AnyGraph
from ihgnn_torch.models.embedding import make_word_bag
from ihgnn_torch.models.rawgnn import RawGnn
from ihgnn_torch.parallel.collectives import all_reduce_sum, reduce_gradients
from ihgnn_torch.parallel.mesh import Mesh
from ihgnn_torch.parallel.sharding import shard_bag
from ihgnn_torch.parallel.tables import replicated_parameters


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   cfg: TrainConfig) -> torch.optim.Adam:
    """Adam (0.9, 0.999, eps 1e-8). Its ``weight_decay`` adds
    ``decay · param`` to the gradient before the moments, which is what
    ``optax.add_decayed_weights`` before ``scale_by_adam`` computes in the
    JAX package (``train.py:33-41``)."""
    return torch.optim.Adam(params, lr=cfg.learning_rate, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=cfg.weight_decay)


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor,
                    weight: torch.Tensor) -> torch.Tensor:
    """Weighted mean sigmoid BCE (padding rows carry weight 0)."""
    per_row = F.binary_cross_entropy_with_logits(logits, labels,
                                                 reduction="none")
    return (per_row * weight).sum() / torch.clamp(weight.sum(), min=1.0)


def batch_putter(dev: torch.device) -> Callable[..., torch.Tensor]:
    """``put(array)``: a host array as a tensor on ``dev``. A copy from
    pageable memory waits for the stream to drain; from pinned memory it
    queues behind the previous step instead."""
    def put(a) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(a))
        if dev.type != "cuda":
            return t
        return t.pin_memory().to(dev, non_blocking=True)
    return put


def make_train_step(model: RawGnn, graph: AnyGraph, query_words,
                    query_word_counts, optimizer: torch.optim.Optimizer,
                    grad_accum_steps: int = 1,
                    device: DeviceLike = "cuda",
                    mesh: Optional[Mesh] = None) -> Callable[[Batch],
                                                             torch.Tensor]:
    """Returns ``train_step(batch) -> loss`` on ``device``; the model must
    already be there (``model.to(device)``) and ``optimizer`` hold its
    parameters.

    ``grad_accum_steps`` = k > 1 replicates the reference's
    ``batch_size_times`` (TrainTestHelper.py:137-143): the step takes k
    stacked batches (``Batch.stack``, ``[k, R]`` arrays), sums their
    gradients (``backward`` accumulates) and applies one update. The loss
    is a 0-d tensor on ``device``: the batch's loss, or the sum over the
    k microbatches (the caller averages).

    ``mesh``: the data-parallel step of a rank (``parallel/``), on
    ``graph`` = the rank's slice (``shard_graph``). Every rank takes the
    whole batch and scores its block of rows (``shard_batch``'s); its
    loss is its rows' weighted BCE over the whole batch's weight, so the
    ranks' losses sum to the batch's. Each rank back-propagates its own
    loss (sum-of-partials, ``parallel/collectives.py``), the gradients
    are summed over the ranks once, after the last microbatch, and Adam
    updates every rank's replica alike. The returned loss is the sum over
    the ranks, the whole batch's. "The ranks" are the data group: on a
    mesh with a model axis the ranks of one data index hold the same rows
    and loss, and each its blocks of the tables (``parallel/tables.py``
    ``shard_tables``, done before the optimizer is made), whose gradients
    the tables' gather sums."""
    dev = model_device(model, device)
    if grad_accum_steps < 1:
        raise ValueError(f"grad_accum_steps must be >= 1, got "
                         f"{grad_accum_steps}")
    if (mesh is None) != (getattr(graph, "mesh", None) is None):
        raise ValueError("a mesh step takes a rank's slice of the graph "
                         "(shard_graph), and a one-device step the graph")
    graph = graph.to(dev)
    vocab_rows = model.embeddings.rows["vocab_table"]
    bag = (make_word_bag(query_words, query_word_counts, vocab_rows)
           if mesh is None else
           shard_bag(query_words, query_word_counts, vocab_rows, mesh)
           ).to(dev)

    put = batch_putter(dev)

    def loss_of(batch: Batch) -> torch.Tensor:
        if mesh is None:
            logits = model(graph, bag, put(batch.users), put(batch.queries),
                           put(batch.items))
            return bce_with_logits(logits, put(batch.flags),
                                   put(batch.weight))
        rows = mesh.block(batch.users.shape[-1])
        users, queries, items = (put(batch.users), put(batch.queries),
                                 put(batch.items))
        if model.tail_restricted(graph):
            logits = model.score_tail(graph, bag, users, queries, items, rows)
        else:
            logits = model(graph, bag, users[rows], queries[rows],
                           items[rows])
        per_row = F.binary_cross_entropy_with_logits(
            logits, put(batch.flags[rows]), reduction="none")
        total_weight = max(float(np.asarray(batch.weight).sum()), 1.0)
        return (per_row * put(batch.weight[rows])).sum() / total_weight

    def train_step(batch: Batch) -> torch.Tensor:
        micro = batch.unstack()
        if len(micro) != grad_accum_steps:
            raise ValueError(f"expected {grad_accum_steps} stacked "
                             f"batch(es), got users {batch.users.shape}")
        optimizer.zero_grad(set_to_none=True)
        total = None
        for mb in micro:
            loss = loss_of(mb)
            loss.backward()
            total = loss.detach() if total is None else total + loss.detach()
        if mesh is not None:
            reduce_gradients(replicated_parameters(model), mesh)
            total = all_reduce_sum(total, mesh, site="loss")
        optimizer.step()
        return total

    return train_step


def adjust_lr_after_epoch(optimizer: torch.optim.Optimizer, avg_loss: float,
                          cfg: TrainConfig, is_rawgnn: bool = True) -> bool:
    """Host-side epoch-level LR decay (TrainTestHelper.py:155-159) on the
    optimizer's ``lr``; returns whether it fired."""
    lr = optimizer.param_groups[0]["lr"]
    if (cfg.adjust_learning_rate and is_rawgnn
            and avg_loss < cfg.lr_decay_loss_threshold and lr > cfg.lr_floor):
        for group in optimizer.param_groups:
            group["lr"] = lr * cfg.lr_decay_factor
        return True
    return False
