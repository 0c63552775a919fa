"""Srrl's alternating KG/PS training loop.

Counterpart of ``ihgnn_tpu/train/srrl_loop.py`` (TrainTestHelper.py:
160-255). An epoch runs ``ceil(P / B)`` KG steps, the mode rotating
tail → head → query company, on log-sigmoid positive and negative scores
with word2vec subsampling weights, then a whole PS pass with pointwise
BCE.

One Adam serves both phases, as in the reference (Main.py:192) and the
JAX package: each parameter keeps its own moments and step count, and a
phase's step moves exactly the parameters of its mask (``phase_masks``).
``torch.optim.Adam`` skips a parameter whose ``.grad`` is None, so after
each backward a masked parameter that got no gradient is given a zero one
(its moments decay, its count advances and it still moves by
``lr·m̂/(√v̂+ε)``, as the JAX package's masked Adam moves it) and every
other parameter's ``.grad`` is set to None. The KG vocab table is in both
masks, so the phases share its moments; the KG user and item tables enter
the PS phase detached and take no PS step.

The L2 penalty is the reference's quirk: the squared coefficient times
the detached squared norms (TrainTestHelper.py:203-210, 237-244). It
inflates the reported loss and adds no gradient. There is no LR decay.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, FrozenSet, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ihgnn_torch.config import Config
from ihgnn_torch.data.dataset import (Batch, EvalLogs, GraphData,
                                      TrainSampler, prefetch)
from ihgnn_torch.data.srrl_sampler import MetaPaths, SrrlKGSampler
from ihgnn_torch.device import DeviceLike, model_device
from ihgnn_torch.models.srrl import KG_MODES, Srrl
from ihgnn_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from ihgnn_torch.train.controller import EpochSchedule
from ihgnn_torch.train.eval import evaluate
from ihgnn_torch.train.metrics import (EpochStats, MetricsCollection,
                                       ranking_metrics)
from ihgnn_torch.train.train import batch_putter, bce_with_logits
from ihgnn_torch.utils.logging import log_print

KG_MODULES = ("KG", "kg_aggre_head", "kg_aggre_query", "kg_aggre_tail",
              "kg_mlp_pre")
PS_MODULES = ("PS", "g_u", "g_i", "ps_mlp_uq", "ps_mlp_ui", "ps_mlp_pred",
              "prediction_layer")


def phase_masks(model: Srrl) -> Tuple[FrozenSet[str], FrozenSet[str]]:
    """(KG, PS) sets of the parameter names each phase trains: the KG
    space and heads; the PS space, the fusions and the scorer, and the KG
    vocab table (queries are embedded un-detached in the PS phase)."""
    kg, ps = set(), set()
    for name, _ in model.named_parameters():
        top = name.split(".")[0]
        if top in KG_MODULES:
            kg.add(name)
        if top in PS_MODULES or name == "KG.vocab_table":
            ps.add(name)
    return frozenset(kg), frozenset(ps)


def make_optimizer(model: Srrl, lr: float) -> torch.optim.Adam:
    """The one Adam (0.9, 0.999, eps 1e-8, no weight decay) both phases
    share."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def _phase_update(model: Srrl, optimizer: torch.optim.Optimizer,
                  mask: FrozenSet[str]) -> Callable[[torch.Tensor], None]:
    """``update(loss)``: backward, then one Adam step over ``mask``'s
    parameters alone."""
    inside = [p for n, p in model.named_parameters() if n in mask]
    outside = [p for n, p in model.named_parameters() if n not in mask]

    def update(loss: torch.Tensor) -> None:
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for p in inside:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        for p in outside:
            p.grad = None
        optimizer.step()

    return update


def _query_words(model: Srrl, query_words, query_word_counts,
                 dev: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    words = np.asarray(query_words)
    if len(words) != model.query_count:
        raise ValueError(f"query_words has {len(words)} rows; the model "
                         f"has {model.query_count} queries")
    return (torch.as_tensor(words, dtype=torch.int64).to(dev),
            torch.as_tensor(np.asarray(query_word_counts),
                            dtype=torch.int64).to(dev))


def _l2_term(tables, coeff: float) -> torch.Tensor:
    """The reference's penalty: coeff² · Σ‖table‖², detached."""
    return (coeff * coeff * sum((t.detach() ** 2).sum() for t in tables))


def make_kg_steps(model: Srrl, query_words, query_word_counts,
                  optimizer: torch.optim.Optimizer, cfg: Config,
                  device: DeviceLike = "cuda"
                  ) -> Dict[str, Callable[..., torch.Tensor]]:
    """One step function a KG mode: ``step(triples, negs, weights,
    company) -> loss`` (host arrays in, a 0-d tensor on the device
    out)."""
    dev = model_device(model, device)
    qw, qc = _query_words(model, query_words, query_word_counts, dev)
    put = batch_putter(dev)
    update = _phase_update(model, optimizer, phase_masks(model)[0])
    uni_weight = cfg.model.srrl_uni_weight
    reg = cfg.model.srrl_regularization
    kg = model.KG

    def build(mode):
        def step(triples, negs, weights, company) -> torch.Tensor:
            triples, negs, company = put(triples), put(negs), put(company)
            weights = put(weights)
            neg_scores = model.trainkg(triples, negs, company, mode, qw, qc)
            neg_score = F.logsigmoid(-neg_scores).mean(1)
            pos_scores = model.trainkg(triples, None, company, mode, qw, qc)
            pos_score = F.logsigmoid(pos_scores)[:, 0]
            if uni_weight:
                pos_loss, neg_loss = -pos_score.mean(), -neg_score.mean()
            else:
                wsum = weights.sum()
                pos_loss = -(weights * pos_score).sum() / wsum
                neg_loss = -(weights * neg_score).sum() / wsum
            loss = (pos_loss + neg_loss) / 2
            if reg != 0.0:
                loss = loss + _l2_term((kg.user_table, kg.vocab_table,
                                        kg.item_table), reg)
            update(loss)
            return loss.detach()
        return step

    return {mode: build(mode) for mode in KG_MODES}


def make_ps_step(model: Srrl, query_words, query_word_counts,
                 optimizer: torch.optim.Optimizer, cfg: Config,
                 device: DeviceLike = "cuda"
                 ) -> Callable[[Batch], torch.Tensor]:
    """``step(batch) -> loss``: the weighted BCE of the PS scores."""
    dev = model_device(model, device)
    qw, qc = _query_words(model, query_words, query_word_counts, dev)
    put = batch_putter(dev)
    update = _phase_update(model, optimizer, phase_masks(model)[1])
    reg = cfg.model.srrl_regularization

    def step(batch: Batch) -> torch.Tensor:
        logits = model(qw, qc, put(batch.users), put(batch.queries),
                       put(batch.items))
        loss = bce_with_logits(logits, put(batch.flags), put(batch.weight))
        if reg != 0.0:
            loss = loss + _l2_term((model.PS.user_table,
                                    model.KG.vocab_table,
                                    model.PS.item_table), reg)
        update(loss)
        return loss.detach()

    return step


def build_srrl(cfg: Config, data: GraphData, device: torch.device) -> Srrl:
    """The run's ``Srrl`` (the MLP scorer, Main.py:176-181) on ``device``,
    its weights drawn from ``cfg.train.seed``."""
    model = Srrl(cfg.model, data.user_count, data.query_count,
                 data.item_count, data.vocab_size, prediction="mlp",
                 generator=torch.Generator().manual_seed(cfg.train.seed))
    return model.to(device)


def eval_batch_size(cfg: Config, item_count: int) -> int:
    """The eval batch: the MLP scorer holds ``[B, chunk, 2d]`` blocks, so
    B is capped at 2^27 / (I · 2d) (``srrl_loop.py:250-252``)."""
    return max(1, min(cfg.train.eval_batch_size,
                      (1 << 27) // max(item_count * 2
                                       * cfg.model.embedding_size, 1)))


def make_eval_fns_srrl(model: Srrl, data: GraphData,
                       device: DeviceLike = "cuda"):
    """``(features_fn, metrics_fn)`` with ``train/eval.py``'s interface:
    ``features_fn()`` is ``all_features``; ``metrics_fn(features, users,
    queries, truth, truth_counts)`` takes host arrays of one eval batch and
    returns its ``[B, 4]`` metric rows on the device."""
    dev = model_device(model, device)
    qw, qc = _query_words(model, data.query_words, data.query_word_counts,
                          dev)

    def features_fn() -> torch.Tensor:
        with torch.inference_mode():
            return model.all_features(qw, qc)

    def metrics_fn(features, users, queries, truth, truth_counts):
        def put(a):
            return torch.as_tensor(np.asarray(a)).to(dev)
        with torch.inference_mode():
            scores = model.score_all_items(features, put(users),
                                           put(queries))
            return ranking_metrics(scores, put(truth), put(truth_counts))

    return features_fn, metrics_fn


def _host_mean(losses) -> float:
    return float(np.mean(torch.stack(losses).cpu().numpy()
                         .astype(np.float64)))


def run_srrl(cfg: Config, data: GraphData, valid: EvalLogs, test: EvalLogs,
             result_dir: str, fn_metrics: str, dev: torch.device,
             lead: bool = True) -> MetricsCollection:
    """The Srrl branch of the experiment: train and evaluate as ``cfg``
    says on ``dev``; returns the per-epoch metrics and ``EpochStats``.
    Each phase's losses stay on the device until the phase ends. Only a
    ``lead`` run writes checkpoints and metrics (under a mesh every rank
    runs its own replica, and rank 0 leads)."""
    t = cfg.train
    model = build_srrl(cfg, data, dev)
    optimizer = make_optimizer(model, t.learning_rate)
    log_print(f"Srrl parameters: "
              f"{sum(p.numel() for p in model.parameters())}")

    epoch_start = 1
    if cfg.io.checkpoint:
        epoch_ckpt = restore_checkpoint(result_dir, cfg.io.checkpoint, model,
                                        optimizer)
        epoch_start = epoch_ckpt + 1
        log_print(f"restored checkpoint at epoch {epoch_ckpt}")

    kg_sampler = SrrlKGSampler(MetaPaths(data), t.batch_size,
                               t.negative_sample_size, seed=t.seed)
    ps_sampler = TrainSampler(data, t.batch_size,
                              t.random_negative_sample_size,
                              t.non_random_negative_sample_size, seed=t.seed)
    kg_steps = make_kg_steps(model, data.query_words, data.query_word_counts,
                             optimizer, cfg, dev)
    ps_step = make_ps_step(model, data.query_words, data.query_word_counts,
                           optimizer, cfg, dev)
    features_fn, metrics_fn = make_eval_fns_srrl(model, data, dev)

    schedule = EpochSchedule(
        t.epoch_count, epoch_start, t.epoch_start_test,
        t.epoch_test_frequency,
        t.epoch_count if cfg.io.store_checkpoint else None,
        1000000 if cfg.io.store_checkpoint else None)
    all_metrics = MetricsCollection(t.use_valid_dataset)
    eval_bs = eval_batch_size(cfg, data.item_count)

    for epoch in schedule.epochs:
        t0 = time.perf_counter()
        kg_avg, kg_count, kg_s = None, 0, None
        if cfg.model.srrl_kg_loss:
            kg_losses = []
            for _ in range(kg_sampler.steps_per_epoch):
                mode, triples, negs, weights, company = kg_sampler.next()
                kg_losses.append(kg_steps[mode](triples, negs, weights,
                                                company))
            kg_avg, kg_count = _host_mean(kg_losses), len(kg_losses)
            kg_s = time.perf_counter() - t0
            log_print(f"[Epoch KG {epoch}] avg loss KG-> {kg_avg:.4f} "
                      f"in {kg_s:.2f}s")

        t1 = time.perf_counter()
        ps_losses = [ps_step(batch) for batch in prefetch(ps_sampler.epoch())]
        avg_loss = _host_mean(ps_losses)
        dt = time.perf_counter() - t0
        schedule.record_train_seconds(dt)
        log_print(f"[Epoch PS {epoch}] avg loss {avg_loss:.4f} <-PS "
                  f"in {time.perf_counter() - t1:.2f}s "
                  f"(remaining {schedule.remaining_text(epoch)})")

        if schedule.is_store_epoch(epoch) and lead:
            name = save_checkpoint(result_dir, epoch, model, optimizer)
            log_print(f"checkpoint saved: {name}")

        eval_s = None
        if schedule.is_test_epoch(epoch):
            t_eval = time.perf_counter()
            feats = features_fn()
            m_t, _, time_t = evaluate(features_fn, metrics_fn, test, eval_bs,
                                      features=feats)
            log_print(f"test done in {time_t:.2f}s over {test.count} logs")
            log_print(m_t.to_string(), put_time_in_single_line=True)
            if t.use_valid_dataset:
                m_v, _, time_v = evaluate(features_fn, metrics_fn, valid,
                                          eval_bs, features=feats)
                log_print(m_v.to_string(), put_time_in_single_line=True)
                all_metrics.add(epoch, m_t, m_v)
                schedule.record_eval_seconds(time_t + time_v)
            else:
                all_metrics.add(epoch, m_t)
                schedule.record_eval_seconds(time_t)
            eval_s = time.perf_counter() - t_eval
            if cfg.io.store_metrics and lead:
                with open(os.path.join(result_dir, fn_metrics), "a",
                          encoding="utf-8") as f:
                    f.write(f"Epoch {epoch} Avg loss {avg_loss:.4f}\n"
                            f"{m_t.to_string()}\n")
        all_metrics.epoch_stats.append(EpochStats(
            epoch=epoch, avg_loss=avg_loss, steps=len(ps_losses), train_s=dt,
            eval_s=eval_s, kg_avg_loss=kg_avg, kg_steps=kg_count,
            kg_s=kg_s))
    return all_metrics
