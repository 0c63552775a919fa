"""Experiment runner: ``python -m ihgnn_torch.cli --dataset DIR ...``.

Counterpart of ``ihgnn_tpu/cli.py`` (the reference's Main.py:20-327), with
the same flags: load the Step-3 artifacts, build the model on the device,
optionally resume from a checkpoint, train with the test/store cadence and
the LR decay, evaluate full-catalog HR/NDCG/MAP/MRR@10 on test and valid,
write ``train_log.txt``, ``<stamp>_metrics.txt`` and the long-tail CSV, and
report the best epoch by valid NDCG@10. It runs on the card unless
``--device cpu`` is given.

``--model srrl`` trains Srrl by its alternating KG/PS loop
(``train/srrl_loop.py`` ``run_srrl``), as ``ihgnn_tpu/cli.py:139-141``
does. ``--bf16_stream`` and ``--remat`` run (``models/rawgnn.py``);
the CLI builds no routed pack, so its graphs take the direct path.

``--mesh_data D --mesh_model M`` trains over D × M ranks
(``parallel/``), one process each, started by ``torchrun --standalone
--nproc_per_node D·M -m ihgnn_torch.cli --mesh_data D --mesh_model M
...``, whose ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and
``LOCAL_WORLD_SIZE`` it reads. A rank runs on card ``LOCAL_RANK`` with
NCCL when its host has a card for each of its ranks, else every rank of
the host on card 0 with gloo (the one layout one card allows; ``--device
cpu``: gloo on the CPU); the log says which. The ranks build the same
model from the seed and the graph; the ranks of data index k keep the
k-th slice of the padded edges and of each batch's rows (the sampler pads
rows to a multiple of D), and with M > 1 each rank keeps its block of the
embedding tables' rows and of their Adam moments (``parallel/tables.py``),
so every rank ends each step with the same replicated parameters. Rank 0
alone writes the result directory, the log, the metrics, the long-tail CSV
and the checkpoints (one-device format: the tables gathered), under a
stamp it broadcasts; a resume reads rank 0's checkpoint on every rank and
cuts out its blocks, on any mesh. Every layer type runs under a mesh: GAT
and phase-2 attention with a softmax over every rank's entries, the log
hypergraph in blocks of whole edges.

``--multihost`` runs one process group across hosts, the counterpart of
``jax.distributed.initialize()`` (``ihgnn_tpu/cli.py:66-69``): torchrun
on each host (``--nnodes H --node_rank i --nproc_per_node P
--master_addr ADDR --master_port PORT``), the backend and card chosen by
the host's own ranks; the result directory must be on a file system that
every host sees, as rank 0 writes it and every rank reads its
checkpoint. Without it a process group that spans hosts is refused.

``--model srrl`` under a mesh runs as ``ihgnn_tpu/cli.py:139-141`` does:
the JAX package builds the mesh and runs ``run_srrl`` without it, on one
device. Here every rank runs ``run_srrl`` on its own card from the same
seed, and rank 0 alone writes.

The epoch loop queues the train steps without waiting for the card: each
step's loss stays a tensor on the device, and the epoch's losses reach the
host once, after its last step.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ihgnn_torch.config import Config, V, parse_args
from ihgnn_torch.data.dataset import (Batch, EvalLogs, GraphData,
                                      TrainSampler, prefetch)
from ihgnn_torch.device import resolve_device
from ihgnn_torch.models.rawgnn import RawGnn
from ihgnn_torch.ops.hyperagg import strip_kernel_packing
from ihgnn_torch.parallel import (Mesh, make_mesh, pad_graph_for_mesh,
                                  pick_backend, shard_graph)
from ihgnn_torch.parallel.tables import shard_tables
from ihgnn_torch.train.checkpoint import (find_latest, restore_checkpoint,
                                          save_checkpoint)
from ihgnn_torch.train.controller import EpochSchedule
from ihgnn_torch.train.eval import evaluate, make_eval_fns
from ihgnn_torch.train.metrics import EpochStats, Metrics, MetricsCollection
from ihgnn_torch.train.srrl_loop import run_srrl
from ihgnn_torch.train.train import (adjust_lr_after_epoch, make_optimizer,
                                     make_train_step)
from ihgnn_torch.utils.logging import end_logging, log_print, start_logging


def result_dir_name(cfg: Config) -> str:
    """Result directory naming convention (Main.py:80-88):
    <dataset parts>-<Model>[-<L><Layer>][-O<order>]-emb<size>."""
    parts = [p for p in cfg.io.data_dir.strip("/").split("/") if p][-2:]
    model_names = {V.RAWGNN: "RawGnn", V.SRRL: "Srrl"}
    layer_names = {V.GCN: "GCNLayer", V.GAT: "GATLayer",
                   V.HGCN: "HGCNLayer", V.IHGNN: "IHGNNLayer"}
    parts.append(model_names[cfg.model.model])
    if cfg.model.model == V.RAWGNN:
        parts.append(f"{cfg.model.gnn_layer_count}"
                     f"{layer_names[cfg.model.gnn]}")
        if cfg.model.gnn == V.IHGNN:
            parts.append(f"O{cfg.model.feature_interaction_order}")
    parts.append(f"emb{cfg.model.embedding_size}")
    return os.path.join(cfg.io.result_dir, "-".join(parts))


def pick_graph(data: GraphData, cfg: Config):
    if cfg.model.gnn in (V.GCN, V.GAT):
        return data.graph2d
    if cfg.model.use_log_hypergraph:
        if cfg.model.gnn != V.HGCN:
            raise ValueError("--log_hypergraph requires --gnn hgcn "
                             "(ragged edges have no fixed-order interaction)")
        return data.log_hypergraph
    return data.hypergraph


def start_ranks(cfg: Config) -> Tuple[torch.device, Optional[Mesh]]:
    """The run's device and, for a mesh of more than one rank (or
    ``--multihost``), its ``Mesh``: the process group of torchrun's ranks
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
    ``MASTER_ADDR``/``MASTER_PORT``), each on card ``LOCAL_RANK`` with
    NCCL when its host has a card a rank, else on one card (or the CPU)
    with gloo."""
    if cfg.mesh.device_count <= 1 and not cfg.runtime.multihost:
        return resolve_device(cfg.runtime.device), None
    ranks = cfg.mesh.device_count
    if "WORLD_SIZE" not in os.environ:
        raise ValueError(f"--mesh_data {cfg.mesh.data} --mesh_model "
                         f"{cfg.mesh.model} runs one process a rank: start "
                         "it with torchrun --standalone --nproc_per_node "
                         f"{ranks} -m ihgnn_torch.cli ... (across hosts: "
                         "--nnodes and --multihost)")
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if local_world != world and not cfg.runtime.multihost:
        raise ValueError(f"the process group spans hosts ({world} ranks, "
                         f"{local_world} on this host): pass --multihost")
    dev = resolve_device(cfg.runtime.device)
    backend = pick_backend(local_world, dev)
    if dev.type == "cuda":
        dev = torch.device("cuda", local if backend == "nccl" else 0)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method="env://",
                            rank=int(os.environ["RANK"]), world_size=world)
    return dev, make_mesh(cfg.mesh, backend)


def broadcast_from_rank0(value, mesh: Optional[Mesh]):
    """``value`` as rank 0 has it (a picklable object)."""
    if mesh is None:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0, group=mesh.world_group)
    return box[0]


def checkpoint_name(cfg: Config, result_dir: str,
                    mesh: Optional[Mesh]) -> str:
    """``--checkpoint`` as rank 0 resolves it (``latest``: its newest
    ``checkpoint_*`` file), on every rank."""
    name = cfg.io.checkpoint
    if name == "latest" and (mesh is None or mesh.rank == 0):
        name = find_latest(result_dir) or name
    return broadcast_from_rank0(name, mesh)


def build_model(cfg: Config, data: GraphData,
                device: torch.device) -> RawGnn:
    """The run's ``RawGnn`` on ``device``, its weights drawn from
    ``cfg.train.seed``."""
    model = RawGnn(cfg.model, data.user_count, data.query_count,
                   data.item_count, data.vocab_size,
                   generator=torch.Generator().manual_seed(cfg.train.seed))
    return model.to(device)


def _host_count() -> int:
    """The hosts of torchrun's process group (``GROUP_WORLD_SIZE``: its
    nodes), 1 without torchrun."""
    return int(os.environ.get("GROUP_WORLD_SIZE", 1))


def _device_text(dev: torch.device) -> str:
    if dev.type == "cuda":
        return f"{dev} ({torch.cuda.get_device_name(dev)})"
    return str(dev)


def run(cfg: Config) -> MetricsCollection:
    """One experiment: train and evaluate as ``cfg`` says, tee the log
    into the result directory, and return the per-epoch metrics and
    ``EpochStats``."""
    dev, mesh = start_ranks(cfg)
    lead = mesh is None or mesh.rank == 0
    try:
        result_dir, stamp = broadcast_from_rank0(
            (result_dir_name(cfg),
             time.strftime("%y%m%d-%H%M%S", time.localtime())), mesh)
        fn_log = (f"{stamp}_train_log.txt" if cfg.io.store_metrics
                  else "train_log.txt")
        fn_metrics = f"{stamp}_metrics.txt"
        if lead:
            os.makedirs(result_dir, exist_ok=True)
            start_logging(os.path.join(result_dir, fn_log))
        else:
            start_logging(None, echo=False)
        try:
            return _run(cfg, dev, result_dir, fn_metrics, mesh)
        finally:
            end_logging()
    finally:
        if mesh is not None:
            dist.destroy_process_group()


def _run(cfg: Config, dev: torch.device, result_dir: str,
         fn_metrics: str, mesh: Optional[Mesh] = None) -> MetricsCollection:
    t = cfg.train
    lead = mesh is None or mesh.rank == 0
    log_print(f"device: {_device_text(dev)}")
    log_print(f"mesh: data={cfg.mesh.data} model={cfg.mesh.model}"
              + ("" if mesh is None else
                 f" | {mesh.data * mesh.model} ranks on "
                 f"{_host_count()} host(s), backend {mesh.backend}, bf16 "
                 f"wire {'on' if mesh.bf16_wire else 'off'}"))
    log_print(f"batch size: {t.batch_size} | lr: {t.learning_rate} | "
              f"emb: {cfg.model.embedding_size} | wd: {t.weight_decay}")
    log_print(f"neg sampling rand/nonrand: {t.random_negative_sample_size}/"
              f"{t.non_random_negative_sample_size}")
    log_print(f"model: {cfg.model.model} | gnn: {cfg.model.gnn} x "
              f"{cfg.model.gnn_layer_count} | order: "
              f"{cfg.model.feature_interaction_order} | dataset: "
              f"{cfg.io.data_dir}")

    # ---- data ----
    # dataset-root indirection: the first line of ./dataset_dir.txt
    # prefixes a relative dataset path that does not exist (Main.py:73-77)
    data_dir = cfg.io.data_dir
    if not os.path.isabs(data_dir) and os.path.exists("./dataset_dir.txt"):
        with open("./dataset_dir.txt", "r", encoding="utf-8") as f:
            root = f.readline().strip()
        if root and not os.path.exists(data_dir):
            data_dir = os.path.join(root, data_dir)
            log_print(f"dataset root indirection: {data_dir}")
    cfg = dataclasses_replace_io(cfg, data_dir)

    log_print("loading dataset...")
    data = GraphData.from_files(
        cfg.io.data_dir, "train",
        graph_completeness=cfg.model.graph_completeness,
        user_history_limit=cfg.runtime.user_history_limit)
    valid = EvalLogs.from_file(os.path.join(cfg.io.data_dir,
                                            "valid_data.csv"))
    test = EvalLogs.from_file(os.path.join(cfg.io.data_dir, "test_data.csv"))
    log_print(f"users {data.user_count} queries {data.query_count} items "
              f"{data.item_count} vocab {data.vocab_size} logs "
              f"{len(data.search_logs)} positives {data.pos_count}")
    log_print(f"valid logs {valid.count}/{valid.line_count}; "
              f"test logs {test.count}/{test.line_count}")

    if cfg.model.model == V.SRRL:
        # under a mesh every rank trains its own replica from the seed on
        # its card (the JAX package runs Srrl on one device); rank 0 writes
        if cfg.io.checkpoint:
            cfg = dataclasses.replace(cfg, io=dataclasses.replace(
                cfg.io, checkpoint=checkpoint_name(cfg, result_dir, mesh)))
        all_metrics = run_srrl(cfg, data, valid, test, result_dir,
                               fn_metrics, dev, lead=lead)
        if lead:
            report_best(cfg, all_metrics, result_dir, fn_metrics)
        if cfg.runtime.run_record:
            write_run_record(cfg.runtime.run_record,
                             0 if mesh is None else mesh.rank,
                             None if mesh is None else mesh.backend,
                             all_metrics)
        return all_metrics

    # ---- model ----
    graph = pick_graph(data, cfg)
    if not cfg.runtime.use_pallas and getattr(graph, "kp", None) is not None:
        graph = strip_kernel_packing(graph)
        log_print("routed kernel pack stripped (--no_pallas): direct path")
    if mesh is not None:
        graph = shard_graph(pad_graph_for_mesh(graph, mesh.data), mesh)
    model = build_model(cfg, data, dev)
    if mesh is not None:
        # a rank's blocks of the tables' rows (model axis); before Adam
        model = shard_tables(model, mesh)
    optimizer = make_optimizer(model.parameters(), t)
    log_params(model)

    # ---- checkpoint resume (Main.py:195-214): rank 0's file on every
    # rank ----
    epoch_start = 1
    if cfg.io.checkpoint:
        epoch_ckpt = restore_checkpoint(
            result_dir, checkpoint_name(cfg, result_dir, mesh), model,
            optimizer, mesh=mesh)
        epoch_start = epoch_ckpt + 1
        log_print(f"restored checkpoint at epoch {epoch_ckpt}")

    # a fresh sampler after a resume too: its first epoch draws the
    # negatives of the first run's first epoch, as the JAX package does;
    # under a mesh its rows pad to a multiple of the ranks
    sampler = TrainSampler(data, t.batch_size, t.random_negative_sample_size,
                           t.non_random_negative_sample_size, seed=t.seed,
                           row_multiple=1 if mesh is None else mesh.data)
    train_step = make_train_step(model, graph, data.query_words,
                                 data.query_word_counts, optimizer,
                                 grad_accum_steps=t.grad_accum_steps,
                                 device=dev, mesh=mesh)
    features_fn, metrics_fn = make_eval_fns(model, graph, data.query_words,
                                            data.query_word_counts,
                                            device=dev, mesh=mesh)

    # ---- epoch loop (Main.py:238-290) ----
    schedule = EpochSchedule(
        t.epoch_count, epoch_start, t.epoch_start_test,
        t.epoch_test_frequency,
        t.epoch_count if cfg.io.store_checkpoint else None,
        1000000 if cfg.io.store_checkpoint else None)
    all_metrics = MetricsCollection(t.use_valid_dataset)
    log_print(f"training: epochs {t.epoch_count} | test from "
              f"{t.epoch_start_test} every {t.epoch_test_frequency}")

    for epoch in schedule.epochs:
        t0 = time.perf_counter()
        # profile the second epoch (the first carries one-time set-up)
        prof = None
        if (cfg.runtime.profile_dir is not None and epoch == epoch_start + 1
                and lead):
            prof = _start_profiler(dev)
        losses = [train_step(batch) for batch in
                  prefetch(batched_epoch(sampler, t.grad_accum_steps))]
        loss_values = torch.stack(losses).cpu().numpy().astype(np.float64)
        if t.grad_accum_steps > 1:
            # accumulation steps return the sums of their microbatches
            avg_loss = float(loss_values.sum()) / sampler.steps_per_epoch
        else:
            avg_loss = float(np.mean(loss_values))
        if prof is not None:
            path = _stop_profiler(prof, dev, cfg.runtime.profile_dir, epoch)
            log_print(f"profiler trace written to {path}")
        dt = time.perf_counter() - t0
        schedule.record_train_seconds(dt)
        log_print(f"[Epoch {epoch}/{schedule.last_epoch}] avg loss "
                  f"{avg_loss:.4f} on {data.pos_count} positives in "
                  f"{dt:.2f}s (remaining {schedule.remaining_text(epoch)})")

        if adjust_lr_after_epoch(optimizer, avg_loss, t):
            log_print(f"learning rate adjusted to "
                      f"{optimizer.param_groups[0]['lr']:.6f}")

        if cfg.runtime.debug_stats:
            from ihgnn_torch.utils import debug
            ue, ve, ie = debug.embedding_info(model)
            log_print(f"[debug] embedding absmean user={ue:.6f} "
                      f"vocab={ve:.6f} item={ie:.6f}")
            for s in debug.feature_stats_from(features_fn(),
                                              cfg.model.embedding_size,
                                              cfg.model.gnn_layer_count):
                log_print(f"[debug] layer {s['layer']}: "
                          f"absmean={s['absmean']:.6f} std={s['std']:.6f}")

        if schedule.is_store_epoch(epoch):
            # under a mesh every rank gathers its table blocks, rank 0
            # writes the one-device state
            name = save_checkpoint(result_dir, epoch, model, optimizer,
                                   mesh=mesh)
            if mesh is not None:
                dist.barrier(group=mesh.world_group)
            if lead:
                log_print(f"checkpoint saved: {name}")

        eval_s = None
        if schedule.is_test_epoch(epoch):
            t_eval = time.perf_counter()
            collect = bool(cfg.io.long_tail_filename)
            # one full-graph forward for test and valid (every rank takes
            # part in its collectives; rank 0 scores)
            feats = features_fn()
        if schedule.is_test_epoch(epoch) and lead:
            m_t, rows, time_t = evaluate(features_fn, metrics_fn, test,
                                         t.eval_batch_size,
                                         collect_rows=collect,
                                         features=feats)
            log_print(f"test done in {time_t:.2f}s over {test.count} logs")
            log_print(m_t.to_string(), put_time_in_single_line=True)

            if collect:
                write_long_tail(os.path.join(result_dir,
                                             cfg.io.long_tail_filename),
                                data, test, rows)

            if t.use_valid_dataset:
                m_v, _, time_v = evaluate(features_fn, metrics_fn, valid,
                                          t.eval_batch_size, features=feats)
                log_print(f"valid done in {time_v:.2f}s")
                log_print(m_v.to_string(), put_time_in_single_line=True)
                all_metrics.add(epoch, m_t, m_v)
                schedule.record_eval_seconds(time_t + time_v)
            else:
                all_metrics.add(epoch, m_t)
                schedule.record_eval_seconds(time_t)
            eval_s = time.perf_counter() - t_eval

            if cfg.io.store_metrics:
                with open(os.path.join(result_dir, fn_metrics), "a",
                          encoding="utf-8") as f:
                    f.write(f"Epoch {epoch} Avg loss {avg_loss:.4f}\n"
                            f"{m_t.to_string()}\n")
        all_metrics.epoch_stats.append(EpochStats(
            epoch=epoch, avg_loss=avg_loss, steps=len(losses), train_s=dt,
            eval_s=eval_s))

    if lead:
        report_best(cfg, all_metrics, result_dir, fn_metrics)
    if cfg.runtime.run_record:
        write_run_record(cfg.runtime.run_record,
                         0 if mesh is None else mesh.rank,
                         None if mesh is None else mesh.backend,
                         all_metrics)
    return all_metrics


def write_run_record(directory: str, rank: int, backend: Optional[str],
                     all_metrics: MetricsCollection) -> None:
    """``directory/rank<rank>.json``: the mesh's backend (None on one
    device), this process's kernel launch counts and counters
    (``utils/tracing.py``: the feed's batches and waits, the kernel
    libraries compiled and loaded), the run's epoch stats
    and (rank 0) its test metrics by epoch, in full precision."""
    import json

    from ihgnn_torch.ops.launches import launch_counts
    from ihgnn_torch.utils.tracing import COUNTERS
    os.makedirs(directory, exist_ok=True)
    record = {"backend": backend, "launches": launch_counts(),
              "counters": dict(COUNTERS),
              "epochs": [dataclasses.asdict(s)
                         for s in all_metrics.epoch_stats],
              "test": [(e, m.as_row()) for e, m in
                       all_metrics.iter_epoch_test()]}
    with open(os.path.join(directory, f"rank{rank}.json"), "w",
              encoding="utf-8") as f:
        json.dump(record, f)


def _start_profiler(dev: torch.device):
    """A started profiler, with the port's spans on (``utils/tracing.py``):
    its trace names the phases of each step."""
    from torch.profiler import ProfilerActivity, profile

    from ihgnn_torch.utils import tracing
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    tracing.enable()
    return prof


def _stop_profiler(prof, dev: torch.device, profile_dir: str,
                   epoch: int) -> str:
    """Stop ``prof`` once the device is done and write its Chrome trace
    under ``profile_dir``; returns the trace's path."""
    from ihgnn_torch.utils import tracing
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    tracing.disable()
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"epoch{epoch}.trace.json")
    prof.export_chrome_trace(path)
    return path


def dataclasses_replace_io(cfg: Config, data_dir: str) -> Config:
    return dataclasses.replace(cfg, io=dataclasses.replace(cfg.io,
                                                           data_dir=data_dir))


def batched_epoch(sampler: TrainSampler, grad_accum_steps: int):
    """Yield batches, or ``[k, R]``-stacked groups (``Batch.stack``) when
    accumulating; the final partial group is padded with all-zero batches,
    whose weight 0 keeps them out of the loss."""
    if grad_accum_steps == 1:
        yield from sampler.epoch()
        return
    group = []
    for batch in sampler.epoch():
        group.append(batch)
        if len(group) == grad_accum_steps:
            yield Batch.stack(group)
            group = []
    if group:
        filler = Batch(*(np.zeros_like(getattr(group[0], f.name))
                         for f in dataclasses.fields(Batch)))
        group += [filler] * (grad_accum_steps - len(group))
        yield Batch.stack(group)


def log_params(model: torch.nn.Module) -> None:
    """Aligned parameter table with mean/std/absmean
    (Helpers/TrainTestHelper.py:12-34)."""
    rows = []
    total = 0
    for name, param in model.named_parameters():
        arr = param.detach().cpu().numpy()
        total += arr.size
        rows.append((name, str(arr.shape), float(arr.mean()),
                     float(arr.std()), float(np.abs(arr).mean())))
    if not rows:
        return
    w_name = max(len(r[0]) for r in rows)
    w_size = max(len(r[1]) for r in rows)
    log_print(f"Model Parameters ({len(rows)}):")
    for name, size, mean, std, absmean in rows:
        log_print(f"{name:<{w_name}} | size={size:<{w_size}} "
                  f"| mean={mean:<8.3f} | std={std:<8.3f} "
                  f"| absmean={absmean:<8.3f}")
    log_print(f"total parameters: {total}")


def write_long_tail(path: str, data: GraphData, test: EvalLogs,
                    rows: np.ndarray) -> None:
    """Per-user averaged metrics CSV: user, history length, HR, NDCG, MAP
    (Main.py:269-277)."""
    _, item_history = data.user_history()
    sums = np.zeros((data.user_count, 4))
    counts = np.zeros(data.user_count, np.int64)
    for i, u in enumerate(test.users):
        sums[u] += rows[i]
        counts[u] += 1
    with open(path, "w", encoding="utf-8") as f:
        for u in range(data.user_count):
            hist = len(item_history[u])
            if counts[u] == 0:
                f.write(f"{u},{hist},,,\n")
            else:
                hr, ndcg, m_ap, _ = sums[u] / counts[u]
                f.write(f"{u},{hist},{hr:.4f},{ndcg:.4f},{m_ap:.4f}\n")


def report_best(cfg: Config, all_metrics: MetricsCollection,
                result_dir: str, fn_metrics: str) -> None:
    """Best-epoch selection by valid NDCG@10 and the metrics file's
    epilogue (Main.py:292-325)."""
    if not list(all_metrics.iter_epoch_test()):
        return
    if cfg.train.use_valid_dataset:
        best_epoch, best_test, best_valid = all_metrics.get_valid_best(
            key=lambda m: m.NDCG_at10)
        log_print(f"Best valid metrics at epoch {best_epoch}:")
        log_print(best_valid.to_string(), put_time_in_single_line=True)
        log_print("Corresponding test metrics:")
        log_print(best_test.to_string(), put_time_in_single_line=True)
    else:
        best_epoch, best_test = all_metrics.get_test_best(
            key=lambda m: m.NDCG_at10)
        best_valid = None
        log_print(f"Best test metrics at epoch {best_epoch}:")
        log_print(best_test.to_string(), put_time_in_single_line=True)

    if cfg.io.store_metrics:
        with open(os.path.join(result_dir, fn_metrics), "a",
                  encoding="utf-8") as f:
            if best_valid is not None:
                f.write(f"\n\nBest valid metrics at epoch {best_epoch}:\n")
                f.write(best_valid.to_string())
                f.write("\nCorresponding test metrics:\n")
            else:
                f.write("\nBest test metrics:\n")
            f.write(best_test.to_string() + "\n")
            f.write(f"\n\nAll TEST metrics:\nEpoch {Metrics.title}\n")
            for e, m in all_metrics.iter_epoch_test():
                f.write(f"{e} {m.to_string(no_title=True)}\n")
            if cfg.train.use_valid_dataset:
                f.write(f"\n\nAll VALID metrics:\nEpoch {Metrics.title}\n")
                for e, _, m in all_metrics.iter_epoch_test_valid():
                    f.write(f"{e} {m.to_string(no_title=True)}\n")


def main(argv=None) -> MetricsCollection:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
