"""Run the port's data-parallel train step in S spawned ranks on one
machine, and report what every rank saw.

Each rank is a process started by ``torch.multiprocessing`` (start method
``spawn``), joined to the others by a ``torch.distributed`` process group
that rendezvous through a file in a temporary directory, so concurrent
runs never collide. On the CPU the ranks use gloo; on one card they share
it and use gloo as well (NCCL refuses two ranks on one GPU); with a card
a rank, NCCL, rank r on card r. The CUDA
kernels must be built before the ranks start (``ops/_build.py``
``build``), so that they load ``ihgnn_torch/build/`` and never race to
build it.

``run_jobs(world, jobs, device)`` runs the jobs one after the other in
one spawn of ``world`` ranks (``world`` = 0: in this process, without a
mesh) and returns ``[rank][job]`` results. A job runs on a mesh of
``world / model_axis`` × ``model_axis`` ranks (its ``model_axis``, 1 when
it has none), the tables' rows over all of them with its
``table_shard_both``. A job is a ``TrainJob`` or a picklable
``job(mesh, device)`` of an importable module. A ``TrainJob``'s result
holds the losses of every step, a SHA-256 of every parameter's bytes
after the last step in the one-device format (the tables gathered: equal
on every rank when the replicas agree), the kernel launches during the
steps, the collectives of every step (``collectives.RECORD``), the
rank's persistent parameter and Adam bytes and the chunks of the rank's
routed pack; on request, rank 0's step-0 gradients (after the sum over
ranks) and parameters, one-device format, its features of
``all_features`` before the first step, and each rank's step and
collective times (and among them the softmax's scalar all-reduces and the
tables' gathers). Nothing here imports JAX.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import tempfile
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ihgnn_torch.config import ModelConfig, TrainConfig
from ihgnn_torch.ops.packing import CHUNK_ROWS_CAP


@dataclasses.dataclass
class TrainJob:
    """One run of ``steps`` train steps of ``RawGnn(cfg)`` on the graph of
    the interactions ``uqi`` ``[P, >=3]`` (the hypergraph, or for GCN and
    GAT the 2D graph of ``cfg.graph_completeness``; with
    ``cfg.use_log_hypergraph`` the log hypergraph of ``log_edges``), from
    weights drawn from ``seed`` or the state dict ``state``. ``batches``:
    the whole batches (``Batch``, their rows a multiple of the ranks), one
    a step. ``pack_kernels``: a rank's slice carries the routed pack of
    its edges (on one device, the graph its routed pack), chunked past
    ``chunk_rows_cap`` grid rows."""

    name: str
    cfg: ModelConfig
    counts: tuple                     # users, queries, items, vocab
    uqi: np.ndarray
    query_words: np.ndarray
    query_word_counts: np.ndarray
    batches: list
    seed: int = 0
    state: Optional[dict] = None
    pack_kernels: bool = False
    chunk_rows_cap: int = CHUNK_ROWS_CAP
    # the log hypergraph's edges laid end to end: (member ids, sizes)
    log_edges: Optional[tuple] = None
    bf16_wire: bool = True
    # the mesh's model axis (the tables' rows over it), and the rows over
    # every rank instead
    model_axis: int = 1
    table_shard_both: bool = False
    grad_accum_steps: int = 1
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    keep_state: bool = False          # rank 0's step-0 grads and params
    keep_features: bool = False       # rank 0's features before step 0
    time_steps: int = 0               # the last steps timed (0: none)


def _digest(state: dict) -> str:
    h = hashlib.sha256()
    for name, p in state.items():
        h.update(name.encode())
        h.update(p.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _graph(job: TrainJob, mesh):
    from ihgnn_torch.config import V
    from ihgnn_torch.graph import (build_graph2d, build_hypergraph,
                                   log_hypergraph_from_edges)
    from ihgnn_torch.parallel.sharding import pad_graph_for_mesh, shard_graph
    users, queries, items, _ = job.counts
    nodes = users + queries + items
    uqi = np.asarray(job.uqi)
    if job.cfg.gnn in (V.GCN, V.GAT):
        uqif = uqi if uqi.shape[1] > 3 else np.column_stack(
            [uqi, np.ones(len(uqi), np.int64)])
        graph = build_graph2d(uqif, nodes, users, queries,
                              job.cfg.graph_completeness)
    elif job.cfg.use_log_hypergraph:
        graph = log_hypergraph_from_edges(*job.log_edges, nodes)
    else:
        graph = build_hypergraph(uqi, nodes, users, queries,
                                 pack_kernels=job.pack_kernels
                                 and mesh is None,
                                 chunk_rows_cap=job.chunk_rows_cap)
    if mesh is None:
        return graph
    return shard_graph(pad_graph_for_mesh(graph, mesh.data), mesh,
                       pack_kernels=job.pack_kernels,
                       chunk_rows_cap=job.chunk_rows_cap)


def run_job(job: TrainJob, mesh, device) -> dict:
    """``job`` on this rank (``mesh``, or None: one device)."""
    from ihgnn_torch.models.rawgnn import RawGnn
    from ihgnn_torch.ops import launches
    from ihgnn_torch.parallel import collectives
    from ihgnn_torch.parallel.tables import (gather_grads, gather_params,
                                             shard_tables, state_bytes)
    from ihgnn_torch.train.eval import make_eval_fns
    from ihgnn_torch.train.train import make_optimizer, make_train_step

    dev = torch.device(device)
    users, queries, items, vocab = job.counts
    t0 = time.perf_counter()
    graph = _graph(job, mesh)
    kp = getattr(graph, "kp", None)
    out = {"graph_s": time.perf_counter() - t0,
           "backend": None if mesh is None else mesh.backend,
           "chunks": 0 if kp is None else len(kp.packs)}
    model = RawGnn(job.cfg, users, queries, items, vocab,
                   generator=torch.Generator().manual_seed(job.seed))
    if job.state is not None:
        model.load_state_dict(job.state)
    model = model.to(dev)
    if mesh is not None:
        model = shard_tables(model, mesh)
    lead = mesh is None or mesh.rank == 0
    if job.keep_features:
        # every rank takes part in the forward's collectives
        features_fn, _ = make_eval_fns(model, graph, job.query_words,
                                       job.query_word_counts, device=dev,
                                       mesh=mesh)
        features = features_fn()
        if lead:
            out["features"] = features.cpu()
        del features
    optimizer = make_optimizer(model.parameters(), job.train)
    step = make_train_step(model, graph, job.query_words,
                           job.query_word_counts, optimizer,
                           grad_accum_steps=job.grad_accum_steps,
                           device=dev, mesh=mesh)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    launches.zero_launches()
    losses, step_ms, collective_ms, scalar_ms, table_ms = [], [], [], [], []
    records = []
    timed_from = len(job.batches) - job.time_steps
    for k, batch in enumerate(job.batches):
        collectives.set_recording(True)
        timed = job.time_steps and k >= timed_from
        if timed:
            if cuda:
                torch.cuda.synchronize(dev)
            collectives.set_timing(True)
            t0 = time.perf_counter()
        loss = step(batch)
        if timed:
            if cuda:
                torch.cuda.synchronize(dev)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            collectives.set_timing(False)
            collective_ms.append(sum(ms for _, ms in collectives.TIMES))
            scalar_ms.append(sum(ms for kind, ms in collectives.TIMES
                                 if kind == "scalar"))
            table_ms.append(sum(ms for kind, ms in collectives.TIMES
                                if kind == "table"))
        collectives.set_recording(False)
        records.append(list(collectives.RECORD))
        losses.append(loss.item())
        if k == 0 and job.keep_state:
            # every rank takes part in gathering the table blocks' grads
            grads = gather_grads(model)
            if lead:
                out["grads0"] = {n: g.cpu() for n, g in grads.items()}
            del grads
    out["launches"] = launches.launch_counts()
    if cuda:
        out["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated(
            dev)
    out["losses"] = losses
    out["collectives"] = records
    out["state_bytes"] = state_bytes(model, optimizer)
    params = gather_params(model)
    out["digest"] = _digest(params)
    if job.keep_state and lead:
        out["params"] = {n: v.cpu() for n, v in params.items()}
    del params
    if job.time_steps:
        out["step_ms"] = step_ms
        out["collective_ms"] = collective_ms
        out["scalar_collective_ms"] = scalar_ms
        out["table_collective_ms"] = table_ms
    return out


def _rank_main(rank: int, world: int, store: str, results: str, jobs,
               device: str, backend: str) -> None:
    import torch.distributed as dist

    from ihgnn_torch.config import MeshConfig
    from ihgnn_torch.parallel.mesh import make_mesh
    # the ranks share the host's cores; with NCCL each has a card
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    if backend == "nccl":
        device = f"cuda:{rank}"
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        out = []
        for job in jobs:
            model = getattr(job, "model_axis", 1)
            mesh = make_mesh(MeshConfig(data=world // model, model=model),
                             backend,
                             bf16_wire=getattr(job, "bf16_wire", True),
                             table_shard_both=getattr(job, "table_shard_both",
                                                      False))
            out.append(run_job(job, mesh, device)
                       if isinstance(job, TrainJob) else job(mesh, device))
        torch.save(out, os.path.join(results, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_jobs(world: int, jobs: Sequence[TrainJob], device: str = "cpu",
             backend: Optional[str] = None) -> List[List[dict]]:
    """``[rank][job]`` results of ``jobs`` run in ``world`` spawned ranks
    (``world`` = 0: one device, in this process). ``backend``: the
    process group's, by default ``pick_backend``'s (NCCL with a card a
    rank, rank r on card r; else gloo, every rank on ``device``)."""
    if world == 0:
        return [[run_job(job, None, device) if isinstance(job, TrainJob)
                 else job(None, device) for job in jobs]]
    import torch.multiprocessing as mp

    from ihgnn_torch.parallel.mesh import pick_backend
    backend = backend or pick_backend(world, torch.device(device))
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank_main, args=(world, os.path.join(tmp, "store"),
                                             tmp, list(jobs), device,
                                             backend),
                           nprocs=world, join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
