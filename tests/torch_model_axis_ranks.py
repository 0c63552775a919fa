"""Rank bodies of ``tests/test_torch_model_axis.py`` that a spawned rank
imports: this module imports the port and never JAX. Each body runs on
one rank of ``ihgnn_torch.parallel.ranks`` (``job(mesh, device)``) and
returns CPU tensors; ``run_cli`` starts the CLI's ranks with torchrun, on
one host or as the nodes of a multi-host group."""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

from ihgnn_torch.models.rawgnn import RawGnn
from ihgnn_torch.parallel.ranks import _graph
from ihgnn_torch.parallel.tables import gather_params, shard_tables
from ihgnn_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from ihgnn_torch.train.train import make_optimizer, make_train_step


def _model_and_step(job, mesh):
    users, queries, items, vocab = job.counts
    model = RawGnn(job.cfg, users, queries, items, vocab)
    model.load_state_dict(job.state)
    if mesh is not None:
        model = shard_tables(model, mesh)
    optimizer = make_optimizer(model.parameters(), job.train)
    step = make_train_step(model, _graph(job, mesh), job.query_words,
                           job.query_word_counts, optimizer, device="cpu",
                           mesh=mesh)
    return model, optimizer, step


def save_job(job, directory, steps, mesh, device):
    """``job``'s first ``steps`` steps, then a checkpoint of the
    one-device state in ``directory`` (rank 0 writes); returns the
    losses and the file's name."""
    model, optimizer, step = _model_and_step(job, mesh)
    losses = [step(b).item() for b in job.batches[:steps]]
    name = save_checkpoint(directory, steps, model, optimizer, mesh=mesh)
    return {"losses": losses, "name": name}


def resume_job(job, directory, name, steps, mesh, device):
    """``job``'s steps after the first ``steps``, resumed from checkpoint
    ``name``; returns their losses and the one-device parameters."""
    model, optimizer, step = _model_and_step(job, mesh)
    epoch = restore_checkpoint(directory, name, model, optimizer,
                               mesh=mesh)
    losses = [step(b).item() for b in job.batches[steps:]]
    return {"epoch": epoch, "losses": losses,
            "params": gather_params(model)}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_cli(nodes, per_node, argv, out_dir, timeout=240):
    """``ihgnn_torch.cli *argv --run_record DIR`` in ``nodes`` × ``per_node``
    ranks: ``torchrun --standalone`` for one node, else one torchrun a
    node on 127.0.0.1 (``--nnodes``, ``--node_rank``, a free port), as a
    user starts it across hosts. Returns each rank's record (the epochs'
    losses and the test metrics). A run that outlasts ``timeout`` seconds
    is stopped and raises."""
    record = os.path.join(out_dir, "record")
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    if nodes == 1:
        launches = [["--standalone"]]
    else:
        port = str(free_port())
        launches = [["--nnodes", str(nodes), "--node_rank", str(k),
                     "--master_addr", "127.0.0.1", "--master_port", port]
                    for k in range(nodes)]
    logs = [os.path.join(out_dir, f"node{k}.log")
            for k in range(len(launches))]
    procs = []
    for launch, log in zip(launches, logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "torch.distributed.run", *launch,
                 "--nproc_per_node", str(per_node), "-m", "ihgnn_torch.cli",
                 *argv, "--run_record", record],
                stdout=f, stderr=subprocess.STDOUT, env=env))
    try:
        for proc in procs:
            proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        for proc in procs:
            proc.terminate()       # torchrun stops its workers
        for proc in procs:
            proc.wait(timeout=30)
        raise RuntimeError("torchrun timed out")
    logs = [open(log).read() for log in logs]
    for proc, log in zip(procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"torchrun rc {proc.returncode}: "
                               f"{log[-3000:]}")
    out = []
    for r in range(nodes * per_node):
        with open(os.path.join(record, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out, logs
