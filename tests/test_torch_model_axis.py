"""The port's model axis (``ihgnn_torch/parallel/tables.py``: the
embedding tables' rows and their Adam moments over ranks), ``--multihost``,
Srrl under a mesh, the dry run (``ihgnn_torch/entry.py``) and the
collective stats (``ihgnn_torch/utils/collective_stats.py``), on the CPU.

The port runs 4 gloo ranks, spawned processes that import the port and
never JAX (``ihgnn_torch.parallel.ranks``, ``tests/torch_model_axis_ranks.py``),
at meshes (2, 2), (1, 4) and (2, 2) with ``table_shard_both``; the JAX
side runs in this process on its 8 virtual CPU devices at mesh (2, 2)
with ``table_row_multiple=2``. Inputs are ``tests/test_torch_sharding.py``'s
(``make_synthetic_data`` at U/Q/I/V = 9/7/13/11, 80 logs, d = 8, batches
of 16 × 4 rows a multiple of 4, JAX's initial weights carried over) with 3
steps. Tolerances are that file's: 1e-5 against the port's one device
(losses relative; features, step-0 gradients of scale, score heads of
their layer's; parameters absolute, score-head rounding noise within
``ADAM_NOISE_ATOL``); bf16 streams over the bf16 wire 2e-2 of scale and
1e-3 for losses, 5e-4 for parameters; against JAX's mesh loss 1e-4
relative, parameters 5e-4. Every rank must end with the same one-device
parameters, bit for bit.
"""

import functools
import os

import jax
import numpy as np
import pytest
import torch

from ihgnn_torch import config as tcfg
from ihgnn_torch.convert import params_from_jax
from ihgnn_torch.parallel import Mesh, pick_backend
from ihgnn_torch.parallel.ranks import TrainJob, run_jobs
from ihgnn_torch.parallel.tables import block_rows, shard_params
from ihgnn_torch.utils.collective_stats import (collective_stats, comm_bytes,
                                                collective_table)
from ihgnn_tpu.config import MeshConfig, ModelConfig, V
from ihgnn_tpu.models.rawgnn import RawGnn
from ihgnn_tpu.parallel.mesh import make_mesh as jax_mesh
from ihgnn_tpu.parallel.sharding import pad_graph2d_for_mesh as jax_pad2d
from ihgnn_tpu.parallel.sharding import pad_hypergraph_for_mesh as jax_pad

import torch_model_axis_ranks as ranks_body
from test_torch_sharding import (COUNTS, D, I, JAX_LOSS_RTOL, JAX_PARAM_TOL,
                                 Q, TOL, U, VOCAB, _grad_scale, _hyper,
                                 _jax_graph, _jax_run, _noise, _np_tree,
                                 _port_batch, _rel)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")

RANKS, STEPS, SAVE_AFTER = 4, 3, 2
BF16_TOL, BF16_LOSS_RTOL = 2e-2, 1e-3
# Adam moves a parameter by up to lr a step whatever its gradient: a
# score head's noise gradient whose sign differs moves it by 2 lr a step
ADAM_NOISE_ATOL = 2 * tcfg.TrainConfig().learning_rate * STEPS
# mesh: (model axis, table_shard_both) on RANKS ranks
MESHES = {"2x2": (2, False), "1x4": (4, False), "2x2_both": (2, True)}
# path: (ModelConfig fields, TrainJob fields)
PATHS = {"ihgnn": ({}, {}), "routed": ({}, {"pack_kernels": True}),
         "gat": ({"gnn": V.GAT}, {}), "bf16": ({"bf16_stream": True}, {})}


@pytest.fixture(scope="module")
def data():
    from ihgnn_tpu.data.synthetic import make_synthetic_data
    return make_synthetic_data(user_count=U, query_count=Q, item_count=I,
                               vocab_size=VOCAB, log_count=80, seed=5)


def _job(data, name, kw, params0, batches, **extra):
    return TrainJob(name, tcfg.ModelConfig(embedding_size=D, **kw), COUNTS,
                    np.asarray(data.pos_uqif), data.query_words,
                    data.query_word_counts,
                    [_port_batch(b) for b in batches],
                    state=params_from_jax(params0), keep_state=True,
                    keep_features=True, **extra)


def _assert_params(got, want, atol, rtol=0.0, noise=None):
    """``got`` against ``want`` element by element within ``atol +
    rtol·|want|``, the elements of ``noise`` within ADAM_NOISE_ATOL
    (``tests/test_torch_sharding.py``'s rule over this file's steps)."""
    assert set(got) == set(want)
    for name, w in want.items():
        g, w = got[name].numpy(), w.numpy()
        limit = atol + rtol * np.abs(w)
        if noise is not None and name in noise:
            limit = np.where(noise[name], ADAM_NOISE_ATOL, limit)
        err = np.abs(g - w)
        assert (err <= limit).all(), (name, float((err - limit).max()))


def _axis(fn, model_axis, table_shard_both=False):
    """``fn`` (a rank body) to run on a mesh with that model axis."""
    fn = functools.partial(fn)
    fn.model_axis, fn.table_shard_both = model_axis, table_shard_both
    return fn


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    """``{"jax": {path: JAX one-device run}, "one": {path: port one
    device}, (mesh, path): port rank results}``, and the checkpoint runs:
    ``"saved"`` (2, 2) ranks after SAVE_AFTER steps, ``"resumed"`` {target:
    rank results} of the last step resumed from it."""
    jax_runs, one_jobs, jobs = {}, [], []
    for path, (kw, extra) in PATHS.items():
        run = (jax_runs["ihgnn"] if path == "routed" else
               _jax_run(data, kw, _jax_graph(data, kw), steps=STEPS))
        jax_runs[path] = run
        one_jobs.append(_job(data, path, kw, run[0], run[3], **extra))
        for mesh, (model, both) in MESHES.items():
            jobs.append(_job(data, f"{mesh}/{path}", kw, run[0], run[3],
                             model_axis=model, table_shard_both=both,
                             **extra))
    # two stacked microbatches a step at (2, 2)
    jax_runs["accum"] = _jax_run(data, {}, _hyper(data), grad_accum=2)
    one_jobs.append(_job(data, "accum", {}, jax_runs["accum"][0],
                         jax_runs["accum"][3], grad_accum_steps=2))
    jobs.append(_job(data, "2x2/accum", {}, jax_runs["accum"][0],
                     jax_runs["accum"][3], grad_accum_steps=2,
                     model_axis=2))
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    save = _axis(functools.partial(ranks_body.save_job, one_jobs[0], ckpt,
                                   SAVE_AFTER), 2)
    one = run_jobs(0, one_jobs)[0]
    many = run_jobs(RANKS, jobs + [save])
    name = many[0][-1]["name"]
    resume = functools.partial(ranks_body.resume_job, one_jobs[0], ckpt,
                               name, SAVE_AFTER)
    out = {"jax": jax_runs, "one": dict(zip(list(PATHS) + ["accum"], one)),
           "saved": [r[-1] for r in many],
           "resumed": {"one": run_jobs(0, [resume])[0][0],
                       "4x1": [r[0] for r in run_jobs(RANKS, [resume])]}}
    for j, job in enumerate(jobs):
        mesh, path = job.name.split("/")
        out[mesh, path] = [r[j] for r in many]
    return out


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_model_axis_step_matches_one_device(runs, mesh, path):
    """The mesh's steps against the port's one-device steps: every rank's
    one-device parameters equal bit for bit; losses, features, step-0
    gradients and parameters within 1e-5 (bf16 streams over the bf16
    wire: 2e-2 of scale, losses 1e-3, parameters 5e-4; score heads as the
    module docstring says)."""
    one, many = runs["one"][path], runs[mesh, path]
    assert len({r["digest"] for r in many}) == 1
    got = many[0]
    bf16 = PATHS[path][0].get("bf16_stream", False)
    tol, loss_rtol = (BF16_TOL, BF16_LOSS_RTOL) if bf16 else (TOL, TOL)
    assert len(got["losses"]) == STEPS
    for a, b in zip(got["losses"], one["losses"]):
        assert _rel(a, b) <= loss_rtol
    scale = one["features"].abs().max().item()
    assert (got["features"] - one["features"]).abs().max().item() \
        <= tol * scale
    assert set(got["grads0"]) == set(one["grads0"])
    for name, g in one["grads0"].items():
        err = (got["grads0"][name] - g).abs().max().item()
        assert err <= tol * _grad_scale(name, one["grads0"]), name
    _assert_params(got["params"], one["params"],
                   JAX_PARAM_TOL if bf16 else tol,
                   noise=_noise(one["grads0"]))


def test_grad_accum_on_model_axis(runs):
    """Two stacked microbatches a step at (2, 2) (the tables' gather
    back-propagated once a microbatch, the replicated gradients summed
    once a step): the replicas equal bit for bit, losses and parameters
    within 1e-5 of the port's one device, losses within JAX's 1e-4."""
    one, many = runs["one"]["accum"], runs["2x2", "accum"]
    assert len({r["digest"] for r in many}) == 1
    got = many[0]
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=TOL)
    np.testing.assert_allclose(got["losses"], runs["jax"]["accum"][1],
                               rtol=JAX_LOSS_RTOL)
    _assert_params(got["params"], one["params"], TOL)


@pytest.mark.parametrize("path", ["ihgnn", "gat"])
def test_model_axis_step_matches_jax_mesh(data, runs, path):
    """The (2, 2) ranks against the JAX package's step at mesh (2, 2) with
    the tables' rows padded to a multiple of the model axis
    (``table_row_multiple=2``) and sharded over it: losses and parameters
    (the padded rows zero, dropped by ``params_from_jax``) within
    ``tests/test_sharding.py``'s limits."""
    mesh = jax_mesh(MeshConfig(data=2, model=2))
    kw = PATHS[path][0]
    graph = (jax_pad2d(data.graph2d, 2) if path == "gat"
             else jax_pad(_hyper(data), 2))
    _, losses, params, _ = _jax_run(data, kw, graph, mesh=mesh,
                                    steps=STEPS, table_row_multiple=2)
    assert params["params"]["embeddings"]["user_table"].shape[1] == 10
    got = runs["2x2", path][0]
    for a, b in zip(got["losses"], losses):
        assert _rel(a, b) <= JAX_LOSS_RTOL
    rows = {"user": U + 1, "item": I + 1, "vocab": VOCAB + 1}
    _assert_params(got["params"], params_from_jax(params, rows),
                   JAX_PARAM_TOL, JAX_PARAM_TOL,
                   _noise(runs["one"][path]["grads0"]))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_adam_state_holds_the_rank_block(runs, mesh):
    """A rank keeps its block of each table and of its two Adam moments:
    ``ceil(rows / parts)`` rows of each (parts = M, or D·M with
    ``table_shard_both``), about 1/parts of one device's table state;
    every other parameter and moment whole."""
    model, both = MESHES[mesh]
    parts = RANKS if both else model
    one = runs["one"]["ihgnn"]["state_bytes"]
    blocks = sum(block_rows(n, parts) for n in (U + 1, I + 1, VOCAB + 1))
    for rank in runs[mesh, "ihgnn"]:
        got = rank["state_bytes"]
        assert got["tables"] == 3 * blocks * D * 4
        assert got["params"] - one["params"] == \
            got["tables"] / 3 - one["tables"] / 3
        assert got["adam"] == 2 * got["params"]
    assert got["tables"] <= one["tables"] / parts + 3 * 3 * D * 4


@pytest.mark.parametrize("target", ["one", "4x1"])
def test_checkpoint_of_2x2_resumes_anywhere(runs, target):
    """A checkpoint that (2, 2) ranks save after 2 steps (rank 0 writes
    the one-device state: the tables and their Adam moments gathered)
    resumes on one device and on (4, 1): its third step's loss and the
    parameters after it equal the uninterrupted one-device run's (1e-5)."""
    one = runs["one"]["ihgnn"]
    saved = runs["saved"]
    assert saved[0]["name"] and all(r["name"] is None for r in saved[1:])
    for a, b in zip(saved[0]["losses"], one["losses"][:SAVE_AFTER]):
        assert _rel(a, b) <= TOL
    resumed = runs["resumed"][target]
    for got in (resumed if target == "4x1" else [resumed]):
        assert got["epoch"] == SAVE_AFTER
        assert _rel(got["losses"][0], one["losses"][SAVE_AFTER]) <= TOL
        _assert_params(got["params"], one["params"], TOL)


def test_params_from_jax_cuts_into_jax_shards(data):
    """JAX tables built with ``table_row_multiple`` (zero rows past the
    logical rows) go through ``params_from_jax`` (the pad rows checked
    and dropped) and ``shard_params``: each rank's block equals the shard
    that JAX's mesh (2, 2) places on the device at the rank's (data,
    model) coordinates, over ``model`` (rows padded to 2) and over
    ``(model, data)`` (``IHGNN_TABLE_SHARD_BOTH``, rows padded to 4)."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    mesh = jax_mesh(MeshConfig(data=2, model=2))
    rows = {"user": U + 1, "item": I + 1, "vocab": VOCAB + 1}
    for multiple, axes, both in ((2, "model", False),
                                 (4, ("model", "data"), True)):
        model = RawGnn(cfg=ModelConfig(embedding_size=D), user_count=U,
                       query_count=Q, item_count=I, vocab_size=VOCAB,
                       table_row_multiple=multiple)
        z = jnp.zeros((1,), jnp.int32)
        tree = _np_tree(model.init(jax.random.key(0), _hyper(data),
                                   jnp.asarray(data.query_words),
                                   jnp.asarray(data.query_word_counts),
                                   z, z, z))
        state = params_from_jax(tree, rows)
        for name in ("user", "item", "vocab"):
            table = tree["params"]["embeddings"][f"{name}_table"]
            placed = jax.device_put(table, NamedSharding(mesh, P(None, axes)))
            shards = {s.device: np.asarray(s.data).T
                      for s in placed.addressable_shards}
            for k in range(2):
                for m in range(2):
                    mine = shard_params(state, Mesh(2, 2, 2 * k + m, None,
                                                    "gloo",
                                                    table_shard_both=both))
                    np.testing.assert_array_equal(
                        mine[f"embeddings.{name}_table"].numpy(),
                        shards[mesh.devices[k, m]])


def test_mesh_coordinates_and_blocks():
    """A rank's (data, model) coordinates are JAX's device grid's (rank
    ``k·M + m`` at (k, m)); its table block is ``m`` over ``model`` and
    ``m·D + k`` with ``table_shard_both``; ``block`` slices by the data
    index; a (1, 2) mesh's ranks share one data slice."""
    for rank in range(4):
        k, m = divmod(rank, 2)
        mesh = Mesh(2, 2, rank, None, "gloo")
        assert (mesh.data_index, mesh.model_index) == (k, m)
        assert mesh.table_parts == 2 and mesh.table_block == m
        assert mesh.block(8) == slice(4 * k, 4 * k + 4)
        both = Mesh(2, 2, rank, None, "gloo", table_shard_both=True)
        assert both.table_parts == 4 and both.table_block == 2 * m + k
    for rank in range(2):
        mesh = Mesh(1, 2, rank, None, "gloo")
        assert mesh.shape == {"data": 1, "model": 2}
        assert mesh.block(6) == slice(0, 6) and mesh.table_block == rank


def test_pick_backend_by_local_world(monkeypatch):
    """The backend follows the host's own ranks: NCCL when the host has a
    card for each of them, whatever the world size across hosts; gloo on
    the CPU or when ranks share a card."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cuda = torch.device("cuda", 0)
    assert pick_backend(2, cuda) == "nccl"
    assert pick_backend(4, cuda) == "gloo"
    assert pick_backend(1, torch.device("cpu")) == "gloo"


def test_start_ranks_needs_multihost_across_hosts(monkeypatch):
    """A process group whose ranks span hosts (``LOCAL_WORLD_SIZE`` <
    ``WORLD_SIZE``) runs only under ``--multihost``; a mesh without
    torchrun's environment is refused, a model-only mesh too."""
    from ihgnn_torch.cli import start_ranks
    for key in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(ValueError, match="torchrun"):
        start_ranks(tcfg.parse_args(["--mesh_model", "2", "--device",
                                     "cpu"]))
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="--multihost"):
        start_ranks(tcfg.parse_args(["--mesh_data", "2", "--mesh_model",
                                     "2", "--device", "cpu"]))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from ihgnn_tpu.data.artifacts import write_synthetic_dataset
    ds = str(tmp_path_factory.mktemp("ds"))
    write_synthetic_dataset(ds, seed=11, user_count=25, query_count=15,
                            item_count=40, vocab_size=30, log_count=300)
    return ds


CLI_COMMON = ["--emb", "8", "--device", "cpu", "--epoch_count", "2",
              "--epoch_start_test", "2", "--epoch_test_frequency", "2"]


def _cli_one(dataset, tmp_path, extra=()):
    from ihgnn_torch.cli import main
    return main(["--dataset", dataset, *CLI_COMMON, *extra,
                 "--result_dir", str(tmp_path / "one")])


@pytest.mark.parametrize("nodes,per_node,flags", [
    (1, 4, ["--mesh_data", "2", "--mesh_model", "2"]),
    (2, 2, ["--mesh_data", "2", "--mesh_model", "2", "--multihost"]),
    (1, 2, ["--mesh_data", "2", "--model", "srrl"]),
], ids=["mesh_2x2", "multihost_2_nodes", "srrl_mesh_data_2"])
def test_cli_under_torchrun_equals_one_device(dataset, tmp_path, nodes,
                                              per_node, flags):
    """``--mesh_data 2 --mesh_model 2`` in 4 ranks of one torchrun, the
    same as two torchrun nodes of 2 ranks each with ``--multihost`` (one
    process group across "hosts" on 127.0.0.1), and ``--model srrl
    --mesh_data 2`` (every rank trains its own replica): every rank's
    epoch losses equal the one-device CLI run's (rel 1e-4; Srrl's bit for
    bit), rank 0's test metrics too (rel 1e-4; equal for Srrl), and only
    rank 0 writes the result directory."""
    srrl = "srrl" in flags
    one = _cli_one(dataset, tmp_path, ["--model", "srrl"] if srrl else ())
    res = tmp_path / "mesh"
    out = tmp_path / "out"
    out.mkdir()
    recs, logs = ranks_body.run_cli(
        nodes, per_node, ["--dataset", dataset, *CLI_COMMON, *flags,
                          "--storemetrics", "--result_dir", str(res)],
        str(out))
    want = [s.avg_loss for s in one.epoch_stats]
    for rec in recs:
        got = [e["avg_loss"] for e in rec["epochs"]]
        if srrl:
            assert got == want
        else:
            np.testing.assert_allclose(got, want, rtol=1e-4)
    (epoch, metrics), = recs[0]["test"]
    (w_epoch, w_metrics), = [(e, m.as_row()) for e, m in
                             one.iter_epoch_test()]
    assert epoch == w_epoch
    np.testing.assert_allclose(metrics, w_metrics, rtol=0 if srrl else 1e-4)
    (run_dir,) = os.listdir(res)
    names = os.listdir(res / run_dir)
    assert len([n for n in names if n.endswith("_metrics.txt")]) == 1
    if "--multihost" in flags:
        assert all("ranks on 2 host(s)" in log or "mesh:" not in log
                   for log in logs)


def test_entry_scores_equal_graft_entry():
    """``entry()``'s forward under JAX's initial weights (carried over
    with ``params_from_jax``) scores the batch as
    ``__graft_entry__.entry()``'s forward does (1e-5 of scale)."""
    import __graft_entry__ as graft
    from ihgnn_torch.entry import entry
    j_fn, j_args = graft.entry()
    want = np.asarray(jax.jit(j_fn)(*j_args))
    fn, (params, users, queries, items) = entry("cpu")
    for got_rows, want_rows in zip((users, queries, items), j_args[1:]):
        np.testing.assert_array_equal(got_rows.numpy(),
                                      np.asarray(want_rows))
    got = fn(params_from_jax(_np_tree(j_args[0])), users, queries,
             items).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_dryrun_multichip_four_ranks(capsys):
    """``dryrun_multichip(4)`` runs one step at mesh (2, 2), the tables'
    rows over ``model``, each rank's routed pack, and prints JAX's line."""
    from ihgnn_torch.entry import dryrun_multichip
    ranks = dryrun_multichip(4, "cpu")
    assert len(ranks) == 4
    assert all(np.isfinite(r[0]["losses"][0]) for r in ranks)
    out = capsys.readouterr().out
    assert "dryrun_multichip(4): mesh data=2 model=2, one train step OK" \
        in out


def test_collective_stats_synthetic_record():
    """``collective_stats``, ``comm_bytes`` and ``collective_table`` over
    a record (``tests/test_hlo_stats.py``'s synthetic lines as records)."""
    record = [
        {"kind": "all-reduce", "bytes": 32 * 1024 * 4,
         "shape": "f32[32,1024]", "group": "data", "attribution": "x"},
        {"kind": "all-gather", "bytes": 64 * 512 * 2,
         "shape": "bf16[64,512]", "group": "model", "attribution": "y"},
        {"kind": "reduce-scatter", "bytes": 2 * 16 * 4, "shape": "f32[32]",
         "group": "data", "attribution": "grad:z"}]
    stats = collective_stats(record)
    assert stats["all-reduce"] == {"count": 1, "bytes": 32 * 1024 * 4}
    assert stats["all-gather"] == {"count": 1, "bytes": 64 * 512 * 2}
    assert stats["reduce-scatter"] == {"count": 1, "bytes": 128}
    assert comm_bytes(record) == 32 * 1024 * 4 + 64 * 512 * 2 + 128
    table = collective_table(record)
    assert [r["attribution"] for r in table] == ["x", "y", "grad:z"]


def _expected_step(mesh, d=D, rows=80):
    """The collectives of one IHGNN train step (2 layers, f32, the tail
    psum) of ``tests/test_torch_sharding.py``'s model on 2 ranks, from the
    shapes: ``[(kind, group, attribution, shape)]``."""
    from ihgnn_torch.models.rawgnn import RawGnn as TRawGnn
    from ihgnn_torch.parallel.collectives import node_pad
    if mesh == "2x1":
        n_pad = node_pad(U + Q + I, 2)
        per = -(-Q // 2)
        params = sum(p.numel() for p in TRawGnn(
            tcfg.ModelConfig(embedding_size=d), U, Q, I, VOCAB).parameters())
        cn = [("reduce-scatter", f"f32[{n_pad // 2},{d}]"),
              ("all-gather", f"f32[{n_pad},{d}]")]
        return ([("all-gather", "data", "gather_slices", f"f32[{2 * per},{d}]")]
                + [(k, "data", "combine_nodes", s) for k, s in cn]
                + [("all-reduce", "data", "combine_rows",
                    f"f32[{3 * rows},{d}]"),
                   ("all-reduce", "data", "grad:combine_rows",
                    f"f32[{3 * rows},{d}]")]
                + [(k, "data", "grad:combine_nodes", s) for k, s in cn]
                + [("reduce-scatter", "data", "grad:gather_slices",
                    f"f32[{per},{d}]"),
                   ("all-reduce", "data", "grad:reduce_gradients",
                    f"f32[{params}]"),
                   ("all-reduce", "data", "loss", "f32[]")])
    total = sum(-(-n // 2) for n in (U + 1, I + 1, VOCAB + 1))
    return [("all-gather", "model", "gather_tables", f"f32[{2 * total},{d}]")]


def _shape_bytes(shape):
    dims = shape[shape.index("[") + 1:-1]
    n = int(np.prod([int(x) for x in dims.split(",") if x]))
    return n * {"f32": 4, "bf16": 2}[shape[:shape.index("[")]]


@pytest.fixture(scope="module")
def stats_runs(data, runs):
    """``{mesh: rank results}`` of one IHGNN step on 2 ranks at (2, 1) and
    (1, 2), in one spawn."""
    params0, _, _, batches = runs["jax"]["ihgnn"]
    meshes = {"2x1": 1, "1x2": 2}
    jobs = [_job(data, mesh, {}, params0, batches[:1], model_axis=model)
            for mesh, model in meshes.items()]
    ranks = run_jobs(2, jobs)
    return {mesh: [r[j] for r in ranks] for j, mesh in enumerate(meshes)}


@pytest.mark.parametrize("mesh", ["2x1", "1x2"])
def test_step_collectives_recorded_from_shapes(runs, stats_runs, mesh):
    """A train step on 2 ranks records each collective it issues (mesh
    (2, 1): the bag's all-gather, the first layer's reduce-scatter and
    all-gather, the tail's all-reduce, their gradients', the gradients'
    and the loss's all-reduce; (1, 2): the tables' all-gather alone, as a
    collective over one rank does not run): kind, group, site and result
    shape as computed from the shapes; ``collective_stats`` counts and
    bytes are their sums, ``comm_bytes`` the total."""
    batch = runs["jax"]["ihgnn"][3][0]
    want = _expected_step(mesh, rows=len(batch.users))
    for rank in stats_runs[mesh]:
        (record,) = rank["collectives"]
        assert [(r["kind"], r["group"], r["attribution"], r["shape"])
                for r in record] == want
        stats = collective_stats(record)
        for kind in {w[0] for w in want}:
            rows = [w for w in want if w[0] == kind]
            assert stats[kind] == {"count": len(rows), "bytes": sum(
                _shape_bytes(w[3]) for w in rows)}
        assert comm_bytes(record) == sum(_shape_bytes(w[3]) for w in want)
        assert [r["bytes"] for r in collective_table(record)] == sorted(
            (_shape_bytes(w[3]) for w in want), reverse=True)
