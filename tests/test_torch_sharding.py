"""The port's data parallelism over the edge axis (``ihgnn_torch/parallel``)
against the JAX package's mesh, on the CPU.

The port runs S = 4 (and S = 2) gloo ranks, spawned processes that import
the port and never JAX (``ihgnn_torch.parallel.ranks``,
``tests/torch_sharding_ranks.py``); the JAX side runs in this process on
its 8 virtual CPU devices at mesh (4, 1), or on one device. Inputs are
``tests/test_sharding.py``'s: ``make_synthetic_data`` at U/Q/I/V =
9/7/13/11, 80 logs, d = 8, batches of 16 positives × 4 negatives (rows a
multiple of 4), JAX's initial weights carried over
(``params_from_jax``). The chunked case takes 600 logs (1038 edges), so
that each rank's 260 edges pack in 3 chunks of 128 (the least a chunk
holds: one row of a 128-column grid).

Tolerances: against JAX, ``tests/test_sharding.py``'s (loss rel 1e-4,
parameters after the steps rtol = atol = 5e-4) or tighter; the S-rank
run against the port's one-device run 1e-5 (losses relative, step-0
gradients of each tensor's largest value, features, parameters absolute);
on bf16 streams with the bf16 wire, ``tests/test_torch_bf16.py``'s 1e-2
of the largest value for features and gradients and 1e-3 for losses, and
5e-4 for parameters. An attention score head (``*.feature_aggregate.*``)
is held as ``tests/test_torch_bf16.py`` and ``chip_smoke.py`` hold it:
its step-0 gradient within the limit of its layer's largest gradient (a
softmax ignores a shift of a destination's scores, so the head's bias
gradient, and where the LeakyReLU slopes are alike the destination half
of its weight's, is f32 rounding noise). Parameters are held element by
element: an element of a score head whose step-0 gradient in the port's
one-device run is at rounding level (``NOISE_REL`` of its layer's largest
gradient) is held within ``ADAM_NOISE_ATOL`` instead, since Adam moves a
parameter by up to the learning rate a step whatever its gradient's size,
so a noise gradient whose sign differs between two sums of the same terms
moves it by up to twice that a step; every other element of every leaf
keeps its limit. Against XLA's bf16 path, an element whose step-0
gradients on the two paths differ in sign (within the 2e-2 of scale that
``tests/test_torch_bf16.py`` holds them to) is also held so. Every rank
must end with the same parameters, bit for bit.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from ihgnn_torch import config as tcfg
from ihgnn_torch.convert import params_from_jax
from ihgnn_torch.data.dataset import Batch as TBatch
from ihgnn_torch.graph import (build_graph2d, build_hypergraph,
                               build_log_hypergraph)
from ihgnn_torch.models.rawgnn import RawGnn as TRawGnn
from ihgnn_torch.ops.bag import make_word_bag
from ihgnn_torch.ops.hyperagg import make_log_ops
from ihgnn_torch.parallel import (Mesh, make_mesh, pad_graph2d_for_mesh,
                                  pad_hypergraph_for_mesh,
                                  pad_log_hypergraph_for_mesh, shard_batch,
                                  shard_graph)
from ihgnn_torch.parallel.ranks import TrainJob, run_jobs
from ihgnn_torch.train import train as ttrain
from ihgnn_tpu.config import Config, MeshConfig, ModelConfig, TrainConfig, V
from ihgnn_tpu.data.dataset import TrainSampler
from ihgnn_tpu.data.synthetic import make_synthetic_data
from ihgnn_tpu.models.rawgnn import RawGnn
from ihgnn_tpu.ops.hyperagg import strip_kernel_packing
from ihgnn_tpu.parallel.mesh import make_mesh as jax_mesh
from ihgnn_tpu.parallel.sharding import pad_graph2d_for_mesh as jax_pad2d
from ihgnn_tpu.parallel.sharding import pad_hypergraph_for_mesh as jax_pad
from ihgnn_tpu.parallel.sharding import shard_batch as jax_shard_batch
from ihgnn_tpu.parallel.sharding import shard_graph as jax_shard_graph
from ihgnn_tpu.parallel.sharding import shard_state
from ihgnn_tpu.train.train import init_state, make_optimizer, make_train_step

import torch_sharding_ranks as ranks_body

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")

U, Q, I, VOCAB, D = 9, 7, 13, 11, 8
S, STEPS = 4, 2
COUNTS = (U, Q, I, VOCAB)
JAX_LOSS_RTOL, JAX_PARAM_TOL = 1e-4, 5e-4
TOL = 1e-5
BF16_TOL, BF16_LOSS_RTOL = 1e-2, 1e-3
ADAM_NOISE_ATOL = 2 * tcfg.TrainConfig().learning_rate * STEPS
NOISE_REL = 1e-6
BF16_XLA_GRAD_TOL = 2e-2
# the chunked case's logs, and its per-rank pack's rows a chunk
BIG_LOGS, CHUNK_CAP = 600, 1

# case: (ModelConfig fields, the port's TrainJob fields); the JAX run of
# JAX_SAME[case] where given
CASES = {"ihgnn": ({}, {}), "routed": ({}, {"pack_kernels": True}),
         "bf16": ({"bf16_stream": True}, {}),
         "hgcn": ({"gnn": V.HGCN}, {}), "gcn": ({"gnn": V.GCN}, {}),
         "gat": ({"gnn": V.GAT}, {}),
         "gat_product": ({"gnn": V.GAT, "gat_head": V.PRODUCT}, {}),
         "phase2": ({"phase2_attention": True}, {}),
         "phase2_routed": ({"phase2_attention": True},
                           {"pack_kernels": True}),
         "log": ({"gnn": V.HGCN, "use_log_hypergraph": True}, {}),
         "chunked": ({}, {"pack_kernels": True,
                          "chunk_rows_cap": CHUNK_CAP}),
         "phase2_bf16": ({"phase2_attention": True, "bf16_stream": True},
                         {})}
JAX_SAME = {"routed": "ihgnn", "phase2_routed": "phase2"}


@pytest.fixture(scope="module")
def data():
    return make_synthetic_data(user_count=U, query_count=Q, item_count=I,
                               vocab_size=VOCAB, log_count=80, seed=5)


@pytest.fixture(scope="module")
def data_big():
    return make_synthetic_data(user_count=U, query_count=Q, item_count=I,
                               vocab_size=VOCAB, log_count=BIG_LOGS, seed=5)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_batch(b):
    return TBatch(*(np.asarray(getattr(b, f.name))
                    for f in dataclasses.fields(TBatch)))


def _jax_run(data, kw, graph, mesh=None, grad_accum=1, steps=STEPS,
             table_row_multiple=1):
    """``steps`` JAX train steps from ``init_state``'s weights on
    ``graph`` (sharded over ``mesh`` when given): (initial params, losses,
    final params, the batches), NumPy."""
    cfg = Config(model=ModelConfig(embedding_size=D, **kw),
                 train=TrainConfig(batch_size=16,
                                   random_negative_sample_size=4))
    model = RawGnn(cfg=cfg.model, user_count=U, query_count=Q, item_count=I,
                   vocab_size=VOCAB, table_row_multiple=table_row_multiple)
    tx = make_optimizer(cfg)
    state = init_state(model, jax.random.key(0), graph, data.query_words,
                       data.query_word_counts, cfg, tx)
    params0 = _np_tree(state.params)
    sampler = TrainSampler(data, 16, 4, seed=2, row_multiple=S)
    epoch = sampler.epoch()
    batches = [next(epoch) for _ in range(steps * grad_accum)]
    if grad_accum > 1:
        batches = [jax.tree.map(lambda *x: np.stack(x),
                                *batches[k:k + grad_accum])
                   for k in range(0, len(batches), grad_accum)]
    if mesh is not None:
        state = shard_state(state, mesh)
        graph = jax_shard_graph(graph, mesh)
    step = make_train_step(model, graph, data.query_words,
                           data.query_word_counts, tx,
                           grad_accum_steps=grad_accum)
    losses = []
    for b in batches:
        state, loss = step(state, b if mesh is None
                           else jax_shard_batch(b, mesh))
        losses.append(float(loss))
    return params0, losses, _np_tree(jax.device_get(state.params)), batches


def _hyper(data):
    return strip_kernel_packing(data.hypergraph)


def _jax_graph(data, kw):
    """The JAX package's one-device graph of a case's layers."""
    if kw.get("use_log_hypergraph"):
        return data.log_hypergraph
    if kw.get("gnn") in (V.GCN, V.GAT):
        return data.graph2d
    return _hyper(data)


def _log_edges(data):
    """The log hypergraph's edges as ``TrainJob.log_edges`` takes them."""
    lg = data.log_hypergraph
    return (np.asarray(lg.edge_nodes),
            np.bincount(np.asarray(lg.edge_ids), minlength=lg.edge_count))


def _job(data, name, kw, params0, batches, **extra):
    if kw.get("use_log_hypergraph"):
        extra["log_edges"] = _log_edges(data)
    return TrainJob(name, tcfg.ModelConfig(embedding_size=D, **kw), COUNTS,
                    np.asarray(data.pos_uqif), data.query_words,
                    data.query_word_counts,
                    [_port_batch(b) for b in batches],
                    state=params_from_jax(params0), keep_state=True,
                    keep_features=True, **extra)


def _softmax_problem():
    """The softmax's edge cases on S ranks: ``(entries, node_count,
    dst_count, x, heads, cot)`` for ``softmax_job``. Destination k of
    SOFTMAX_DST has entries on one rank (0), on every rank (1), on none
    (2), only masked ones on two ranks (3), and masked and live ones on
    three ranks (4); each source feeds one destination, and sources are
    not destinations."""
    rng = np.random.default_rng(7)
    per_dst = {0: [(2, 1)] * 3, 1: [(r, 1) for r in range(S)] * 2, 2: [],
               3: [(0, 0), (2, 0), (2, 0)],
               4: [(1, 0), (1, 1), (3, 1), (0, 0)]}
    entries, src = [], len(per_dst)
    for dst, ends in per_dst.items():
        for rank, live in ends:
            entries.append((rank, src, dst, live))
            src += 1
    d = 4
    x = torch.from_numpy(rng.standard_normal((src, d)).astype(np.float32))
    heads = {h: (torch.from_numpy(rng.standard_normal(n).astype(
                 np.float32)), torch.from_numpy(rng.standard_normal(1)
                                                .astype(np.float32)))
             for h, n in ((V.CONCAT, 2 * d), (V.PRODUCT, d))}
    cot = torch.from_numpy(rng.standard_normal((len(per_dst), d)).astype(
        np.float32))
    return entries, src, len(per_dst), x, heads, cot


@pytest.fixture(scope="module")
def runs(data, data_big):
    """{case: (JAX one-device run, port one-device result, port S-rank
    results by rank)} for CASES, and the ``accum``, ``bag``, ``tail`` and
    ``softmax`` jobs' results: every job's S ranks in one spawn."""
    from functools import partial
    jax_runs, jobs = {}, []
    for case, (kw, extra) in CASES.items():
        case_data = data_big if case == "chunked" else data
        if case in JAX_SAME:
            run = jax_runs[JAX_SAME[case]]
        else:
            run = _jax_run(case_data, kw, _jax_graph(case_data, kw))
        jax_runs[case] = run
        jobs.append(_job(case_data, case, kw, run[0], run[3], **extra))
    jax_runs["accum"] = _jax_run(data, {}, _hyper(data), grad_accum=2)
    jobs.append(_job(data, "accum", {}, jax_runs["accum"][0],
                     jax_runs["accum"][3], grad_accum_steps=2))
    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.standard_normal((VOCAB + 1, D)).astype(
        np.float32))
    cot = torch.from_numpy(rng.standard_normal((Q, D)).astype(np.float32))
    bag = partial(ranks_body.bag_job, data.query_words,
                  data.query_word_counts, VOCAB + 1, table)
    tail = partial(ranks_body.tail_job, COUNTS, np.asarray(data.pos_uqif),
                   data.query_words, data.query_word_counts,
                   params_from_jax(jax_runs["ihgnn"][0]),
                   _port_batch(jax_runs["ihgnn"][3][0]))
    softmax = partial(ranks_body.softmax_job, *_softmax_problem())
    one = run_jobs(0, jobs + [partial(bag, cot), softmax])[0]
    # each rank back-propagates a quarter of the bag's cotangent: its
    # share of a loss, as in a step
    many = run_jobs(S, jobs + [partial(bag, cot / S), softmax, tail])
    n = len(jobs)
    out = {name: (jax_runs[name], one[j], [r[j] for r in many])
           for j, name in enumerate(list(CASES) + ["accum"])}
    out["bag"] = (one[n], [r[n] for r in many])
    out["softmax"] = (one[n + 1], [r[n + 1] for r in many])
    out["tail"] = [r[n + 2] for r in many]
    return out


def _rel(a, b):
    return abs(a - b) / abs(b)


def _head(name):
    return ".feature_aggregate." in name


def _grad_scale(name, grads):
    """The largest value of gradient ``name``, or for a score head the
    largest gradient of its layer (the module docstring)."""
    if _head(name):
        layer = name.split(".")[:2]
        return max(g.abs().max().item() for k, g in grads.items()
                   if k.split(".")[:2] == layer)
    return max(grads[name].abs().max().item(), 1e-30)


def _noise(grads):
    """{name: boolean mask} of the score-head elements whose step-0
    gradient in ``grads`` is at rounding level (the module docstring)."""
    return {name: (g.abs() <= NOISE_REL * _grad_scale(name, grads)).numpy()
            for name, g in grads.items() if _head(name)}


def _assert_params(got, want, atol, rtol=0.0, noise=None):
    """Parameters ``got`` against ``want`` (by name), element by element
    within ``atol + rtol·|want|``, and the elements of ``noise`` within
    ``ADAM_NOISE_ATOL``."""
    assert set(got) == set(want)
    for name, w in want.items():
        g, w = got[name].numpy(), w.numpy()
        limit = atol + rtol * np.abs(w)
        if noise is not None and name in noise:
            limit = np.where(noise[name], ADAM_NOISE_ATOL, limit)
        err = np.abs(g - w)
        assert (err <= limit).all(), (name, float((err - limit).max()))


def _jax_grads0(data, kw, graph, params0, batch):
    """The JAX package's step-0 gradient on one device, by name."""
    import jax.numpy as jnp

    from ihgnn_tpu.train.train import bce_with_logits
    model = RawGnn(cfg=ModelConfig(embedding_size=D, **kw), user_count=U,
                   query_count=Q, item_count=I, vocab_size=VOCAB)
    graph = jax.tree.map(jnp.asarray, graph)
    words = jnp.asarray(data.query_words)
    counts = jnp.asarray(data.query_word_counts)

    def loss(params):
        logits = model.apply(params, graph, words, counts, batch.users,
                             batch.queries, batch.items)
        return bce_with_logits(logits, batch.flags, batch.weight)

    return params_from_jax(_np_tree(jax.grad(loss)(params0)))


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_matches_one_device(runs, case):
    """The S-rank steps against the port's one-device steps: the replicas
    equal bit for bit; losses, features, step-0 gradients and parameters
    within 1e-5 (bf16 streams with the bf16 wire: 1e-2 of scale, losses
    1e-3, parameters ``tests/test_sharding.py``'s 5e-4; score heads as the
    module docstring says)."""
    _, one, many = runs[case]
    assert len({r["digest"] for r in many}) == 1
    got = many[0]
    bf16 = CASES[case][0].get("bf16_stream", False)
    tol, loss_rtol = (BF16_TOL, BF16_LOSS_RTOL) if bf16 else (TOL, TOL)
    for a, b in zip(got["losses"], one["losses"]):
        assert _rel(a, b) <= loss_rtol
    scale = one["features"].abs().max().item()
    assert (got["features"] - one["features"]).abs().max().item() \
        <= tol * scale
    for name, g in one["grads0"].items():
        err = (got["grads0"][name] - g).abs().max().item()
        assert err <= tol * _grad_scale(name, one["grads0"]), name
    _assert_params(got["params"], one["params"],
                   JAX_PARAM_TOL if bf16 else tol,
                   noise=_noise(one["grads0"]))


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_matches_jax_one_device(data, runs, case):
    """The S-rank steps against the JAX package's one-device XLA step, on
    bf16 streams too (``tests/test_sharding.py``'s limits). Phase 2 on
    bf16 streams exempts, besides the score heads' rounding noise, the
    elements whose step-0 gradients on the port's and XLA's bf16 paths
    differ in sign (the module docstring)."""
    (params0, losses, params, batches), one, many = runs[case]
    got = many[0]
    for a, b in zip(got["losses"], losses):
        assert _rel(a, b) <= JAX_LOSS_RTOL
    noise = _noise(one["grads0"])
    if case == "phase2_bf16":
        kw = CASES[case][0]
        want = _jax_grads0(data, kw, _jax_graph(data, kw), params0,
                           batches[0])
        for name, w in want.items():
            g = one["grads0"][name]
            flip = (torch.sign(g) != torch.sign(w)).numpy()
            assert ((g - w).abs() <= BF16_XLA_GRAD_TOL
                    * _grad_scale(name, want)).all(), name
            noise[name] = noise.get(name, False) | flip
    _assert_params(got["params"], params_from_jax(params), JAX_PARAM_TOL,
                   JAX_PARAM_TOL, noise)


@pytest.mark.parametrize("case", ["ihgnn", "routed", "gat", "phase2", "log"])
def test_sharded_step_matches_jax_mesh(data, runs, case):
    """The S-rank steps against the JAX package's sharded step at mesh
    (4, 1): its XLA ops under GSPMD (``ihgnn``; GAT on its padded 2D
    graph, stripped of packs; phase 2 on its padded hypergraph; HGCN on
    the log hypergraph, whose incidence GSPMD shards), and its per-shard
    Pallas packs under ``shard_map`` with its sharded word bag, which pads
    Q = 7 queries over 4 shards with a dummy query as the port's
    ``ShardedBag`` does (``routed``:
    ``test_sharded_pallas_step_matches_single_device`` and
    ``test_sharded_bag_matches_single_device`` at once)."""
    mesh = jax_mesh(MeshConfig(data=S, model=1))
    kw = CASES[case][0]
    if case in ("ihgnn", "phase2"):
        graph = jax_pad(_hyper(data), S)
    elif case == "gat":
        graph = jax_pad2d(data.graph2d, S)
    elif case == "log":
        graph = data.log_hypergraph
    else:
        graph = jax_pad(data.hypergraph, S, mesh=mesh, pack_kernels=True,
                        bag_inputs=(data.query_words, data.query_word_counts,
                                    VOCAB + 1))
        assert graph.skp is not None and graph.bag.n_shards == S
    _, losses, params, _ = _jax_run(data, kw, graph, mesh=mesh)
    _, one, many = runs[case]
    got = many[0]
    for a, b in zip(got["losses"], losses):
        assert _rel(a, b) <= JAX_LOSS_RTOL
    _assert_params(got["params"], params_from_jax(params), JAX_PARAM_TOL,
                   JAX_PARAM_TOL, _noise(one["grads0"]))


def test_grad_accum_sharded_step(runs):
    """Two stacked microbatches a step (``[2, R]``, rows split over the
    ranks, not the stack): against the port's one-device steps (1e-5)
    and the JAX package's (``grad_accum_steps=2``)."""
    (_, losses, params, _), one, many = runs["accum"]
    assert len({r["digest"] for r in many}) == 1
    got = many[0]
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=TOL)
    np.testing.assert_allclose(got["losses"], losses, rtol=JAX_LOSS_RTOL)
    _assert_params(got["params"], one["params"], TOL)
    _assert_params(got["params"], params_from_jax(params), JAX_PARAM_TOL,
                   JAX_PARAM_TOL)


def test_grad_accum_batch_split():
    """``shard_batch`` splits the row axis of ``[R]`` and stacked ``[k, R]``
    batches, not the stack axis (``test_grad_accum_batch_sharding_spec``)."""
    flat = TBatch(*(np.arange(8, dtype=np.int32) + 10 * k
                    for k in range(5)))
    stacked = TBatch.stack([flat, flat])
    for rank in range(4):
        mesh = Mesh(4, 1, rank, None, "gloo")
        got, got2 = shard_batch(flat, mesh), shard_batch(stacked, mesh)
        np.testing.assert_array_equal(got.users, [2 * rank, 2 * rank + 1])
        assert got2.users.shape == (2, 2)
        np.testing.assert_array_equal(got2.items, [got.items, got.items])
    with pytest.raises(ValueError, match="pad it first"):
        shard_batch(TBatch(*(np.zeros(6, np.int32) for _ in range(5))),
                    Mesh(4, 1, 0, None, "gloo"))


def test_sharded_bag_matches_one_device(runs):
    """``ShardedBag`` with Q = 7 over 4 ranks (a dummy query in the last
    slice): the bag means and the vocab table's gradient, summed over the
    ranks, against ``WordBag`` (1e-6)."""
    want, many = runs["bag"]
    for got in many:
        np.testing.assert_allclose(got["means"].numpy(),
                                   want["means"].numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(got["grad"].numpy(), want["grad"].numpy(),
                                   rtol=0, atol=1e-6)


def test_tail_psum_matches_full_combine(runs):
    """``score_tail`` (the last layer combined at the batch's node rows
    only) against the full combine of every layer, on each of 4 ranks:
    the rank's logits and the gradients of their sum, summed over the
    ranks (1e-6 of scale)."""
    for got in runs["tail"]:
        assert got["tail"]
        (lt, gt), (lf, gf) = got["tail"], got["full"]
        np.testing.assert_allclose(lt.numpy(), lf.numpy(), rtol=0,
                                   atol=1e-6 * lf.abs().max().item())
        for name, g in gf.items():
            np.testing.assert_allclose(
                gt[name].numpy(), g.numpy(), rtol=0,
                atol=1e-6 * max(g.abs().max().item(), 1e-30), err_msg=name)


def _port_loss(data, graph, kw, params0, batch):
    model = TRawGnn(tcfg.ModelConfig(embedding_size=D, **kw), U, Q, I, VOCAB)
    model.load_state_dict(params_from_jax(params0, model.table_rows))
    bag = make_word_bag(data.query_words, data.query_word_counts, VOCAB + 1)
    b = _port_batch(batch)
    t = [torch.from_numpy(getattr(b, f.name))
         for f in dataclasses.fields(TBatch)]
    with torch.no_grad():
        return ttrain.bce_with_logits(model(graph, bag, *t[:3]), t[3],
                                      t[4]).item()


@pytest.mark.parametrize("case", ["ihgnn", "hgcn", "phase2", "gat", "gcn"])
def test_padded_graph_matches_unpadded_loss(data, runs, case):
    """A graph padded for a mesh gives the unpadded loss (rel 1e-5): pad
    hyperedges zeroed by ``edge_mask`` and, for phase 2, left out of the
    attention; pad 2D entries (``val = 0``) adding nothing to GCN and
    masked out of GAT's softmax. Both against the JAX package's loss on
    its padded graph (``test_padded_*_matches_unpadded_loss``; for the
    cases of CASES, on its unpadded graph, which its own tests hold
    equal)."""
    kw = {"ihgnn": {}, "hgcn": {"gnn": V.HGCN},
          "phase2": {"phase2_attention": True}, "gat": {"gnn": V.GAT},
          "gcn": {"gnn": V.GCN}}[case]
    nodes = U + Q + I
    if case in ("gat", "gcn"):
        pad_to = data.graph2d.nnz + 3
        tgraph = build_graph2d(data.pos_uqif, nodes, U, Q)
        padded = pad_graph2d_for_mesh(tgraph, pad_to)
        assert padded.nnz == pad_to and padded.attention.mask is not None
        jpadded = jax_pad2d(data.graph2d, pad_to)
    else:
        pad_to = data.hypergraph.edge_count + 5
        tgraph = build_hypergraph(data.pos_uqif, nodes, U, Q)
        padded = pad_hypergraph_for_mesh(tgraph, pad_to)
        assert padded.edge_count == pad_to
        assert padded.edge_mask.sum().item() == tgraph.edge_count
        jpadded = jax_pad(_hyper(data), pad_to)
    if case in runs:
        params0, losses, _, batches = runs[case][0]
    else:
        params0, losses, _, batches = _jax_run(data, kw, jpadded, steps=1)
    loss_plain = _port_loss(data, tgraph, kw, params0, batches[0])
    loss_padded = _port_loss(data, padded, kw, params0, batches[0])
    assert loss_padded == pytest.approx(loss_plain, rel=1e-5)
    assert loss_padded == pytest.approx(losses[0], rel=1e-5)


def test_params_from_jax_drops_padded_table_rows(data, runs):
    """A JAX model built with ``table_row_multiple = 4`` (tables padded
    with zero rows for the mesh's model axis) maps onto the port's
    unpadded tables: the loss equals JAX's on the same weights (rel
    1e-5); nonzero padding is refused."""
    import jax.numpy as jnp
    model = RawGnn(cfg=ModelConfig(embedding_size=D), user_count=U,
                   query_count=Q, item_count=I, vocab_size=VOCAB,
                   table_row_multiple=4)
    z = jnp.zeros((1,), jnp.int32)
    padded = _np_tree(model.init(jax.random.key(0), _hyper(data),
                                 jnp.asarray(data.query_words),
                                 jnp.asarray(data.query_word_counts),
                                 z, z, z))
    assert padded["params"]["embeddings"]["user_table"].shape[1] == 12
    _, losses, _, batches = runs["ihgnn"][0]
    tgraph = build_hypergraph(data.pos_uqif, U + Q + I, U, Q)
    assert _port_loss(data, tgraph, {}, padded, batches[0]) == \
        pytest.approx(losses[0], rel=1e-5)
    bad = jax.tree_util.tree_map(np.array, padded)
    bad["params"]["embeddings"]["user_table"][:, -1] = 1.0
    with pytest.raises(ValueError, match="zero padding"):
        params_from_jax(bad, {"user": U + 1, "item": I + 1,
                              "vocab": VOCAB + 1})


def test_mesh_shapes_and_errors(tmp_path):
    """``make_mesh`` over a one-rank gloo group: the shape, and the errors
    for a world size that is not data × model (a (1, 2) mesh needs 2
    ranks), for another backend, and without a process group; a (1, 2)
    mesh's ranks, built from their coordinates."""
    import torch.distributed as dist
    with pytest.raises(RuntimeError, match="initialised"):
        make_mesh(tcfg.MeshConfig(data=2), "gloo")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(tcfg.MeshConfig(data=1), "gloo")
        assert mesh.shape == {"data": 1, "model": 1} and mesh.rank == 0
        assert mesh.bf16_wire
        assert not make_mesh(tcfg.MeshConfig(), "gloo",
                             bf16_wire=False).bf16_wire
        with pytest.raises(ValueError, match="needs 4 ranks"):
            make_mesh(tcfg.MeshConfig(data=4), "gloo")
        with pytest.raises(ValueError, match="needs 2 ranks"):
            make_mesh(tcfg.MeshConfig(data=1, model=2), "gloo")
        for rank in range(2):
            mesh = Mesh(1, 2, rank, None, "gloo")
            assert mesh.shape == {"data": 1, "model": 2}
            assert (mesh.data_index, mesh.model_index) == (0, rank)
        with pytest.raises(ValueError, match="runs 'gloo'"):
            make_mesh(tcfg.MeshConfig(), "nccl")
    finally:
        dist.destroy_process_group()


SOFTMAX_DST = {"one_rank": 0, "every_rank": 1, "no_rank": 2,
               "all_masked": 3}


@pytest.mark.parametrize("case", list(SOFTMAX_DST))
def test_softmax_across_ranks(runs, case):
    """``gat_conv`` over S ranks' entries (max and sum all-reduces of the
    softmax's scalars, the rank's partial combined) against one device
    over all of them, both heads, at the destination of ``case``
    (``_softmax_problem``): its output row, the gradient of its own row
    and of its sources' rows, within 1e-6 of scale; the head's and the
    bias's gradients too (for ``every_rank``). A destination with no entry
    or only masked ones gives 0 and gradients 0 at its sources, no NaN."""
    one, many = runs["softmax"]
    entries = _softmax_problem()[0]
    dst = SOFTMAX_DST[case]
    srcs = [e[1] for e in entries if e[2] == dst]
    ranks = {e[0] for e in entries if e[2] == dst}
    assert len(ranks) == {"one_rank": 1, "every_rank": S, "no_rank": 0,
                          "all_masked": 2}[case]
    for head, want in one.items():
        out, dx, dk, db = many[0][head]
        w_out, w_dx, w_dk, w_db = want
        for t in (out, dx, dk, db):
            assert torch.isfinite(t).all()
        scale = w_out.abs().max().item()
        assert (out[dst] - w_out[dst]).abs().max().item() <= 1e-6 * scale
        g_scale = w_dx.abs().max().item()
        rows = [dst] + srcs
        assert (dx[rows] - w_dx[rows]).abs().max().item() <= 1e-6 * g_scale
        if case in ("no_rank", "all_masked"):
            assert not out[dst].any() and not w_out[dst].any()
            assert not dx[srcs].any()
        if case == "every_rank":
            for got, ref in ((dk, w_dk), (db, w_db)):
                assert (got - ref).abs().max().item() <= 1e-6 * max(
                    g_scale, ref.abs().max().item())


def test_softmax_replicas_equal(runs):
    """Every rank ends the softmax job with the same output and the same
    gradients (summed over the ranks), bit for bit, for both heads."""
    _, many = runs["softmax"]
    for head in many[0]:
        for rank in many[1:]:
            for a, b in zip(rank[head], many[0][head]):
                assert torch.equal(a, b), head


def test_log_hypergraph_pads_and_shards():
    """A log hypergraph of 61 edges over 4 ranks: padded to 64 by
    memberless edges of degree 1, each rank a block of 16 whole edges with
    their members, its CSRs over all N nodes, the global ``dv``; the
    ranks' local node sums of ``edge_sum(x) / de`` add up to the one-device
    sum (1e-6)."""
    rng = np.random.default_rng(4)
    nodes = U + Q + I
    logs = [[int(rng.integers(0, U)), U + int(rng.integers(0, Q))]
            + [U + Q + int(i) for i in rng.choice(I, int(rng.integers(1, 4)),
                                                  replace=False)]
            for _ in range(61)]
    graph = build_log_hypergraph(logs, nodes)
    padded = pad_log_hypergraph_for_mesh(graph, S)
    assert padded.edge_count == 64
    assert torch.equal(padded.de[:61], graph.de)
    assert torch.equal(padded.de[61:], torch.ones(3, 1))
    assert padded.edge_rowptr[61:].unique().numel() == 1
    assert pad_log_hypergraph_for_mesh(padded, S) is padded
    x = torch.from_numpy(rng.standard_normal((nodes, D)).astype(np.float32))
    edge_sum, node_sum = make_log_ops(graph)
    want = node_sum(edge_sum(x) / graph.de)
    total, members = torch.zeros_like(want), []
    for rank in range(S):
        local = shard_graph(padded, Mesh(S, 1, rank, None, "gloo"))
        assert local.mesh is not None and local.edge_count == 16
        assert local.rowptr.shape[0] == nodes + 1
        assert torch.equal(local.dv, graph.dv)
        members.append(local.edge_nodes)
        edge_sum, node_sum = make_log_ops(dataclasses.replace(local,
                                                              mesh=None))
        total += node_sum(edge_sum(x) / local.de)
    assert torch.equal(torch.cat(members), graph.edge_nodes)
    np.testing.assert_allclose(total.numpy(), want.numpy(), rtol=0,
                               atol=1e-6 * want.abs().max().item())


def test_cli_two_ranks_gat(tmp_path):
    """``--mesh_data 2 --gnn gat`` under torchrun: the ranks' epoch losses
    equal the one-rank CLI run's (rel 1e-4)."""
    from ihgnn_tpu.data.artifacts import write_synthetic_dataset

    from ihgnn_torch.cli import main
    ds = str(tmp_path / "ds")
    write_synthetic_dataset(ds, seed=11, user_count=25, query_count=15,
                            item_count=40, vocab_size=30, log_count=300)
    common = ["--dataset", ds, "--emb", "8", "--device", "cpu", "--gnn",
              "gat", "--epoch_count", "2", "--epoch_start_test", "2",
              "--epoch_test_frequency", "2"]
    one = main(common + ["--result_dir", str(tmp_path / "one")])
    out = tmp_path / "out"
    out.mkdir()
    ranks = ranks_body.run_cli(2, [common + [
        "--result_dir", str(tmp_path / "two"), "--mesh_data", "2"]],
        str(out))
    assert ranks[0] == ranks[1]
    np.testing.assert_allclose([loss for _, loss in ranks[0][0]],
                               [s.avg_loss for s in one.epoch_stats],
                               rtol=1e-4)


def test_cli_two_ranks_one_result_directory(tmp_path):
    """``--mesh_data 2`` as torchrun starts it: one result directory, one
    log and metrics file, one checkpoint (rank 0's stamp); the losses
    equal the one-rank CLI run's (rel 1e-4); ``--checkpoint latest``
    resumes every rank from it."""
    from ihgnn_tpu.data.artifacts import write_synthetic_dataset

    from ihgnn_torch.cli import main
    ds = str(tmp_path / "ds")
    write_synthetic_dataset(ds, seed=11, user_count=25, query_count=15,
                            item_count=40, vocab_size=30, log_count=300)
    common = ["--dataset", ds, "--emb", "8", "--device", "cpu",
              "--epoch_start_test", "2", "--epoch_test_frequency", "2"]
    one = main(common + ["--epoch_count", "2",
                         "--result_dir", str(tmp_path / "one")])
    res = str(tmp_path / "two")
    out = tmp_path / "out"
    out.mkdir()
    mesh = ["--result_dir", res, "--mesh_data", "2"]
    ranks = ranks_body.run_cli(2, [
        common + mesh + ["--epoch_count", "2", "--storecheckpoint",
                         "--storemetrics"],
        common + mesh + ["--epoch_count", "1", "--checkpoint", "latest"]],
        str(out))
    assert ranks[0] == ranks[1]
    two, again = ranks[0]
    np.testing.assert_allclose([loss for _, loss in two],
                               [s.avg_loss for s in one.epoch_stats],
                               rtol=1e-4)
    (run_dir,) = os.listdir(res)
    names = sorted(os.listdir(os.path.join(res, run_dir)))
    checkpoints = [n for n in names if n.startswith("checkpoint_")]
    assert len(checkpoints) == 1 and checkpoints[0].endswith("_epoch2")
    assert len([n for n in names if n.endswith("_metrics.txt")]) == 1
    assert len([n for n in names if n.endswith("_train_log.txt")]) == 1
    # the resume starts at epoch 3, from the saved state
    assert [e for e, _ in again] == [3]
    assert again[0][1] < two[-1][1]
