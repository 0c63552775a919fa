"""The port's layer zoo against the JAX package on the CPU: the 2D graph
and the log hypergraph, the segment twins, K4's twin, the attention conv
(``GatConvFn``), the SpMM and log-hypergraph Functions, each layer, and
``RawGnn`` with GCN, GAT (both heads), HGCN (hypergraph and log
hypergraph) and IHGNN phase 2: features, catalog scores, the step-0 loss
and every gradient, and the losses of 6 train steps.

Inputs come from numpy seeds; weights are carried over with
``ihgnn_torch.convert``. The port's wrappers run their plain twins on CPU
tensors over the same index arrays the CUDA kernels read. The JAX side
runs its XLA path, as the JAX package's own tests run it on the CPU
(``use_pallas`` is False off the TPU, so ``GATLayer`` takes ``_GatCore``),
except that K4's twin is held against the Pallas ``csr_segment_max_t``
itself in interpret mode, on the dst ids and tile pointers of the JAX
package's own ``build_gat_pack``.

Shapes are ``tools/layers_bitcheck.py``'s: U/Q/I/V = 40/25/60/30, d = 16,
400 interactions, batches of 32 positives × 10 negatives.

Tolerances: values and gradients within 1e-5 (absolute and relative, or
of each tensor's largest value for the step-0 gradients): f32 sums taken
in another order. Losses within rtol 1e-5. One exception, the attention
score head's gradients in ``RawGnn``: the softmax does not change when
every score of a destination moves by one amount, so the head's bias
gradient, and the concat head's destination half, are sums whose terms
cancel but for the LeakyReLU's two slopes. Where the slopes of a layer are
alike (as in the second layer here) they are f32 rounding noise, which no
two summation orders reproduce to 1e-5 of its own size; they are held
within 1e-5 of the largest gradient of their layer instead.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ihgnn_torch import config as tcfg
from ihgnn_torch import graph as tgraph
from ihgnn_torch.convert import layer_params_from_jax, params_from_jax
from ihgnn_torch.data.dataset import Batch as TBatch
from ihgnn_torch.data.dataset import GraphData as TGraphData
from ihgnn_torch.models import layers as tlayers
from ihgnn_torch.models.embedding import make_word_bag
from ihgnn_torch.models.rawgnn import RawGnn as TRawGnn
from ihgnn_torch.ops import segment as tseg
from ihgnn_torch.ops.gatconv import GatConvFn
from ihgnn_torch.ops.hyperagg import make_log_ops, make_spmm_op
from ihgnn_torch.ops.segmax import (EMPTY_MAX, csr_segment_max,
                                    csr_segment_max_plain, csr_segment_sum)
from ihgnn_torch.train import train as ttrain
from ihgnn_tpu import graph as jgraph
from ihgnn_tpu.config import Config, ModelConfig, TrainConfig, V
from ihgnn_tpu.data.artifacts import write_synthetic_dataset
from ihgnn_tpu.data.dataset import Batch, GraphData
from ihgnn_tpu.models import layers as jlayers
from ihgnn_tpu.models.rawgnn import RawGnn
from ihgnn_tpu.ops import segment as jseg
from ihgnn_tpu.ops.gatconv import build_gat_pack
from ihgnn_tpu.ops.hyperagg import make_spmm_op as jax_spmm_op
from ihgnn_tpu.ops.pallas.segsum import csr_segment_max_t
from ihgnn_tpu.train.train import (bce_with_logits, init_state,
                                   make_optimizer, make_train_step)

U, Q, I, VOCAB = 40, 25, 60, 30
N = U + Q + I
D = 16
P, B, K, LW = 400, 32, 10, 4
STEPS = 6
TOL = dict(rtol=1e-5, atol=1e-5)
COMPLETENESS = (V.GRAPH_UQI, V.GRAPH_ONLY_UQ, V.GRAPH_ONLY_UI,
                V.GRAPH_ONLY_QI)


def _synth(seed=0, zero_flags=0.0):
    """``layers_bitcheck.synth``: (uqif [P, 4], query words, counts); a
    share ``zero_flags`` of the flags is 0."""
    rng = np.random.default_rng(seed)
    uqif = np.stack([rng.integers(0, U, P), rng.integers(0, Q, P),
                     rng.integers(0, I, P),
                     (rng.random(P) >= zero_flags).astype(np.int64)], axis=1)
    qw = np.zeros((Q, LW), np.int32)
    qc = rng.integers(1, LW + 1, Q).astype(np.int32)
    for q in range(Q):
        qw[q, :qc[q]] = rng.integers(1, VOCAB + 1, qc[q])
    return uqif, qw, qc


def _log_nodes(seed=3, logs=150):
    """Per-log {u, q, 1-3 items} global node lists."""
    rng = np.random.default_rng(seed)
    return [[int(rng.integers(0, U)), U + int(rng.integers(0, Q))]
            + [U + Q + int(i) for i in rng.choice(I, int(rng.integers(1, 4)),
                                                  replace=False)]
            for _ in range(logs)]


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _np(t):
    return t.detach().numpy()


def _assert_attention_csr(csr, src, dst, mask):
    """``csr`` holds the dst-sorted entries (src, dst) and a source order
    that lists the same entries sorted by source."""
    np.testing.assert_array_equal(_np(csr.src), src)
    np.testing.assert_array_equal(_np(csr.dst), dst)
    np.testing.assert_array_equal(
        _np(csr.dst_rowptr), np.searchsorted(dst, np.arange(csr.dst_count + 1)))
    to_dst = _np(csr.to_dst)
    np.testing.assert_array_equal(np.sort(to_dst), np.arange(len(src)))
    np.testing.assert_array_equal(src[to_dst], np.sort(src, kind="stable"))
    np.testing.assert_array_equal(_np(csr.src_dst), dst[to_dst])
    np.testing.assert_array_equal(
        _np(csr.src_rowptr),
        np.searchsorted(src[to_dst], np.arange(csr.node_count + 1)))
    if mask is None or (mask > 0).all():
        assert csr.mask is None
    else:
        np.testing.assert_array_equal(_np(csr.mask), (mask > 0) * 1.0)


# ---------------------------------------------------------------------------
# graphs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("self_connection", [False, True])
@pytest.mark.parametrize("completeness", COMPLETENESS)
def test_graph2d_matches_jax(completeness, self_connection):
    """Every array of ``build_graph2d`` in all four modes; a tenth of the
    flags are 0, so in uqi mode some i-u entries sum to 0 and are masked
    out of the attention."""
    uqif, _, _ = _synth(1, zero_flags=0.1)
    theirs = jgraph.build_graph2d(uqif, N, U, Q, completeness=completeness,
                                  use_self_connection=self_connection)
    ours = tgraph.build_graph2d(uqif, N, U, Q, completeness=completeness,
                                use_self_connection=self_connection)
    assert ours.nnz == theirs.nnz and ours.node_count == N
    for name in ("row", "col", "val", "dv", "dst_order"):
        a, b = _np(getattr(ours, name)), np.asarray(getattr(theirs, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    row, col = np.asarray(theirs.row), np.asarray(theirs.col)
    np.testing.assert_array_equal(_np(ours.rowptr),
                                  np.searchsorted(row, np.arange(N + 1)))
    order = np.asarray(theirs.dst_order)
    mask = np.asarray(theirs.val)[order]
    _assert_attention_csr(ours.attention, row[order], col[order], mask)
    # only uqi mode carries the flags, so only there do entries sum to 0
    assert (ours.attention.mask is not None) == (completeness == V.GRAPH_UQI)


def test_graph2d_rejects_unknown_completeness():
    uqif, _, _ = _synth()
    with pytest.raises(ValueError):
        tgraph.build_graph2d(uqif, N, U, Q, completeness="uv")


def test_log_hypergraph_matches_jax():
    nodes = _log_nodes()
    theirs = jgraph.build_log_hypergraph(nodes, N)
    ours = tgraph.build_log_hypergraph(nodes, N)
    assert (ours.node_count, ours.edge_count) == (N, theirs.edge_count)
    for name in ("inc_node", "inc_edge", "edge_nodes", "edge_ids", "dv",
                 "de"):
        a, b = _np(getattr(ours, name)), np.asarray(getattr(theirs, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(
        _np(ours.rowptr), np.searchsorted(_np(ours.inc_node),
                                          np.arange(N + 1)))
    np.testing.assert_array_equal(
        _np(ours.edge_rowptr), np.concatenate([[0], np.cumsum(
            np.asarray(theirs.de)[:, 0])]).astype(np.int32))
    assert (_np(ours.dv)[_np(ours.dv) < 1] == np.float32(1e-8)).all()


def test_hypergraph_phase2_csr():
    """The bipartite phase-2 list: edge node N + e → its members, in the
    node-major order of the incidence; its source order is edge-major."""
    uqif, _, _ = _synth()
    hg = tgraph.build_hypergraph(uqif, N, U, Q)
    csr = hg.phase2
    assert (csr.node_count, csr.dst_count) == (N + P, N)
    _assert_attention_csr(csr, _np(hg.inc_edge) + N, _np(hg.inc_node), None)
    np.testing.assert_array_equal(_np(csr.src_dst), _np(hg.i3).reshape(-1))
    assert torch.equal(csr.dst_rowptr, hg.rowptr)


@pytest.mark.parametrize("completeness", [V.GRAPH_UQI, V.GRAPH_ONLY_QI])
def test_graph_data_graphs_match_jax(tmp_path, completeness):
    write_synthetic_dataset(str(tmp_path), seed=11, user_count=25,
                            query_count=15, item_count=40, vocab_size=30,
                            log_count=300)
    theirs = GraphData.from_files(str(tmp_path),
                                  graph_completeness=completeness)
    ours = TGraphData.from_files(str(tmp_path),
                                 graph_completeness=completeness)
    for name in ("row", "col", "val", "dv", "dst_order"):
        np.testing.assert_array_equal(_np(getattr(ours.graph2d, name)),
                                      np.asarray(getattr(theirs.graph2d,
                                                         name)), name)
    for name in ("inc_node", "inc_edge", "edge_nodes", "edge_ids", "dv",
                 "de"):
        np.testing.assert_array_equal(
            _np(getattr(ours.log_hypergraph, name)),
            np.asarray(getattr(theirs.log_hypergraph, name)), name)
    assert ours.graph2d is ours.graph2d
    assert ours.log_hypergraph is ours.log_hypergraph
    # logs whose positives are all dropped give no edge
    assert ours.log_hypergraph.edge_count == sum(
        any(f > 0 for f in log.interactions) for log in ours.search_logs)


# ---------------------------------------------------------------------------
# segment twins and K4
# ---------------------------------------------------------------------------


def test_segment_max_matches_pallas_kernel():
    """``csr_segment_max`` against ``csr_segment_max_t`` in interpret mode,
    on ``build_gat_pack``'s dst ids and tile pointers: random scores, masked
    entries at -1e30, every fifth destination empty, and destinations whose
    entries are all masked. Empty segments read -3e38 on both sides."""
    rng = np.random.default_rng(0)
    n = 300
    dst = np.sort(rng.integers(0, n, 2000))
    dst = dst[dst % 5 != 0]
    src = rng.integers(0, n, len(dst))
    scores = rng.standard_normal(len(dst)).astype(np.float32) * 3
    scores[rng.random(len(dst)) < 0.2] = -1e30
    scores[(dst % 7 == 1)] = -1e30                   # all-masked segments
    pk = build_gat_pack(src, dst, n)
    padded = np.zeros(pk.k_pad, np.float32)
    padded[:pk.nnz] = scores
    ref = np.asarray(csr_segment_max_t(jnp.asarray(padded.reshape(-1, 128)),
                                       pk.dst_ids2d, pk.dst_tile_ptr, n,
                                       interpret=True))[0, :n]
    rowptr = torch.from_numpy(np.searchsorted(
        dst, np.arange(n + 1)).astype(np.int32))
    got = csr_segment_max(torch.from_numpy(scores), rowptr)
    assert torch.equal(got, csr_segment_max_plain(torch.from_numpy(scores),
                                                  rowptr))
    np.testing.assert_array_equal(_np(got), ref)
    empty = np.arange(n) % 5 == 0
    assert (_np(got)[empty] == np.float32(EMPTY_MAX)).all()
    all_masked = (np.arange(n) % 7 == 1) & ~empty
    assert (_np(got)[all_masked] == np.float32(-1e30)).all()


def test_segment_sum_scalar_twin():
    rng = np.random.default_rng(1)
    v = rng.standard_normal(50).astype(np.float32)
    rowptr = np.array([0, 0, 10, 10, 49, 50, 50], np.int32)
    got = csr_segment_sum(torch.from_numpy(v), torch.from_numpy(rowptr))
    want = [v[a:b].sum() for a, b in zip(rowptr[:-1], rowptr[1:])]
    np.testing.assert_allclose(_np(got), want, **TOL)
    assert got[0] == 0 and got[2] == 0 and got[5] == 0


def _segment_case(name, rng):
    """(port result, JAX result) of one ``ops/segment.py`` function on
    sorted ids with empty segments."""
    s = 30
    ids = np.sort(rng.integers(0, s, 200))
    ids = ids[ids % 4 != 1]
    v = rng.standard_normal((len(ids), 5)).astype(np.float32)
    t = torch.from_numpy
    if name == "segment_sum":
        return (tseg.segment_sum(t(v), t(ids), s),
                jseg.segment_sum(v, ids, s, indices_are_sorted=True))
    if name == "segment_max":
        return (tseg.segment_max(t(v), t(ids), s),
                jseg.segment_max(v, ids, s, indices_are_sorted=True))
    if name == "segment_softmax":
        return (tseg.segment_softmax(t(v[:, 0]), t(ids), s),
                jseg.segment_softmax(v[:, 0], ids, s, indices_are_sorted=True))
    x = rng.standard_normal((40, 5)).astype(np.float32)
    col = rng.integers(0, 40, len(ids))
    if name == "spmm":
        return (tseg.spmm(t(ids), t(col), t(v[:, 0]), t(x), s),
                jseg.spmm(ids, col, v[:, 0], x, s))
    i3 = rng.integers(0, 40, (50, 3))
    if name == "hyperedge_gather":
        return (tseg.hyperedge_gather(t(x), t(i3)),
                jseg.hyperedge_gather(x, i3))
    flat = i3.reshape(-1)
    order = np.argsort(flat, kind="stable")
    edge = rng.standard_normal((50, 5)).astype(np.float32)
    return (tseg.hyperedge_scatter(t(edge), t(order // 3), t(flat[order]), 40),
            jseg.hyperedge_scatter(edge, order // 3, flat[order], 40))


@pytest.mark.parametrize("name", ["segment_sum", "segment_max",
                                  "segment_softmax", "spmm",
                                  "hyperedge_gather", "hyperedge_scatter"])
def test_segment_twins_match_jax(name):
    got, want = _segment_case(name, np.random.default_rng(len(name)))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# the attention conv, SpMM and log-hypergraph Functions
# ---------------------------------------------------------------------------


def _attention_case(kind):
    """(src, dst, mask or None, M, S) of a destination-sorted edge list."""
    rng = np.random.default_rng(7)
    if kind == "graph2d":
        g = jgraph.build_graph2d(_synth(2, zero_flags=0.15)[0], N, U, Q)
        order = np.asarray(g.dst_order)
        return (np.asarray(g.row)[order], np.asarray(g.col)[order],
                np.asarray(g.val)[order], N, N)
    if kind == "phase2":
        g = jgraph.build_hypergraph(_synth(2)[0], N, U, Q, pack_kernels=False)
        return (np.asarray(g.inc_edge) + N, np.asarray(g.inc_node), None,
                N + P, N)
    # a bipartite list with empty and all-masked destinations
    m, s = 70, 50
    dst = np.sort(rng.integers(0, s, 400))
    dst = dst[dst % 6 != 2]
    src = rng.integers(0, m, len(dst))
    mask = (rng.random(len(dst)) > 0.25).astype(np.float32)
    mask[dst % 6 == 3] = 0.0
    return src, dst, mask, m, s


@pytest.mark.parametrize("kind", ["graph2d", "phase2", "masked"])
@pytest.mark.parametrize("head", [V.CONCAT, V.PRODUCT])
def test_gat_conv_matches_gat_core(head, kind):
    """``GatConvFn`` values and the gradients of x, the head's kernel and
    its bias against ``jax.vjp`` of ``_GatCore``, on random non-symmetric
    x (a wrong source/destination permutation would show)."""
    src, dst, mask, m, s = _attention_case(kind)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((m, D)).astype(np.float32)
    score_in = 2 * D if head == V.CONCAT else D
    k = (rng.standard_normal(score_in) / 4).astype(np.float32)
    b = rng.standard_normal(1).astype(np.float32)
    cot = rng.standard_normal((s, D)).astype(np.float32)

    core = jlayers._GatCore(D, head)

    def f(x_, k_, b_):
        params = {"params": {"feature_aggregate": {"kernel": k_[:, None],
                                                   "bias": b_}}}
        return core.apply(params, x_, jnp.asarray(src), jnp.asarray(dst), m,
                          entry_mask=None if mask is None
                          else jnp.asarray(mask))[:s]
    ref, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))
    ref_grads = vjp(jnp.asarray(cot))

    csr = tgraph.build_attention_csr(src, dst, m, s, mask)
    xt, kt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, k, b))
    out = GatConvFn.apply(xt, kt, bt, csr, head)
    np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL)
    out.backward(torch.from_numpy(cot))
    for name, t, r in zip(("x", "kernel", "bias"), (xt, kt, bt), ref_grads):
        np.testing.assert_allclose(_np(t.grad), np.asarray(r), err_msg=name,
                                   **TOL)


def test_spmm_fn_matches_xla():
    """GCN's SpMM: values and the gradient of x against the JAX XLA
    ``make_spmm_op`` (A symmetric, so Aᵀ·cot is the same SpMM)."""
    uqif, _, _ = _synth(4, zero_flags=0.1)
    jg = jgraph.build_graph2d(uqif, N, U, Q)
    tg = tgraph.build_graph2d(uqif, N, U, Q)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((N, D)).astype(np.float32)
    cot = rng.standard_normal((N, D)).astype(np.float32)
    ref, vjp = jax.vjp(jax_spmm_op(jg), jnp.asarray(x.T))
    xt = torch.from_numpy(x).requires_grad_()
    out = make_spmm_op(tg)(xt)
    np.testing.assert_allclose(_np(out), np.asarray(ref).T, **TOL)
    out.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(_np(xt.grad),
                               np.asarray(vjp(jnp.asarray(cot.T))[0]).T, **TOL)


def test_log_ops_match_xla():
    """The log hypergraph's edge and node sums, composed as HGCN composes
    them, against the JAX segment sums; the gradient of x."""
    nodes = _log_nodes(5)
    jg = jgraph.build_log_hypergraph(nodes, N)
    tg = tgraph.build_log_hypergraph(nodes, N)
    rng = np.random.default_rng(10)
    x = rng.standard_normal((N, D)).astype(np.float32)
    cot = rng.standard_normal((N, D)).astype(np.float32)

    def f(x_):
        edge = jseg.segment_sum(x_[jg.edge_nodes], jg.edge_ids,
                                jg.edge_count, indices_are_sorted=True)
        return jseg.segment_sum((edge / jg.de)[jg.inc_edge], jg.inc_node, N,
                                indices_are_sorted=True)
    ref, vjp = jax.vjp(f, jnp.asarray(x))
    edge_sum, node_sum = make_log_ops(tg)
    xt = torch.from_numpy(x).requires_grad_()
    edge = edge_sum(xt)
    assert edge.shape == (tg.edge_count, D)
    out = node_sum(edge / tg.de)
    np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL)
    out.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(_np(xt.grad),
                               np.asarray(vjp(jnp.asarray(cot))[0]), **TOL)


# ---------------------------------------------------------------------------
# layers and RawGnn
# ---------------------------------------------------------------------------

# case → (JAX ModelConfig / layer keywords, graph kind)
CASES = {
    "gcn": (dict(gnn=V.GCN), "graph2d"),
    "gat": (dict(gnn=V.GAT), "graph2d"),
    "gat_product": (dict(gnn=V.GAT, gat_head=V.PRODUCT), "graph2d"),
    "hgcn": (dict(gnn=V.HGCN), "hypergraph"),
    "hgcn_log": (dict(gnn=V.HGCN, use_log_hypergraph=True), "log"),
    "phase2": (dict(gnn=V.IHGNN, phase2_attention=True), "hypergraph"),
}


def _graphs(kind, uqif):
    """(JAX graph on its XLA path, the port's graph) of one kind."""
    if kind == "graph2d":
        return (jgraph.build_graph2d(uqif, N, U, Q),
                tgraph.build_graph2d(uqif, N, U, Q))
    if kind == "hypergraph":
        return (jgraph.build_hypergraph(uqif, N, U, Q, pack_kernels=False),
                tgraph.build_hypergraph(uqif, N, U, Q))
    nodes = _log_nodes()
    return (jgraph.build_log_hypergraph(nodes, N),
            tgraph.build_log_hypergraph(nodes, N))


def _layer_pair(case, in_dim, out_dim):
    kw, kind = CASES[case]
    gnn, head = kw["gnn"], kw.get("gat_head", V.CONCAT)
    if gnn == V.GCN:
        return jlayers.GCNLayer(in_dim, out_dim), tlayers.GCNLayer(
            in_dim, out_dim), kind
    if gnn == V.GAT:
        return jlayers.GATLayer(in_dim, out_dim, head), tlayers.GATLayer(
            in_dim, out_dim, head), kind
    if gnn == V.HGCN:
        return jlayers.HGCNLayer(in_dim, out_dim), tlayers.HGCNLayer(
            in_dim, out_dim), kind
    return (jlayers.IHGNNLayer(in_dim, out_dim, phase2_attention=True,
                               gat_head=head),
            tlayers.IHGNNLayer(in_dim, out_dim, phase2_attention=True,
                               gat_head=head), kind)


@pytest.mark.parametrize("case,in_dim", [(c, D) for c in CASES]
                         + [("gcn", 8)])
def test_layer_forward_matches_jax(case, in_dim):
    """Each layer's forward with carried-over weights; GCN at in < out runs
    the transform last."""
    theirs, ours, kind = _layer_pair(case, in_dim, D)
    jg, tg = _graphs(kind, _synth(6)[0])
    x = np.random.default_rng(11).standard_normal((N, in_dim)).astype(
        np.float32)
    params = theirs.init(jax.random.key(3), jnp.asarray(x.T), jg)
    ref = np.asarray(theirs.apply(params, jnp.asarray(x.T), jg)).T
    ours.load_state_dict(layer_params_from_jax(_numpy_tree(params)["params"]),
                         strict=True)
    got = ours(torch.from_numpy(x), tg)
    assert got.shape == (N, D)
    np.testing.assert_allclose(_np(got), ref, **TOL)


def _rawgnn_setup(case, seed):
    """(JAX RawGnn, its params, graphs, the port's RawGnn, word arrays)."""
    kw, kind = CASES[case]
    uqif, qw, qc = _synth(seed)
    jg, tg = _graphs(kind, uqif)
    model = RawGnn(ModelConfig(embedding_size=D, **kw), U, Q, I, VOCAB)
    z = jnp.zeros((1,), jnp.int32)
    params = model.init(jax.random.key(seed), jg, jnp.asarray(qw),
                        jnp.asarray(qc), z, z, z)
    ours = TRawGnn(tcfg.ModelConfig(embedding_size=D, **kw), U, Q, I, VOCAB)
    ours.load_state_dict(params_from_jax(_numpy_tree(params)), strict=True)
    return model, params, jg, tg, ours, uqif, qw, qc


def _batches(uqif, steps, seed):
    """``layers_bitcheck.make_batches``: B positives drawn from the
    interactions, each with K uniform negative items."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        idx = rng.integers(0, P, B)
        pu, pq, pi = uqif[idx, 0], uqif[idx, 1], uqif[idx, 2]
        out.append(TBatch(
            users=np.concatenate([pu, np.repeat(pu, K)]).astype(np.int32),
            queries=np.concatenate([pq, np.repeat(pq, K)]).astype(np.int32),
            items=np.concatenate([pi, rng.integers(0, I, B * K)]).astype(
                np.int32),
            flags=np.concatenate([np.ones(B, np.float32),
                                  np.zeros(B * K, np.float32)]),
            weight=np.ones(B * (1 + K), np.float32)))
    return out


def grad_scale(name, grads):
    """The largest value of gradient ``name``, or for an attention score
    head (``*.feature_aggregate.*``) the largest gradient of its layer (see
    the module docstring)."""
    if ".feature_aggregate." in name:
        layer = name.split(".")[:2]
        return max(g.abs().max().item() for k, g in grads.items()
                   if k.split(".")[:2] == layer)
    return max(grads[name].abs().max().item(), 1e-30)


def _jax_batch(b):
    return Batch(**{f.name: getattr(b, f.name)
                    for f in dataclasses.fields(TBatch)})


@pytest.mark.parametrize("case", list(CASES))
def test_rawgnn_features_and_grads_match_jax(case):
    """``all_features``, ``score_all_items``, and the step-0 loss and
    gradient of every parameter (each within 1e-5 of its tensor's largest
    value)."""
    model, params, jg, tg, ours, uqif, qw, qc = _rawgnn_setup(case, 12)
    jqw, jqc = jnp.asarray(qw), jnp.asarray(qc)
    bag = make_word_bag(qw, qc, VOCAB + 1)
    feats = model.apply(params, jg, jqw, jqc, method=RawGnn.all_features)
    got = ours.all_features(tg, bag)
    np.testing.assert_allclose(_np(got), np.asarray(feats).T, **TOL)
    users, queries = np.arange(8) % U, (np.arange(8) * 3) % Q
    ref = model.apply(params, feats, users, queries,
                      method=RawGnn.score_all_items)
    np.testing.assert_allclose(
        _np(ours.score_all_items(got, torch.from_numpy(users),
                                 torch.from_numpy(queries))),
        np.asarray(ref), **TOL)

    batch = _batches(uqif, 1, 13)[0]
    jb = _jax_batch(batch)

    def loss_fn(p):
        logits = model.apply(p, jg, jqw, jqc, jb.users, jb.queries, jb.items)
        return bce_with_logits(logits, jb.flags, jb.weight)
    loss, grads = jax.value_and_grad(loss_fn)(params)
    want = params_from_jax(_numpy_tree(grads))
    t = [torch.from_numpy(getattr(batch, f.name))
         for f in dataclasses.fields(TBatch)]
    got_loss = ttrain.bce_with_logits(ours(tg, bag, *t[:3]), t[3], t[4])
    got_loss.backward()
    assert got_loss.item() == pytest.approx(float(loss), rel=1e-5)
    named = dict(ours.named_parameters())
    assert set(named) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(_np(named[name].grad), g.numpy(), rtol=0,
                                   atol=1e-5 * grad_scale(name, want),
                                   err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_rawgnn_train_steps_match_jax(case):
    """STEPS steps of the port's train step against ``make_train_step`` on
    the same weights and batches: losses within rtol 1e-5."""
    model, params, jg, tg, ours, uqif, qw, qc = _rawgnn_setup(case, 14)
    cfg = Config(model=ModelConfig(embedding_size=D, **CASES[case][0]),
                 train=TrainConfig(batch_size=B,
                                   random_negative_sample_size=K))
    tx = make_optimizer(cfg)
    state = init_state(model, jax.random.key(0), jg, qw, qc, cfg, tx)
    state = dataclasses.replace(state, params=params,
                                opt_state=tx.init(params))
    step = make_train_step(model, jg, qw, qc, tx)
    opt = ttrain.make_optimizer(ours.parameters(), tcfg.TrainConfig())
    tstep = ttrain.make_train_step(ours, tg, qw, qc, opt, device="cpu")
    losses, tlosses = [], []
    for batch in _batches(uqif, STEPS, 15):
        state, loss = step(state, _jax_batch(batch))
        losses.append(float(loss))
        tlosses.append(tstep(batch).item())
    np.testing.assert_allclose(tlosses, losses, rtol=1e-5)
    assert len(set(tlosses)) == STEPS       # the model moved every step
