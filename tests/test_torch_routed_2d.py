"""The routed 2D graph on the CPU, against the JAX package: the role pack
``pk_role`` and the GAT packs (``ops/gatpack.py``) table for table, the
window test that refuses a pack, the routed GCN SpMM (``RoutedSpmmFn``)
and the routed GAT (``RoutedGatConvFn``, both heads, single and chunked
packs), ``GATLayer`` and ``GCNLayer`` on a packed ``Graph2D``, and 6 GAT
train steps.

Inputs come from numpy seeds. The JAX routed functions (``_spmm_role_t``,
``gat_conv_t``) run their jnp twins, as ``tests/test_gatconv.py`` runs
them on the CPU; the JAX layers and ``RawGnn`` run their XLA path
(``use_pallas`` is False off the TPU), with weights carried over by
``ihgnn_torch.convert`` unchanged (the routed GAT's parameters are
``_GatCore``'s).

Graphs: ``tests/test_gatconv.py``'s 700-interaction uqi graph (one GAT
pack, the one-pack shortcut of ``src_cuts``); its chunked list (600
nodes, 9000 entries at ``cols=128, chunk_rows_cap=16``: 5 chunks); a list
whose chunks draw sources from two regions 20000 ids apart, which the
window test refuses and which splits by source region; and the layer
tests' 400-interaction graph of ``tests/test_torch_layers.py``.

Tolerances: the packs exact (integer tables); values and gradients
within 1e-5 of each tensor's largest value (f32 sums in another order);
the train steps' losses within rtol 1e-5.
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
from ihgnn_torch.models import layers as tlayers
from ihgnn_torch.models.rawgnn import RawGnn as TRawGnn
from ihgnn_torch.ops.gatconv import RoutedGatConvFn
from ihgnn_torch.ops.gatpack import ChunkedGatPack, GatPack
from ihgnn_torch.ops.gatpack import build_gat_pack as tbuild_gat_pack
from ihgnn_torch.ops.hyperagg import (RoutedSpmmFn, make_spmm_op,
                                      strip_kernel_packing)
from ihgnn_torch.ops.packing import SENTINEL, windows_fit
from ihgnn_torch.train import train as ttrain
from ihgnn_tpu import graph as jgraph
from ihgnn_tpu.config import Config, ModelConfig, TrainConfig, V
from ihgnn_tpu.data.dataset import Batch
from ihgnn_tpu.models import layers as jlayers
from ihgnn_tpu.models.rawgnn import RawGnn
from ihgnn_tpu.ops import gatconv as jgat
from ihgnn_tpu.ops.hyperagg import _spmm_role_t
from ihgnn_tpu.ops.pallas.gather import pack_windows
from ihgnn_tpu.ops.pallas.permute import unpack_stage_perm
from ihgnn_tpu.train.train import init_state, make_optimizer, make_train_step

D = 8


def _np(t):
    t = t.detach()
    return (t.float() if t.is_floating_point() else t).numpy()


def _abs_index(ep):
    idx = np.asarray(ep.idx)
    return (idx.reshape(idx.shape[0], -1)
            + np.asarray(ep.win)[:, None]).reshape(-1)


def _perm(st):
    return np.asarray(unpack_stage_perm(st))


def _close(got, want, tol=1e-5, name=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=tol * np.abs(want).max(), err_msg=name)


def _uqif(u, q, i, p, seed, flags=None):
    rng = np.random.default_rng(seed)
    out = np.stack([rng.integers(0, u, p), rng.integers(0, q, p),
                    rng.integers(0, i, p), np.ones(p, np.int64)], axis=1)
    if flags is not None:
        out[:, 3] = (rng.random(p) >= flags).astype(np.int64)
    return out


@pytest.fixture(scope="module")
def gat_graphs():
    """``tests/test_gatconv.py``'s graph: (JAX Graph2D, the port's packed
    Graph2D)."""
    U, Q, I, P = 40, 25, 60, 700
    uqif = _uqif(U, Q, I, P, 3)
    n = U + Q + I
    return (jgraph.build_graph2d(uqif, n, U, Q, completeness=V.GRAPH_UQI),
            tgraph.build_graph2d(uqif, n, U, Q, completeness=V.GRAPH_UQI,
                                 pack_kernels=True))


def _chunked_list():
    """``test_gat_conv_chunked_matches_single``'s entries."""
    rng = np.random.default_rng(7)
    n, e = 600, 9000
    return rng.integers(0, n, e), np.sort(rng.integers(0, n, e)), n


def _split_list():
    """Destination-sorted entries whose sources lie in [0, 5000) or
    [25000, 30000): a chunk's sorted source rows straddle the gap, so the
    window test refuses it, and each source region packs alone."""
    rng = np.random.default_rng(5)
    n, e = 30000, 6000
    src = np.where(rng.random(e) < 0.5, rng.integers(0, 5000, e),
                   rng.integers(25000, 30000, e))
    dst = np.sort(rng.integers(0, n, e))
    live = (rng.random(e) > 0.1).astype(np.float32)
    return src, dst, n, live, (5000, 25000)


# ---------------------------------------------------------------------------
# the packs
# ---------------------------------------------------------------------------


def test_role_pack_matches_jax(gat_graphs):
    """``pk_role``: the grid, the expand of the sorted cols composed with
    stage 0, and the forward stages 1 and 2, as JAX's; no backward route."""
    jg, tg = gat_graphs
    rp = tg.pk_role
    assert (rp.rows, rp.cols) == (jg.pk_rows, jg.pk_cols)
    np.testing.assert_array_equal(_np(rp.idx).reshape(-1),
                                  _abs_index(jg.pk_role.gather))
    np.testing.assert_array_equal(_np(rp.p1), _perm(jg.pk_role.fwd_p1))
    np.testing.assert_array_equal(_np(rp.p2), _perm(jg.pk_role.fwd_p2))
    assert rp.bwd_p0 is None and jg.pk_role.bwd_p0 is None
    np.testing.assert_array_equal(_np(tg.pk_entry), np.arange(tg.nnz))
    assert strip_kernel_packing(tg).pk_role is None
    assert strip_kernel_packing(tg).gat_pk is None


def _assert_gat_pack(ours, theirs):
    """One port ``GatPack`` equal to one JAX ``GatPack``, and the port's
    own CSRs listing exactly the JAX ids."""
    assert isinstance(ours, GatPack)
    assert (ours.nnz, ours.rows, ours.cols, ours.node_count, ours.k_pad) \
        == (theirs.nnz, theirs.rows, theirs.cols, theirs.n, theirs.k_pad)
    src = theirs.src_rp
    np.testing.assert_array_equal(_np(ours.src.idx).reshape(-1),
                                  _abs_index(src.gather))
    for a, b in ((ours.src.p1, src.fwd_p1), (ours.src.p2, src.fwd_p2),
                 (ours.src.bwd_p0, src.bwd_p0),
                 (ours.src.bwd_p1, src.bwd_p1)):
        np.testing.assert_array_equal(_np(a), _perm(b))
    ids = np.asarray(theirs.src_ids2d).reshape(-1)
    np.testing.assert_array_equal(_np(ours.src.seg_ids), ids)
    col, rowptr = _np(ours.src_col), _np(ours.src_rowptr)
    assert len(col) == theirs.nnz
    np.testing.assert_array_equal(
        ids[col], np.repeat(np.arange(theirs.n), np.diff(rowptr)))
    np.testing.assert_array_equal(_np(ours.dst_idx).reshape(-1),
                                  _abs_index(theirs.dst_exp))
    dst_ids = np.asarray(theirs.dst_ids2d).reshape(-1)
    assert (dst_ids[theirs.nnz:] == SENTINEL).all()
    np.testing.assert_array_equal(
        dst_ids[:theirs.nnz],
        np.repeat(np.arange(theirs.n), np.diff(_np(ours.dst_rowptr))))
    np.testing.assert_array_equal(_np(ours.mask),
                                  np.asarray(theirs.entry_mask).reshape(-1))


def test_gat_pack_single_matches_jax(gat_graphs):
    """The uqi graph's ``gat_pk``: one pack (the one-pack shortcut of the
    source-region split), table for table."""
    jg, tg = gat_graphs
    assert isinstance(jg.gat_pk, jgat.GatPack)
    _assert_gat_pack(tg.gat_pk, jg.gat_pk)


@pytest.mark.parametrize("kind", ["chunked", "src_split"])
def test_gat_pack_chunked_matches_jax(kind):
    """``build_gat_pack`` at ``cols=128, chunk_rows_cap=16``: the chunked
    list (5 chunks of 2048 entries), and the list whose chunks split by
    source region (masked entries included); pack for pack, in order."""
    if kind == "chunked":
        src, dst, n = _chunked_list()
        live, cuts = None, ()
    else:
        src, dst, n, live, cuts = _split_list()
    kw = dict(live=live, cols=128, chunk_rows_cap=16, src_cuts=cuts)
    theirs = jgat.build_gat_pack(src, dst, n, **kw)
    ours = tbuild_gat_pack(src, dst, n, **kw)
    assert isinstance(theirs, jgat.ChunkedGatPack)
    assert isinstance(ours, ChunkedGatPack)
    assert (ours.node_count, ours.nnz) == (theirs.n, theirs.nnz)
    assert len(ours.packs) == len(theirs.packs)
    if kind == "src_split":
        # every chunk split in two: more packs than chunks
        assert len(ours.packs) > -(-len(src) // (16 * 128))
    for a, b in zip(ours.packs, theirs.packs):
        _assert_gat_pack(a, b)


def test_window_test_matches_jax():
    """``windows_fit`` refuses exactly the tables ``pack_windows`` refuses;
    a 2D graph whose sorted cols span more than the cap gets no routed
    pack, as in JAX; a list whose source regions are refused alone gets no
    GAT pack."""
    rng = np.random.default_rng(1)
    for span in (1000, 16000, 16384, 16385, 40000):
        idx = np.sort(rng.integers(0, span, (4, 1024)), axis=1)
        idx[:, 0], idx[:, -1] = 0, span - 1
        try:
            pack_windows(idx)
            refused = False
        except ValueError:
            refused = True
        assert windows_fit(idx) == (not refused), span
    U = Q = I = 20000
    uqif = _uqif(U, Q, I, 300, 2)
    jg = jgraph.build_graph2d(uqif, U + Q + I, U, Q)
    tg = tgraph.build_graph2d(uqif, U + Q + I, U, Q, pack_kernels=True)
    assert jg.pk_role is None and tg.pk_role is None
    assert jg.gat_pk is None and tg.gat_pk is None
    src = rng.integers(0, 60000, 2000)
    dst = np.sort(rng.integers(0, 60000, 2000))
    assert jgat.build_gat_pack(src, dst, 60000, src_cuts=(30000,)) is None
    assert tbuild_gat_pack(src, dst, 60000, src_cuts=(30000,)) is None


# ---------------------------------------------------------------------------
# the routed functions
# ---------------------------------------------------------------------------


def test_routed_spmm_matches_jax(gat_graphs):
    """``RoutedSpmmFn`` against ``_spmm_role_t``: A·x and the gradient of
    x (A·cot)."""
    jg, tg = gat_graphs
    rng = np.random.default_rng(4)
    n = tg.node_count
    x = rng.standard_normal((n, D)).astype(np.float32)
    cot = rng.standard_normal((n, D)).astype(np.float32)
    out, vjp = jax.vjp(
        lambda a: _spmm_role_t(a, jg.pk_role, jg.pk_val, jg.pk_ids2d,
                               jg.pk_tile_ptr, n, jg.pk_rows, jg.pk_cols),
        jnp.asarray(x.T))
    (gx,) = vjp(jnp.asarray(cot.T))
    xt = torch.from_numpy(x).requires_grad_()
    got = RoutedSpmmFn.apply(xt, tg.pk_role, tg.pk_entry, tg.rowptr, tg.val)
    _close(got, np.asarray(out).T, name="spmm")
    got.backward(torch.from_numpy(cot))
    _close(xt.grad, np.asarray(gx).T, name="spmm grad")
    assert make_spmm_op(tg)(torch.from_numpy(x)).shape == (n, D)


def _gat_case(gat_graphs, pack):
    """(JAX pack, the port's, node count) of one pack kind."""
    if pack == "single":
        jg, tg = gat_graphs
        return jg.gat_pk, tg.gat_pk, tg.node_count
    src, dst, n = _chunked_list()
    kw = dict(cols=128, chunk_rows_cap=16)
    return (jgat.build_gat_pack(src, dst, n, **kw),
            tbuild_gat_pack(src, dst, n, **kw), n)


@pytest.mark.parametrize("pack", ["single", "chunked"])
@pytest.mark.parametrize("head", [V.CONCAT, V.PRODUCT])
def test_routed_gat_matches_jax(gat_graphs, head, pack):
    """``RoutedGatConvFn`` against ``gat_conv_t``: the output and the
    gradients of x, the head's kernel and its bias, each within 1e-5 of
    its largest value."""
    jpk, tpk, n = _gat_case(gat_graphs, pack)
    rng = np.random.default_rng(9)
    k_in = 2 * D if head == V.CONCAT else D
    x = rng.standard_normal((n, D)).astype(np.float32)
    k = rng.standard_normal((k_in,)).astype(np.float32)
    b = rng.standard_normal((1,)).astype(np.float32)
    cot = rng.standard_normal((n, D)).astype(np.float32)
    name = "concat" if head == V.CONCAT else "product"
    out, vjp = jax.vjp(lambda a, kk, bb: jgat.gat_conv_t(a, kk, bb, jpk,
                                                         name),
                       jnp.asarray(x.T), jnp.asarray(k[:, None]),
                       jnp.asarray(b))
    gx, gk, gb = vjp(jnp.asarray(cot.T))
    xt, kt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, k, b))
    got = RoutedGatConvFn.apply(xt, kt, bt, tpk, head)
    _close(got, np.asarray(out).T, name="out")
    got.backward(torch.from_numpy(cot))
    _close(xt.grad, np.asarray(gx).T, name="dx")
    _close(kt.grad, np.asarray(gk)[:, 0], name="dkhead")
    _close(bt.grad, np.asarray(gb), name="dbias")


# ---------------------------------------------------------------------------
# the layers and the model on a packed Graph2D
# ---------------------------------------------------------------------------

U, Q, I, VOCAB = 40, 25, 60, 30
N = U + Q + I
DM, P, B, K, LW, STEPS = 16, 400, 32, 10, 4, 6


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _layer_graphs(pack):
    """(JAX graph, the port's packed graph) of the layer tests' uqi graph,
    a tenth of its flags 0; ``chunked`` swaps in a ``ChunkedGatPack``."""
    uqif = _uqif(U, Q, I, P, 6, flags=0.1)
    jg = jgraph.build_graph2d(uqif, N, U, Q)
    tg = tgraph.build_graph2d(uqif, N, U, Q, pack_kernels=True)
    assert isinstance(tg.gat_pk, GatPack)
    if pack == "chunked":
        att = tg.attention
        tg = dataclasses.replace(tg, gat_pk=tbuild_gat_pack(
            _np(att.src), _np(att.dst), N,
            live=_np(tg.val)[_np(tg.dst_order)], cols=128,
            chunk_rows_cap=4, src_cuts=(U, U + Q)))
        assert isinstance(tg.gat_pk, ChunkedGatPack)
    return uqif, jg, tg


@pytest.mark.parametrize("case,pack", [("gcn", "single"),
                                       ("gat", "single"), ("gat", "chunked"),
                                       ("gat_product", "single")])
def test_layer_on_packed_graph2d_matches_jax(case, pack):
    """``GCNLayer`` (routed SpMM) and ``GATLayer`` (routed GAT) on a packed
    graph against the JAX layers, with carried-over weights."""
    _, jg, tg = _layer_graphs(pack)
    if case == "gcn":
        theirs, ours = jlayers.GCNLayer(DM, DM), tlayers.GCNLayer(DM, DM)
    else:
        head = V.CONCAT if case == "gat" else V.PRODUCT
        theirs = jlayers.GATLayer(DM, DM, head)
        ours = tlayers.GATLayer(DM, DM, head)
    x = np.random.default_rng(11).standard_normal((N, DM)).astype(np.float32)
    params = theirs.init(jax.random.key(3), jnp.asarray(x.T), jg)
    ref = np.asarray(theirs.apply(params, jnp.asarray(x.T), jg)).T
    ours.load_state_dict(layer_params_from_jax(_numpy_tree(params)["params"]),
                         strict=True)
    _close(ours(torch.from_numpy(x), tg), ref, name=case)


def test_gat_train_steps_on_packed_graph2d_match_jax():
    """6 train steps of ``RawGnn`` with two GAT layers on the packed 2D
    graph (the routed GAT, weights from ``params_from_jax`` unchanged)
    against ``make_train_step`` on the JAX graph: losses within rtol
    1e-5."""
    uqif, jg, tg = _layer_graphs("single")
    rng = np.random.default_rng(15)
    qw = np.zeros((Q, LW), np.int32)
    qc = rng.integers(1, LW + 1, Q).astype(np.int32)
    for q in range(Q):
        qw[q, :qc[q]] = rng.integers(1, VOCAB + 1, qc[q])
    cfg = Config(model=ModelConfig(embedding_size=DM, gnn=V.GAT),
                 train=TrainConfig(batch_size=B,
                                   random_negative_sample_size=K))
    model = RawGnn(cfg.model, U, Q, I, VOCAB)
    z = jnp.zeros((1,), jnp.int32)
    params = model.init(jax.random.key(14), jg, jnp.asarray(qw),
                        jnp.asarray(qc), z, z, z)
    ours = TRawGnn(tcfg.ModelConfig(embedding_size=DM, gnn=V.GAT), U, Q, I,
                   VOCAB)
    ours.load_state_dict(params_from_jax(_numpy_tree(params)), strict=True)
    tx = make_optimizer(cfg)
    state = init_state(model, jax.random.key(0), jg, qw, qc, cfg, tx)
    state = dataclasses.replace(state, params=params,
                                opt_state=tx.init(params))
    step = make_train_step(model, jg, qw, qc, tx)
    opt = ttrain.make_optimizer(ours.parameters(), tcfg.TrainConfig())
    tstep = ttrain.make_train_step(ours, tg, qw, qc, opt, device="cpu")
    losses, tlosses = [], []
    for _ in range(STEPS):
        idx = rng.integers(0, P, B)
        pu, pq, pi = uqif[idx, 0], uqif[idx, 1], uqif[idx, 2]
        batch = TBatch(
            users=np.concatenate([pu, np.repeat(pu, K)]).astype(np.int32),
            queries=np.concatenate([pq, np.repeat(pq, K)]).astype(np.int32),
            items=np.concatenate([pi, rng.integers(0, I, B * K)]).astype(
                np.int32),
            flags=np.concatenate([np.ones(B, np.float32),
                                  np.zeros(B * K, np.float32)]),
            weight=np.ones(B * (1 + K), np.float32))
        state, loss = step(state, Batch(**{
            f.name: getattr(batch, f.name)
            for f in dataclasses.fields(TBatch)}))
        losses.append(float(loss))
        tlosses.append(tstep(batch).item())
    np.testing.assert_allclose(tlosses, losses, rtol=1e-5)
    assert len(set(tlosses)) == STEPS
