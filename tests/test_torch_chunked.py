"""The chunked hypergraph pack (``ChunkedHyperPack``) and its chains on
the CPU, against the JAX package: the pack table for table, the chunked
gather and scatter (``RoutedGatherFn``, ``GatherPreFn``,
``RoutedScatterFn``, ``Scatter2Fn``, ``SigmaToEdgeFn``) and their
gradients, the absorbed interaction's tables, and ``RawGnn`` on a
chunked packed graph.

Inputs come from numpy seeds. The graph is ``tests/test_hyperagg_pallas.py``
``_make_chunked``'s: E = 33000 edges packed at ``cols=128,
chunk_rows_cap=128`` into 3 chunks of 16384-slot grids, the last one
holding 232 edges (so only it pads). The JAX chains run their jnp twins
(``_kernels_active()`` is False on the CPU), which sum each chunk's node
partials in turn where the port runs one K1 over the CSR spanning the
chunks; one test runs the Pallas chains in interpret mode
(``csr_segment_sum3_multi`` itself).

Tolerances:
* the pack: exact (integer tables);
* the chains against the twins and interpret mode: each tensor within
  1e-5 of its largest value (f32 sums in another order);
* ``RawGnn`` against the JAX XLA path on the unpacked graph: 1e-5, as
  ``tests/test_torch_routed_model.py``;
* bf16 streams: the gathers' rows and ``Scatter2Fn``'s gradients bit for
  bit (copies, one bf16 add), the node sums within 1e-5 of the largest
  value, a gather's bf16 node gradient within 1 bf16 ulp, as
  ``tests/test_torch_routed_bf16.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ihgnn_torch import config as tcfg
from ihgnn_torch import graph as tgraph
from ihgnn_torch.convert import params_from_jax
from ihgnn_torch.data.dataset import Batch as TBatch
from ihgnn_torch.models.embedding import make_word_bag
from ihgnn_torch.models.rawgnn import RawGnn as TRawGnn
from ihgnn_torch.ops.hyperagg import (GatherPreFn, RoutedGatherFn,
                                      RoutedScatterFn, Scatter2Fn,
                                      sigma_to_edge_order)
from ihgnn_torch.ops.packing import (ChunkedHyperPack, HyperKernelPack,
                                     build_hyper_kernel_pack)
from ihgnn_torch.ops.segscan import SENTINEL
from ihgnn_torch.train import train as ttrain
from ihgnn_tpu import graph as jgraph
from ihgnn_tpu.config import ModelConfig, V
from ihgnn_tpu.data.dataset import Batch
from ihgnn_tpu.models.rawgnn import RawGnn
from ihgnn_tpu.ops import hyperagg as jhyper
from ihgnn_tpu.ops import packing as jpacking
from ihgnn_tpu.ops.pallas.permute import StageTable, unpack_stage_perm
from ihgnn_tpu.train.train import bce_with_logits

U, Q, I = 50, 40, 60
N = U + Q + I
E, CAP, COLS = 33000, 128, 128
D = 8
BF16 = torch.bfloat16


def _i3(edges=E, seed=9):
    """``_make_chunked``'s user-sorted ``[E, 3]`` global ids."""
    rng = np.random.default_rng(seed)
    u = np.sort(rng.integers(0, U, edges))
    return np.stack([u, U + rng.integers(0, Q, edges),
                     U + Q + rng.integers(0, I, edges)],
                    axis=1).astype(np.int64)


@pytest.fixture(scope="module")
def packs():
    """(JAX chunked pack, the port's) of the E = 33000 graph."""
    i3 = _i3()
    return (jpacking.build_hyper_kernel_pack(i3, N, cols=COLS,
                                             chunk_rows_cap=CAP),
            build_hyper_kernel_pack(i3, N, cols=COLS, chunk_rows_cap=CAP))


def _np(t):
    t = t.detach()
    return (t.float() if t.is_floating_point() else t).numpy()


def _abs_index(ep):
    idx = np.asarray(ep.idx)
    return (idx.reshape(idx.shape[0], -1)
            + np.asarray(ep.win)[:, None]).reshape(-1)


def _close(got, want, tol=1e-5, name=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=tol * np.abs(want).max(), err_msg=name)


# ---------------------------------------------------------------------------
# the pack
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("edges", [E, 3 * CAP * COLS])
def test_chunked_pack_matches_jax(edges):
    """Chunk for chunk, every table of the port's chunked pack equals the
    JAX pack's, decoded (expand ids, stages, σ mask, node-sum ids); every
    chunk but the last holds exactly ``cap · cols`` edges and only the last
    pads; the spanning CSR lists each node's real entries, chunk by chunk.
    At 3 · cap · cols edges no chunk pads."""
    i3 = _i3(edges)
    jk = jpacking.build_hyper_kernel_pack(i3, N, cols=COLS,
                                          chunk_rows_cap=CAP)
    kp = build_hyper_kernel_pack(i3, N, cols=COLS, chunk_rows_cap=CAP)
    assert isinstance(jk, jpacking.ChunkedHyperPack)
    assert isinstance(kp, ChunkedHyperPack)
    assert len(kp.packs) == len(jk.packs) == 3
    assert (kp.edge_count, kp.node_count, kp.cols) == (jk.e, jk.n, jk.cols)
    assert kp.e_pad == jk.e_pad
    for k, (ours, theirs) in enumerate(zip(kp.packs, jk.packs)):
        assert isinstance(ours, HyperKernelPack) and ours.scan is None
        assert (ours.rows, ours.cols, ours.edge_count) == (
            theirs.rows, theirs.cols, theirs.e)
        if k < 2:
            assert ours.edge_count == ours.e_pad == CAP * COLS
        for a, b in ((ours.u.idx, theirs.u_expand),
                     (ours.q.idx, theirs.q.gather),
                     (ours.i.idx, theirs.i.gather)):
            np.testing.assert_array_equal(_np(a).reshape(-1), _abs_index(b))
        for a, b in ((ours.q.p1, theirs.q.fwd_p1),
                     (ours.q.p1_inv, theirs.q.inv_p1),
                     (ours.i.p1, theirs.i.fwd_p1),
                     (ours.i.p1_inv, theirs.i.inv_p1),
                     (ours.i.p2, theirs.i.fwd_p2),
                     (ours.i.p2_inv, theirs.i.inv_p2),
                     (ours.sig, theirs.sig_stage)):
            np.testing.assert_array_equal(_np(a),
                                          np.asarray(unpack_stage_perm(b)))
        np.testing.assert_array_equal(_np(ours.seg_ids),
                                      np.asarray(theirs.ids2d).reshape(-1))
        if ours.edge_count == ours.e_pad:
            assert ours.sig_mask is None and theirs.sig_mask is None
        else:
            assert k == 2
            np.testing.assert_array_equal(
                _np(ours.sig_mask), np.asarray(theirs.sig_mask).reshape(-1))
    # the spanning CSR: [u | q | i] regions of e_pad rows over the chunks
    m = kp.e_pad
    regions = np.stack([np.full(m, SENTINEL, np.int64)] * 3)
    offset = 0
    for pk in kp.packs:
        regions[:, offset:offset + pk.e_pad] = \
            _np(pk.seg_ids).astype(np.int64).reshape(3, -1)
        offset += pk.e_pad
    ids = regions.reshape(-1)
    col = _np(kp.seg_col).astype(np.int64)
    rowptr = _np(kp.seg_rowptr).astype(np.int64)
    assert len(col) == 3 * edges
    nodes = np.repeat(np.arange(N), np.diff(rowptr))
    np.testing.assert_array_equal(ids[col], nodes)
    # within a node: chunk by chunk, each chunk's entries in stream order
    chunk_of = np.searchsorted(np.cumsum([pk.e_pad for pk in kp.packs]),
                               col % m, side="right")
    key = nodes * 4 + chunk_of
    assert np.all(np.diff(key) >= 0)


def test_absorb_tables_match_jax(packs):
    """The absorbed interaction's π (the chunks' i stage 2 stacked on the
    row axis) and σ mask (ones where a chunk has no pads) equal JAX's
    ``absorb_tables``."""
    jk, kp = packs
    pi, rho, mask, cols = jhyper.absorb_tables(jk)
    ours_pi, ours_mask = kp.absorb_tables()
    assert cols == kp.cols
    np.testing.assert_array_equal(
        _np(ours_pi), np.asarray(unpack_stage_perm(
            StageTable(tab=pi, kind="dg", w=128))))
    rho_full = np.asarray(unpack_stage_perm(
        StageTable(tab=rho, kind="dg", w=128)))
    inv = np.concatenate([_np(pk.i.p2_inv) for pk in kp.packs])
    np.testing.assert_array_equal(inv, rho_full)
    np.testing.assert_array_equal(_np(ours_mask), np.asarray(mask).reshape(-1))
    assert _np(ours_mask)[:2 * CAP * COLS].min() == 1.0


def test_build_hypergraph_chunks_past_the_cap():
    """``build_hypergraph(pack_kernels=True)`` chunks past its
    ``chunk_rows_cap``, as the JAX package chunks past 2048 rows."""
    i3 = _i3(2000)
    uqi = np.stack([i3[:, 0], i3[:, 1] - U, i3[:, 2] - U - Q], axis=1)
    graph = tgraph.build_hypergraph(uqi, N, U, Q, pack_kernels=True,
                                    chunk_rows_cap=128)
    assert isinstance(graph.kp, HyperKernelPack)
    small = build_hyper_kernel_pack(_i3(), N, cols=COLS, chunk_rows_cap=0)
    assert isinstance(small, HyperKernelPack) and small.rows > CAP


# ---------------------------------------------------------------------------
# the chains against the JAX chains (jnp twins)
# ---------------------------------------------------------------------------


def _x_pad(x, jk, dtype=jnp.float32):
    return jnp.pad(jnp.asarray(x.T).astype(dtype),
                   ((0, 0), (0, jk.src_pad - N)))


def _inputs(kp, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, D)).astype(np.float32)
    cot3 = rng.standard_normal((3, kp.e_pad, D)).astype(np.float32)
    edge, pre_i = (rng.standard_normal((kp.e_pad, D)).astype(np.float32)
                   for _ in range(2))
    cot_n = rng.standard_normal((N, D)).astype(np.float32)
    return x, cot3, edge, pre_i, cot_n


@pytest.mark.parametrize("pre", [False, True])
def test_chunked_gather_matches_jax(packs, pre):
    """``RoutedGatherFn`` / ``GatherPreFn`` on the chunked pack against
    ``_gather_roles_pallas`` / ``_gather_pre_pallas``: the three role
    streams (chunk concat) and the gradient of x."""
    jk, kp = packs
    x, cot3, _, _, _ = _inputs(kp, 5)
    fn = jhyper._gather_pre_pallas if pre else jhyper._gather_roles_pallas
    out, vjp = jax.vjp(lambda a: fn(a, jk), _x_pad(x, jk))
    (gx,) = vjp(tuple(jnp.asarray(c.T) for c in cot3))
    xt = torch.from_numpy(x).requires_grad_()
    got = (GatherPreFn if pre else RoutedGatherFn).apply(xt, kp)
    assert got.shape == (3, kp.e_pad, D)
    for r in range(3):
        np.testing.assert_array_equal(_np(got[r]), np.asarray(out[r]).T)
    got.backward(torch.from_numpy(cot3))
    _close(xt.grad, np.asarray(gx)[:, :N].T, name="x")


def test_chunked_scatter_matches_jax(packs):
    """``RoutedScatterFn`` against ``_scatter_pallas`` (node sums and the
    edge gradient, zero at the last chunk's σ pads) and ``Scatter2Fn``
    against ``_scatter2_pallas`` (node sums, both gradients)."""
    jk, kp = packs
    _, _, edge, pre_i, cot_n = _inputs(kp, 6)
    out, vjp = jax.vjp(lambda e: jhyper._scatter_pallas(e, jk),
                       jnp.asarray(edge.T))
    (ge,) = vjp(jnp.asarray(cot_n.T))
    et = torch.from_numpy(edge).requires_grad_()
    got = RoutedScatterFn.apply(et, kp)
    _close(got, np.asarray(out).T, name="scatter")
    got.backward(torch.from_numpy(cot_n))
    _close(et.grad, np.asarray(ge).T, name="scatter grad")
    pads = _np(kp.sig_mask) == 0
    assert pads.sum() == kp.e_pad - E and (_np(et.grad)[pads] == 0).all()

    out, vjp = jax.vjp(lambda a, b: jhyper._scatter2_pallas(a, b, jk),
                       jnp.asarray(edge.T), jnp.asarray(pre_i.T))
    ga, gb = vjp(jnp.asarray(cot_n.T))
    et, pt = (torch.from_numpy(a).requires_grad_() for a in (edge, pre_i))
    got = Scatter2Fn.apply(et, pt, kp)
    _close(got, np.asarray(out).T, name="scatter2")
    got.backward(torch.from_numpy(cot_n))
    _close(et.grad, np.asarray(ga).T, name="scatter2 grad edge")
    _close(pt.grad, np.asarray(gb).T, name="scatter2 grad pre_i")


def test_chunked_sigma_to_edge_matches_jax(packs):
    """``SigmaToEdgeFn`` on the chunked pack: each chunk's real edges at
    its first edge's row, as JAX's ``sigma_to_edge_order`` (whose concat
    holds them there, no inner chunk padding); the gradient puts the
    cotangent back at the σ positions, 0 at the pads."""
    jk, kp = packs
    _, _, edge, _, _ = _inputs(kp, 7)
    want = np.asarray(jhyper.sigma_to_edge_order(jnp.asarray(edge.T),
                                                 jk)).T[:E]
    et = torch.from_numpy(edge).requires_grad_()
    got = sigma_to_edge_order(et, kp)
    np.testing.assert_array_equal(_np(got), want)
    cot = np.random.default_rng(8).standard_normal((E, D)).astype(np.float32)
    got.backward(torch.from_numpy(cot))
    _, vjp = jax.vjp(lambda a: jhyper.sigma_to_edge_order(a, jk)[:, :E],
                     jnp.asarray(edge.T))
    (back,) = vjp(jnp.asarray(cot.T))
    np.testing.assert_array_equal(_np(et.grad), np.asarray(back).T)


def test_chunked_scatter_matches_pallas_interpret():
    """The Pallas chunked scatter in interpret mode, on the smallest
    chunked graph (2 chunks, E = 17000): the chunks' inverse chains and
    ``csr_segment_sum3_multi`` itself, against ``RoutedScatterFn``'s one K1
    over the spanning CSR."""
    i3 = _i3(17000, seed=11)
    jk = jpacking.build_hyper_kernel_pack(i3, N, cols=COLS,
                                          chunk_rows_cap=CAP)
    kp = build_hyper_kernel_pack(i3, N, cols=COLS, chunk_rows_cap=CAP)
    assert len(kp.packs) == len(jk.packs) == 2
    _, _, edge, _, _ = _inputs(kp, 12)
    with pltpu.force_tpu_interpret_mode():
        nodes = jhyper._scatter_pallas(jnp.asarray(edge.T), jk)
    _close(RoutedScatterFn.apply(torch.from_numpy(edge), kp),
           np.asarray(nodes).T, name="scatter")


# ---------------------------------------------------------------------------
# bf16 streams
# ---------------------------------------------------------------------------


def _ulp(x):
    _, e = np.frexp(np.abs(np.asarray(x, np.float64)))
    return np.where(x == 0, 0.0, np.ldexp(1.0, e - 8))


def _bf16_close(got, want, name=""):
    got, want = _np(got).astype(np.float64), np.asarray(want, np.float64)
    tol = _ulp(np.maximum(np.abs(got), np.abs(want))) \
        + 1e-6 * np.abs(want).max()
    bad = np.abs(got - want) > tol
    assert not bad.any(), (name, int(bad.sum()),
                           float(np.abs(got - want).max()))


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def test_chunked_bf16_chains_match_jax(packs):
    """The chunked chains on bf16 streams against the JAX chains on bf16
    streams (the Pallas contract, in its jnp twins): ``GatherPreFn``'s
    rows bit for bit and its bf16-rounded node gradient within 1 bf16 ulp;
    ``Scatter2Fn``'s node sums within 1e-5 of the largest value and its
    bf16 gradients bit for bit."""
    jk, kp = packs
    x, cot3, edge, pre_i, cot_n = _inputs(kp, 13)
    cot3_16 = torch.from_numpy(cot3).to(BF16)
    edge16, pre16 = (torch.from_numpy(a).to(BF16) for a in (edge, pre_i))

    def jt(t):
        return jnp.asarray(_np(t).T).astype(jnp.bfloat16)

    roles, vjp = jax.vjp(lambda a: jhyper._gather_pre_pallas(a, jk),
                         _x_pad(x, jk, jnp.bfloat16))
    (gx,) = vjp(tuple(jt(c) for c in cot3_16))
    nodes, vjp2 = jax.vjp(lambda a, c: jhyper._scatter2_pallas(a, c, jk),
                          jt(edge16), jt(pre16))
    ge, gp = vjp2(jnp.asarray(cot_n.T))

    xt = torch.from_numpy(x).requires_grad_()
    got = GatherPreFn.apply(xt, kp, BF16)
    assert got.dtype == BF16
    for r in range(3):
        np.testing.assert_array_equal(_np(got[r]), _f32(roles[r]).T)
    got.backward(cot3_16)
    assert gx.dtype == jnp.bfloat16
    _bf16_close(xt.grad, _f32(gx)[:, :N].T, "x")
    et, pt = (t.clone().requires_grad_() for t in (edge16, pre16))
    got_n = Scatter2Fn.apply(et, pt, kp)
    assert got_n.dtype == torch.float32
    _close(got_n, np.asarray(nodes).T, name="node sums")
    got_n.backward(torch.from_numpy(cot_n))
    assert et.grad.dtype == pt.grad.dtype == BF16
    np.testing.assert_array_equal(_np(et.grad), _f32(ge).T)
    np.testing.assert_array_equal(_np(pt.grad), _f32(gp).T)


# ---------------------------------------------------------------------------
# RawGnn on a chunked packed graph
# ---------------------------------------------------------------------------

VOCAB, LW, B, K, DM = 30, 4, 32, 10, 16
# (model, edges, pack cols, chunk_rows_cap); 17000 edges make two chunks
MODEL_CASES = {"ihgnn": (dict(), 17000, COLS, CAP),
               "hgcn": (dict(gnn=V.HGCN), 17000, COLS, CAP),
               "phase2": (dict(phase2_attention=True), 17000, COLS, CAP),
               # a cap that is no multiple of 128 pads every chunk
               "phase2_inner_pads": (dict(phase2_attention=True), 17000,
                                     COLS, 100),
               # build_hypergraph's own cols: the last chunk packs on a
               # narrower grid (128 columns, the others 256), so K5 does
               # not absorb
               "ihgnn_mixed_grids": (dict(), E, 1024, CAP)}


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _grad_scale(name, grads):
    if ".feature_aggregate." in name:
        layer = name.split(".")[:2]
        return max(g.abs().max().item() for k, g in grads.items()
                   if k.split(".")[:2] == layer)
    return max(grads[name].abs().max().item(), 1e-30)


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_rawgnn_on_chunked_graph_matches_jax(case):
    """Features, the step-0 loss and every gradient of ``RawGnn`` on a
    chunked packed graph (the default model absorbs the i stage over the
    stacked tables) against the JAX package's XLA path on the unpacked
    graph, within 1e-5 (of each gradient's largest value)."""
    kw, edges, cols, cap = MODEL_CASES[case]
    i3 = _i3(edges, seed=21)
    uqi = np.stack([i3[:, 0], i3[:, 1] - U, i3[:, 2] - U - Q], axis=1)
    rng = np.random.default_rng(22)
    qw = np.zeros((Q, LW), np.int32)
    qc = rng.integers(1, LW + 1, Q).astype(np.int32)
    for q in range(Q):
        qw[q, :qc[q]] = rng.integers(1, VOCAB + 1, qc[q])
    jg = jgraph.build_hypergraph(uqi, N, U, Q, pack_kernels=False)
    if cols == 1024:
        tg = tgraph.build_hypergraph(uqi, N, U, Q, pack_kernels=True,
                                     chunk_rows_cap=cap)
        assert not tg.kp.absorbs
    else:
        tg = dataclasses.replace(
            tgraph.build_hypergraph(uqi, N, U, Q),
            kp=build_hyper_kernel_pack(i3, N, cols, chunk_rows_cap=cap))
        assert tg.kp.absorbs
    assert isinstance(tg.kp, ChunkedHyperPack)
    if cap % 128:
        assert all(pk.edge_count < pk.e_pad for pk in tg.kp.packs)
    model = RawGnn(ModelConfig(embedding_size=DM, **kw), U, Q, I, VOCAB)
    z = jnp.zeros((1,), jnp.int32)
    params = jax.jit(model.init)(jax.random.key(0), jg, jnp.asarray(qw),
                                 jnp.asarray(qc), z, z, z)
    ours = TRawGnn(tcfg.ModelConfig(embedding_size=DM, **kw), U, Q, I, VOCAB)
    ours.load_state_dict(params_from_jax(_numpy_tree(params)), strict=True)
    bag = make_word_bag(qw, qc, VOCAB + 1)
    jqw, jqc = jnp.asarray(qw), jnp.asarray(qc)
    feats = jax.jit(lambda p: model.apply(p, jg, jqw, jqc,
                                          method=RawGnn.all_features))(params)
    np.testing.assert_allclose(_np(ours.all_features(tg, bag)),
                               np.asarray(feats).T, rtol=1e-5, atol=1e-5)

    idx = np.random.default_rng(23).integers(0, edges, B)
    pu, pq, pi = uqi[idx, 0], uqi[idx, 1], uqi[idx, 2]
    batch = TBatch(
        users=np.concatenate([pu, np.repeat(pu, K)]).astype(np.int32),
        queries=np.concatenate([pq, np.repeat(pq, K)]).astype(np.int32),
        items=np.concatenate([pi, rng.integers(0, I, B * K)]).astype(
            np.int32),
        flags=np.concatenate([np.ones(B, np.float32),
                              np.zeros(B * K, np.float32)]),
        weight=np.ones(B * (1 + K), np.float32))
    jb = Batch(**{f.name: getattr(batch, f.name)
                  for f in dataclasses.fields(TBatch)})

    def loss_fn(p):
        logits = model.apply(p, jg, jqw, jqc, jb.users, jb.queries, jb.items)
        return bce_with_logits(logits, jb.flags, jb.weight)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = params_from_jax(_numpy_tree(grads))
    t = [torch.from_numpy(getattr(batch, f.name))
         for f in dataclasses.fields(TBatch)]
    got_loss = ttrain.bce_with_logits(ours(tg, bag, *t[:3]), t[3], t[4])
    got_loss.backward()
    assert got_loss.item() == pytest.approx(float(loss), rel=1e-5)
    named = dict(ours.named_parameters())
    for name, g in want.items():
        np.testing.assert_allclose(_np(named[name].grad), g.numpy(), rtol=0,
                                   atol=1e-5 * _grad_scale(name, want),
                                   err_msg=name)
