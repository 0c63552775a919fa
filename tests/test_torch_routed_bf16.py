"""The routed pack on bf16 streams (``ModelConfig.bf16_stream`` with
``build_hypergraph(..., pack_kernels=True)``, the default of ``bench.py``)
on the CPU: the bf16 twins of ``gather_rows[_t]``, the three-region K1,
K5 and K8 against a float64 emulation of the bf16 contract; the routed
chains and K5 against the JAX package's Pallas kernels in interpret mode;
and ``RawGnn`` on a packed graph against the port's direct bf16 path and
the JAX XLA bf16 path.

Inputs come from numpy seeds; JAX's pack tables are the port's (held
table for table by ``tests/test_torch_routed.py``). The graphs: the
6/5/9-node synthetic graph of ``tests/test_bf16_stream.py`` and 400 edges
on a 128 × 128 grid (e_pad = 16384), so σ pads interleave with real edges.

Tolerances:
* the twins against the float64 emulation: each bf16 element within 1
  bf16 ulp of the larger of the two values plus 1e-6 of the largest (a
  twin sums in f32; a value near a rounding boundary may round the other
  way); f32 outputs within 1e-5 of the largest value; the copies exactly;
* against the Pallas kernels in interpret mode: the gathers' forwards and
  ``Scatter2Fn``'s backward bit for bit (copies, and one bf16 add of two
  bf16 values); the node sums (the scatters' forwards, K8) within 1e-5 of
  the largest value (f32 sums in another order); a gather's backward, the
  f32 node sum rounded once to bf16, within 1 bf16 ulp; K5 within 1 bf16
  ulp (bf16 outputs) and 1e-5 (dW, db); ``RoutedScatterFn``'s backward
  within 1 bf16 ulp of |c_u| + |c_q| + |c_i| (the port rounds the f32 sum
  of the three expansions once, Pallas adds them in bf16: ROADMAP §3);
* ``RawGnn``: against the port's direct bf16 path, features within 2e-3
  and step-0 gradients within 5e-3 of each tensor's largest value (the
  routed path sums a node's rows in another order, and rounds the
  gather's node gradient to bf16 where the direct path keeps it f32);
  against the JAX XLA bf16 path 1e-2 of scale for the features and the
  step-0 gradients, as ``tests/test_torch_bf16.py`` holds the direct path,
  and 1e-3 relative for 7 steps' losses; remat bit for bit.
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
from ihgnn_torch.ops.gather import gather_rows, gather_rows_t
from ihgnn_torch.ops.hyperagg import (GatherPreFn, RoutedGatherFn,
                                      RoutedScatterFn, Scatter2Fn,
                                      make_hyper_ops, strip_kernel_packing)
from ihgnn_torch.ops.interact import (ORDER_PARTS, InteractAbsorbFn,
                                      interact_bwd_absorb,
                                      interact_fwd_absorb)
from ihgnn_torch.ops.segscan import csr_segment_scan
from ihgnn_torch.ops.segscan import pack_scan_inputs as tpack_scan
from ihgnn_torch.ops.segsum import csr_segment_sum3
from ihgnn_torch.train import train as ttrain
from ihgnn_tpu import graph as jgraph
from ihgnn_tpu.config import Config, ModelConfig, TrainConfig
from ihgnn_tpu.data.dataset import Batch
from ihgnn_tpu.data.synthetic import make_synthetic_data
from ihgnn_tpu.models.rawgnn import RawGnn
from ihgnn_tpu.ops.hyperagg import (_gather_pre_pallas, _gather_roles_pallas,
                                    _scatter2_pallas, _scatter_pallas)
from ihgnn_tpu.ops.pallas.interact import fused_interaction_absorb
from ihgnn_tpu.ops.pallas.segscan import csr_segment_scan_t
from ihgnn_tpu.ops.pallas.segscan import pack_scan_inputs as jpack_scan
from ihgnn_tpu.train.train import (bce_with_logits, init_state,
                                   make_optimizer, make_train_step)

BF16 = torch.bfloat16
U, Q, I, VOCAB = 40, 25, 60, 30
N = U + Q + I
D = 8
P, B, K, LW = 400, 32, 10, 4
STEPS = 7
DIRECT_FEATURE_TOL, DIRECT_GRAD_TOL = 2e-3, 5e-3
XLA_TOL, XLA_STEPS_RTOL = 1e-2, 1e-3


# ---------------------------------------------------------------------------
# the float64 emulation of bf16 rounding
# ---------------------------------------------------------------------------


def rb(x):
    """float64 ``x`` rounded to bf16 (8 significant bits, to nearest even),
    in float64."""
    m, e = np.frexp(np.asarray(x, np.float64))
    return np.ldexp(np.rint(m * 256.0), e - 8)


def ulp(x):
    """One bf16 ulp at |x| (0 at 0)."""
    _, e = np.frexp(np.abs(np.asarray(x, np.float64)))
    return np.where(x == 0, 0.0, np.ldexp(1.0, e - 8))


def f64(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(t).astype(jnp.float32), np.float64)


def assert_bf16_close(got, want, name=""):
    got, want = f64(got), np.asarray(want, np.float64)
    tol = ulp(np.maximum(np.abs(got), np.abs(want))) \
        + 1e-6 * np.abs(want).max()
    bad = np.abs(got - want) > tol
    assert not bad.any(), (name, int(bad.sum()),
                           float(np.abs(got - want).max()))


def assert_f32_close(got, want, name="", tol=1e-5):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(f64(got), want, rtol=0,
                               atol=tol * np.abs(want).max(), err_msg=name)


def bf16_tensor(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(BF16)


def _np(t):
    return t.detach().float().numpy()


def _jt(t):
    """An ``[E, d]`` tensor as a feature-major JAX array of its dtype."""
    a = jnp.asarray(_np(t).T)
    return a.astype(jnp.bfloat16) if t.dtype == BF16 else a


@pytest.fixture(scope="module")
def graphs():
    """(JAX packed graph, the port's packed graph) of 400 edges."""
    rng = np.random.default_rng(0)
    uqi = np.stack([rng.integers(0, U, P), rng.integers(0, Q, P),
                    rng.integers(0, I, P)], axis=1)
    return (jgraph.build_hypergraph(uqi, N, U, Q),
            tgraph.build_hypergraph(uqi, N, U, Q, pack_kernels=True))


@pytest.fixture(scope="module")
def synth():
    """(JAX packed graph, the port's packed graph) of the 6/5/9-node
    synthetic graph."""
    data = make_synthetic_data(user_count=6, query_count=5, item_count=9,
                               vocab_size=12, log_count=60, seed=3)
    return data.hypergraph, tgraph.build_hypergraph(
        data.pos_uqif, data.node_count, data.user_count, data.query_count,
        pack_kernels=True)


def _e_pi(kp):
    return (np.arange(kp.rows)[:, None] * kp.cols
            + kp.i.p2.numpy()).reshape(-1)


# ---------------------------------------------------------------------------
# the twins against the float64 emulation of the contract
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("x_bf16", [False, True])
@pytest.mark.parametrize("transposed", [False, True])
def test_gather_rows_bf16_twin_is_the_rounded_copy(transposed, x_bf16):
    rng = np.random.default_rng(1 + transposed)
    x = rng.standard_normal((50, D)).astype(np.float32)
    idx = rng.integers(0, 50, (16, 24)).astype(np.int32)
    xt = torch.from_numpy(x)
    if x_bf16:
        xt = xt.to(BF16)
    fn = gather_rows_t if transposed else gather_rows
    got = fn(xt, torch.from_numpy(idx), dtype=BF16)
    want = rb(x.astype(np.float64)[idx])
    if transposed:
        want = want.transpose(1, 0, 2)
    assert got.dtype == BF16 and got.shape == want.shape
    np.testing.assert_array_equal(f64(got), want)
    out = torch.empty(want.shape, dtype=BF16)
    assert fn(xt, torch.from_numpy(idx), out=out) is out
    assert torch.equal(out, got)


@pytest.mark.parametrize("out_dtype", [None, BF16])
def test_segment_sum3_bf16_twin_matches_f64(graphs, out_dtype):
    """The three-region sum over the pack's CSR on bf16 regions: f32 sums,
    or rounded once to bf16."""
    kp = graphs[1].kp
    rng = np.random.default_rng(3)
    regions = [bf16_tensor(rng, kp.e_pad, D) for _ in range(3)]
    got = csr_segment_sum3(*regions, kp.seg_col, kp.seg_rowptr, out_dtype)
    stream = np.concatenate([f64(r) for r in regions])
    col, rowptr = kp.seg_col.numpy(), kp.seg_rowptr.numpy()
    want = np.zeros((N, D))
    np.add.at(want, np.repeat(np.arange(N), np.diff(rowptr)), stream[col])
    assert got.dtype == (out_dtype or torch.float32)
    if out_dtype is None:
        assert_f32_close(got, want)
    else:
        assert_bf16_close(got, rb(want))


def _absorb_inputs(kp, seed, order, out=D):
    rng = np.random.default_rng(seed)
    u, q, i_t1 = (bf16_tensor(rng, kp.e_pad, D) for _ in range(3))
    w = torch.from_numpy((rng.standard_normal(
        (ORDER_PARTS[order] * D, out)) / D).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(out).astype(np.float32))
    c1, c2 = (bf16_tensor(rng, kp.e_pad, out) for _ in range(2))
    return u, q, i_t1, w, b, c1, c2


def _emulate_parts(u, q, i, order):
    parts = [u, q, i]
    if order >= 2:
        parts += [rb(u * q), rb(q * i), rb(i * u)]
    if order >= 3:
        parts.append(rb(parts[3] * i))
    return parts


@pytest.mark.parametrize("order", [1, 2, 3])
def test_interact_absorb_bf16_twin_matches_f64_contract(graphs, order):
    """K5 on bf16: i read through π, o1 = the bf16 contract's output, o2 =
    ρ(o1) a copy; the backward's merged cotangent rounded once and masked,
    the bf16 product rule, di stored through ρ, dW and db in f32."""
    kp = graphs[1].kp
    u, q, i_t1, w, b, c1, c2 = _absorb_inputs(kp, 10 + order, order)
    e_pi = _e_pi(kp)
    mask = kp.sig_mask.numpy().astype(np.float64)
    uu, qq, ii = f64(u), f64(q), f64(i_t1)[e_pi]
    parts = _emulate_parts(uu, qq, ii, order)
    wr = rb(w.double().numpy())
    acc = sum(p @ wr[j * D:(j + 1) * D] for j, p in enumerate(parts))
    o1_want = rb(acc + b.double().numpy())
    o1, o2 = interact_fwd_absorb(u, q, i_t1, kp.i.p2, w, b, order)
    assert o1.dtype == o2.dtype == BF16
    assert_bf16_close(o1, o1_want, "o1")
    assert torch.equal(o2[torch.from_numpy(e_pi)], o1)

    cot = rb(f64(c1) + f64(c2)[e_pi]) * mask[:, None]
    dp = [cot @ wr[j * D:(j + 1) * D].T for j in range(len(parts))]
    du, dq, di = dp[0], dp[1], dp[2]
    if order >= 2:
        du = du + dp[3] * qq + dp[5] * ii
        dq = dq + dp[3] * uu + dp[4] * ii
        di = di + dp[4] * qq + dp[5] * uu
    if order >= 3:
        du = du + dp[6] * (qq * ii)
        dq = dq + dp[6] * (uu * ii)
        di = di + dp[6] * (uu * qq)
    di_t1 = np.empty_like(di)
    di_t1[e_pi] = di
    droles, dw, db = interact_bwd_absorb(u, q, i_t1, kp.i.p2, w, c1, c2,
                                         kp.sig_mask, order)
    assert droles.dtype == BF16 and dw.dtype == db.dtype == torch.float32
    for r, want in enumerate((du, dq, di_t1)):
        assert_bf16_close(droles[r], rb(want), "uqi"[r])
    assert_f32_close(dw, np.concatenate([p.T @ cot for p in parts]), "dw")
    assert_f32_close(db, cot.sum(0), "db")
    pads = mask == 0
    assert pads.any() and (_np(droles[0])[pads] == 0).all()


def test_segment_scan_bf16_twin_matches_f64(graphs):
    """K8 on the routed node-update stream's ids, bf16 values: f32 sums."""
    kp = graphs[1].kp
    rng = np.random.default_rng(4)
    stream = bf16_tensor(rng, 3 * kp.e_pad, D)
    got = csr_segment_scan(stream, kp.scan)
    assert got.dtype == torch.float32
    ids = kp.seg_ids.numpy().astype(np.int64)
    real = ids != 2 ** 31 - 1
    want = np.zeros((N, D))
    np.add.at(want, ids[real], f64(stream)[real])
    assert_f32_close(got, want)
    assert torch.equal(got, csr_segment_sum3(
        *stream.view(3, kp.e_pad, D), kp.seg_col, kp.seg_rowptr))


# ---------------------------------------------------------------------------
# against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("order", [1, 3])
def test_interact_absorb_bf16_matches_pallas(graphs, order):
    """K5's bf16 twin against ``fused_interaction_absorb`` on bf16 operands
    (the JAX pack's dg tables, the σ mask), forward and backward."""
    jk, kp = graphs[0].kp, graphs[1].kp
    u, q, i_t1, w, b, c1, c2 = _absorb_inputs(kp, 20 + order, order)

    def f(u_, q_, i_, w_, b_):
        return fused_interaction_absorb(u_, q_, i_, w_, b_[:, None],
                                        jk.i.fwd_p2.tab, jk.i.inv_p2.tab,
                                        jk.sig_mask, order, jk.cols)

    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(f, _jt(u), _jt(q), _jt(i_t1), jnp.asarray(w),
                           jnp.asarray(b))
        grads = vjp((_jt(c1), _jt(c2)))
    o1, o2 = interact_fwd_absorb(u, q, i_t1, kp.i.p2, w, b, order)
    for a, c in zip((o1, o2), out):
        assert c.dtype == jnp.bfloat16
        assert_bf16_close(a, f64(c).T)
    droles, dw, db = interact_bwd_absorb(u, q, i_t1, kp.i.p2, w, c1, c2,
                                         kp.sig_mask, order)
    for r in range(3):
        assert grads[r].dtype == jnp.bfloat16
        assert_bf16_close(droles[r], f64(grads[r]).T, "uqi"[r])
    assert_f32_close(dw, np.asarray(grads[3]), "dw")
    assert_f32_close(db, np.asarray(grads[4]).reshape(-1), "db")


def _node_inputs(kp, seed):
    rng = np.random.default_rng(seed)
    n = kp.node_count
    x = rng.standard_normal((n, D)).astype(np.float32)
    cot3 = bf16_tensor(rng, 3, kp.e_pad, D)
    edge, pre_i = bf16_tensor(rng, kp.e_pad, D), bf16_tensor(rng, kp.e_pad, D)
    cot_n = rng.standard_normal((n, D)).astype(np.float32)
    return x, cot3, edge, pre_i, cot_n


def _x_pad16(x, jk):
    """The JAX gather's input: x cast to bf16 at its entry, padded."""
    return jnp.pad(jnp.asarray(x.T).astype(jnp.bfloat16),
                   ((0, 0), (0, jk.src_pad - x.shape[0])))


@pytest.mark.parametrize("case", ["synth", "grid"])
def test_gather_pre_and_scatter2_bf16_match_pallas(graphs, synth, case):
    """``GatherPreFn`` and ``Scatter2Fn`` on bf16 streams against
    ``_gather_pre_pallas`` and ``_scatter2_pallas``, through
    ``value_and_grad``."""
    jg, tg = synth if case == "synth" else graphs
    jk, kp = jg.kp, tg.kp
    x, cot3, edge, pre_i, cot_n = _node_inputs(kp, 30)
    n = x.shape[0]
    with pltpu.force_tpu_interpret_mode():
        roles, vjp = jax.vjp(lambda a: _gather_pre_pallas(a, jk),
                             _x_pad16(x, jk))
        (gx,) = vjp(tuple(_jt(c) for c in cot3))
        nodes, vjp2 = jax.vjp(lambda a, c: _scatter2_pallas(a, c, jk),
                              _jt(edge), _jt(pre_i))
        ge, gp = vjp2(jnp.asarray(cot_n.T))
    xt = torch.from_numpy(x).requires_grad_()
    got = GatherPreFn.apply(xt, kp, BF16)
    assert got.dtype == BF16
    for r in range(3):
        np.testing.assert_array_equal(f64(got[r]), f64(roles[r]).T)
    got.backward(cot3)
    assert xt.grad.dtype == torch.float32 and gx.dtype == jnp.bfloat16
    assert_bf16_close(xt.grad, f64(gx)[:, :n].T, "x")
    et, pt = (t.clone().requires_grad_() for t in (edge, pre_i))
    got_n = Scatter2Fn.apply(et, pt, kp)
    assert got_n.dtype == torch.float32
    assert_f32_close(got_n, np.asarray(nodes).T, "node sums")
    got_n.backward(torch.from_numpy(cot_n))
    assert et.grad.dtype == pt.grad.dtype == BF16
    np.testing.assert_array_equal(f64(et.grad), f64(ge).T)
    np.testing.assert_array_equal(f64(pt.grad), f64(gp).T)


@pytest.mark.parametrize("case", ["synth", "grid"])
def test_routed_gather_and_scatter_bf16_match_pallas(graphs, synth, case):
    """``RoutedGatherFn`` and ``RoutedScatterFn`` on bf16 streams against
    ``_gather_roles_pallas`` and ``_scatter_pallas``; the scatter's
    backward within the stated departure, zero at the σ pads."""
    jg, tg = synth if case == "synth" else graphs
    jk, kp = jg.kp, tg.kp
    x, cot3, edge, _, cot_n = _node_inputs(kp, 31)
    n = x.shape[0]
    with pltpu.force_tpu_interpret_mode():
        roles, vjp = jax.vjp(lambda a: _gather_roles_pallas(a, jk),
                             _x_pad16(x, jk))
        (gx,) = vjp(tuple(_jt(c) for c in cot3))
        nodes, vjp2 = jax.vjp(lambda a: _scatter_pallas(a, jk), _jt(edge))
        (ge,) = vjp2(jnp.asarray(cot_n.T))
    xt = torch.from_numpy(x).requires_grad_()
    got = RoutedGatherFn.apply(xt, kp, BF16)
    for r in range(3):
        np.testing.assert_array_equal(f64(got[r]), f64(roles[r]).T)
    got.backward(cot3)
    assert_bf16_close(xt.grad, f64(gx)[:, :n].T, "x")
    et = edge.clone().requires_grad_()
    got_n = RoutedScatterFn.apply(et, kp)
    assert_f32_close(got_n, np.asarray(nodes).T, "node sums")
    got_n.backward(torch.from_numpy(cot_n))
    assert et.grad.dtype == BF16
    # |c_u| + |c_q| + |c_i| at each σ position, c the bf16 node cotangent:
    # the f32 scatter's gradient for |c|, the sum of its three expansions
    abs_c = torch.from_numpy(np.abs(rb(cot_n.astype(np.float64)))).float()
    et2 = torch.zeros(kp.e_pad, D, requires_grad=True)
    RoutedScatterFn.apply(et2, kp).backward(abs_c)
    diff = np.abs(f64(et.grad) - f64(ge).T)
    assert (diff <= ulp(f64(et2.grad))).all()
    pads = kp.sig_mask.numpy() == 0
    assert (f64(et.grad)[pads] == 0).all()


def test_segment_scan_bf16_matches_pallas():
    """K8's bf16 twin against ``csr_segment_scan_t`` on bf16 values (the
    ids of ``tests/test_segscan.py``, shuffled within blocks)."""
    rng = np.random.default_rng(5)
    n, k = 300, 2500
    ids = np.sort(rng.integers(0, n, size=k))
    for s0 in range(0, k - 1024 + 1, 1024):
        rng.shuffle(ids[s0:s0 + 1024])
    ids = np.concatenate([ids, np.full(3072 - k, 2 ** 31 - 1, np.int64)])
    vals = bf16_tensor(rng, 3072, D)
    want = csr_segment_scan_t(_jt(vals), jpack_scan(ids, n), n,
                              interpret=True)
    got = csr_segment_scan(vals, tpack_scan(ids, n))
    assert_f32_close(got, np.asarray(want).T)


# ---------------------------------------------------------------------------
# RawGnn on a packed graph with bf16 streams
# ---------------------------------------------------------------------------


def _synth_words(seed):
    rng = np.random.default_rng(seed)
    uqi = np.stack([rng.integers(0, U, P), rng.integers(0, Q, P),
                    rng.integers(0, I, P)], axis=1)
    qw = np.zeros((Q, LW), np.int32)
    qc = rng.integers(1, LW + 1, Q).astype(np.int32)
    for q in range(Q):
        qw[q, :qc[q]] = rng.integers(1, VOCAB + 1, qc[q])
    return uqi, qw, qc


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rawgnn_pair(seed, **kw):
    """(JAX RawGnn with bf16 streams, params, its unpacked graph (the XLA
    path), the port's packed graph, the port's RawGnn with the same
    weights, interactions, words)."""
    uqi, qw, qc = _synth_words(seed)
    jg = jgraph.build_hypergraph(uqi, N, U, Q, pack_kernels=False)
    tg = tgraph.build_hypergraph(uqi, N, U, Q, pack_kernels=True)
    model = RawGnn(ModelConfig(embedding_size=D, bf16_stream=True, **kw),
                   U, Q, I, VOCAB)
    z = jnp.zeros((1,), jnp.int32)
    params = model.init(jax.random.key(seed), jg, jnp.asarray(qw),
                        jnp.asarray(qc), z, z, z)
    ours = TRawGnn(tcfg.ModelConfig(embedding_size=D, bf16_stream=True, **kw),
                   U, Q, I, VOCAB)
    ours.load_state_dict(params_from_jax(_numpy_tree(params)), strict=True)
    return model, params, jg, tg, ours, uqi, qw, qc


def _batches(uqi, steps, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        idx = rng.integers(0, P, B)
        pu, pq, pi = uqi[idx, 0], uqi[idx, 1], uqi[idx, 2]
        out.append(TBatch(
            users=np.concatenate([pu, np.repeat(pu, K)]).astype(np.int32),
            queries=np.concatenate([pq, np.repeat(pq, K)]).astype(np.int32),
            items=np.concatenate([pi, rng.integers(0, I, B * K)]).astype(
                np.int32),
            flags=np.concatenate([np.ones(B, np.float32),
                                  np.zeros(B * K, np.float32)]),
            weight=np.ones(B * (1 + K), np.float32)))
    return out


def _jax_batch(b):
    return Batch(**{f.name: getattr(b, f.name)
                    for f in dataclasses.fields(TBatch)})


def _port_step0(ours, graph, qw, qc, batch):
    """(features, loss, gradients) of the port's model on ``graph``."""
    bag = make_word_bag(qw, qc, VOCAB + 1)
    ours.zero_grad()
    with torch.no_grad():
        feats = ours.all_features(graph, bag)
    t = [torch.from_numpy(getattr(batch, f.name))
         for f in dataclasses.fields(TBatch)]
    loss = ttrain.bce_with_logits(ours(graph, bag, *t[:3]), t[3], t[4])
    loss.backward()
    return (_np(feats), loss.item(),
            {k: p.grad.clone() for k, p in ours.named_parameters()})


def _scale_close(got, want, tol, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max(), err_msg=name)


def _grad_scale(name, grads):
    """The largest value of gradient ``name``; for the phase-2 score head
    the largest gradient of its layer (``tests/test_torch_layers.py``)."""
    if ".feature_aggregate." in name:
        layer = name.split(".")[:2]
        return max(g.abs().max().item() for k, g in grads.items()
                   if k.split(".")[:2] == layer)
    return max(grads[name].abs().max().item(), 1e-30)


@pytest.mark.parametrize("case", ["default", "phase2"])
def test_rawgnn_routed_bf16_matches_direct_bf16(case):
    """The routed bf16 path against the port's own direct bf16 path on the
    same weights: features and step-0 gradients. The default model runs
    ``GatherPreFn`` → K5 → ``Scatter2Fn``; phase 2 ``RoutedGatherFn`` →
    K3 → ``SigmaToEdgeFn``."""
    kw = {"phase2": dict(phase2_attention=True)}.get(case, {})
    _, _, _, tg, ours, uqi, qw, qc = _rawgnn_pair(21, **kw)
    assert tg.kp is not None and tg.kp.sig_mask is not None
    batch = _batches(uqi, 1, 13)[0]
    feats, loss, grads = _port_step0(ours, tg, qw, qc, batch)
    d_feats, d_loss, d_grads = _port_step0(ours, strip_kernel_packing(tg),
                                           qw, qc, batch)
    _scale_close(feats, d_feats, DIRECT_FEATURE_TOL, "features")
    assert loss == pytest.approx(d_loss, rel=1e-4)
    for name, g in d_grads.items():
        np.testing.assert_allclose(
            _np(grads[name]), _np(g), rtol=0,
            atol=DIRECT_GRAD_TOL * _grad_scale(name, d_grads), err_msg=name)


def test_rawgnn_routed_bf16_matches_jax_xla():
    """Features, the step-0 loss and every gradient against the JAX XLA
    bf16 path with JAX's weights carried across."""
    model, params, jg, tg, ours, uqi, qw, qc = _rawgnn_pair(12)
    jqw, jqc = jnp.asarray(qw), jnp.asarray(qc)
    feats = model.apply(params, jg, jqw, jqc, method=RawGnn.all_features)
    batch = _batches(uqi, 1, 13)[0]
    jb = _jax_batch(batch)

    def loss_fn(p):
        logits = model.apply(p, jg, jqw, jqc, jb.users, jb.queries, jb.items)
        return bce_with_logits(logits, jb.flags, jb.weight)
    loss, grads = jax.value_and_grad(loss_fn)(params)
    want = params_from_jax(_numpy_tree(grads))
    got_feats, got_loss, got_grads = _port_step0(ours, tg, qw, qc, batch)
    _scale_close(got_feats, np.asarray(feats).T, XLA_TOL, "features")
    assert got_loss == pytest.approx(float(loss), rel=1e-4)
    assert set(got_grads) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(_np(got_grads[name]), g.numpy(), rtol=0,
                                   atol=XLA_TOL * _grad_scale(name, want),
                                   err_msg=name)


def test_rawgnn_routed_bf16_train_steps_match_jax_xla():
    """STEPS train steps on the packed graph with bf16 streams against the
    JAX XLA bf16 path, from the same weights and batches."""
    model, params, jg, tg, ours, uqi, qw, qc = _rawgnn_pair(14)
    cfg = Config(model=ModelConfig(embedding_size=D, bf16_stream=True),
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
    for batch in _batches(uqi, STEPS, 15):
        state, loss = step(state, _jax_batch(batch))
        losses.append(float(loss))
        tlosses.append(tstep(batch).item())
    np.testing.assert_allclose(tlosses, losses, rtol=XLA_STEPS_RTOL)
    assert len(set(tlosses)) == STEPS


def test_rawgnn_routed_bf16_remat_is_bit_for_bit():
    """Two train steps with ``remat`` on the packed graph against the same
    steps without it: losses, gradients and parameters bit for bit."""
    uqi, qw, qc = _synth_words(16)
    tg = tgraph.build_hypergraph(uqi, N, U, Q, pack_kernels=True)
    runs = []
    for remat in (False, True):
        torch.manual_seed(0)
        ours = TRawGnn(tcfg.ModelConfig(embedding_size=D, bf16_stream=True,
                                        remat=remat), U, Q, I, VOCAB,
                       generator=torch.Generator().manual_seed(3))
        opt = ttrain.make_optimizer(ours.parameters(), tcfg.TrainConfig())
        step = ttrain.make_train_step(ours, tg, qw, qc, opt, device="cpu")
        losses = [step(b).item() for b in _batches(uqi, 2, 17)]
        runs.append((losses,
                     {k: p.grad.clone() for k, p in ours.named_parameters()},
                     {k: v.clone() for k, v in ours.state_dict().items()}))
    (la, ga, pa), (lb, gb, pb) = runs
    assert la == lb
    assert all(torch.equal(ga[k], gb[k]) for k in ga)
    assert all(torch.equal(pa[k], pb[k]) for k in pa)


def test_make_hyper_ops_routed_bf16_layer_runs_k5():
    """``make_hyper_ops`` on a packed graph with bf16 streams: the absorbed
    pair gives bf16 roles and bf16 K5 outputs, f32 node sums, and an f32
    gradient of x."""
    uqi, _, _ = _synth_words(18)
    tg = tgraph.build_hypergraph(uqi, N, U, Q, pack_kernels=True)
    kp = tg.kp
    gather, scatter = make_hyper_ops(tg, bf16_stream=True, absorb=True)
    rng = np.random.default_rng(19)
    x = torch.from_numpy(rng.standard_normal((N, D)).astype(
        np.float32)).requires_grad_()
    w = torch.from_numpy((rng.standard_normal((7 * D, D)) / D).astype(
        np.float32)).requires_grad_()
    b = torch.zeros(D, requires_grad=True)
    roles = gather(x)
    assert roles.dtype == BF16 and roles.shape == (3, kp.e_pad, D)
    pair = InteractAbsorbFn.apply(roles, w, b, kp.i.p2, kp.sig_mask, 3)
    assert pair[0].dtype == pair[1].dtype == BF16
    out = scatter(pair)
    assert out.dtype == torch.float32 and out.shape == (N, D)
    out.sum().backward()
    assert x.grad.dtype == torch.float32 and torch.isfinite(x.grad).all()
    assert w.grad.dtype == torch.float32
