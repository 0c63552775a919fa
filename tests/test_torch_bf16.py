"""The port's bf16 edge streams (``ModelConfig.bf16_stream``) and per-layer
remat (``ModelConfig.remat``) on the CPU, against a float64 emulation of
the bf16 contract, the JAX package's Pallas kernels in interpret mode and
its XLA bf16 path.

The contract (``ihgnn_torch/ops/interact.py``, ``ops/hyperagg.py``) is
the Pallas kernels': bf16 roles gathered from f32 node rows, parts rounded
to bf16 (u⊙q⊙i = round(round(u⊙q)⊙i)), W rounded to bf16, every sum in
f32, the interaction's output and its data gradient rounded to bf16 once,
dW, db and the node sums in f32, and the scatter's bf16 edge gradient
rounded once from the f32 sum of three bf16 node rows.

Tolerances:
* twins against the float64 emulation of the contract: each bf16 output
  element within 1 bf16 ulp of the larger of the two values (a twin sums
  in f32, so a value that lies near a rounding boundary may round the
  other way), plus 1e-6 of the tensor's largest value for elements that
  f32 cancellation leaves near 0; each f32 output within 1e-5 of the
  tensor's largest value;
* twins against the Pallas kernels in interpret mode: the same rule;
* the port against the JAX XLA bf16 path (``kp=None``): 1e-2 of each
  tensor's largest value for the features and the step-0 gradients
  (2e-2 with phase 2), 1e-4 relative for the step-0 loss and for 7
  steps' losses. The XLA path rounds elsewhere: its interaction
  output stays f32, and its gather's backward is a bf16 ``scatter-add``
  (each add rounded to bf16), where the port sums in f32. At the test
  graph's degrees (at most about 30 role entries a node) the bf16 adds are
  off by a few bf16 ulps of the sum, about 1e-2 of scale at worst. Phase 2
  feeds the edge rows, which the port rounds to bf16 and the XLA path
  keeps in f32, through the attention's softmax, and the x gradient then
  differs by up to 1.2e-2 of scale; the JAX package's own tests of its
  bf16 path against f32 (``tests/test_bf16_stream.py``) use 2e-2 and, for
  a layer's gradients, 3e-2;
* remat against no remat: bit for bit (the same twins run again on the
  same inputs); the port's remat against JAX's ``remat=True`` in f32:
  1e-5, as ``tests/test_torch_layers.py`` holds the model without it.
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
from ihgnn_torch.convert import layer_params_from_jax, params_from_jax
from ihgnn_torch.data.dataset import Batch as TBatch
from ihgnn_torch.models import layers as tlayers
from ihgnn_torch.models.embedding import make_word_bag
from ihgnn_torch.models.rawgnn import RawGnn as TRawGnn
from ihgnn_torch.ops.gather import gather_roles, gather_roles_plain
from ihgnn_torch.ops.hyperagg import (GatherRolesFn, SpmmFn,
                                      make_hyper_ops as torch_hyper_ops)
from ihgnn_torch.ops.interact import (ORDER_PARTS, InteractFn, interact_bwd,
                                      interact_bwd_plain, interact_fwd,
                                      interact_fwd_plain)
from ihgnn_torch.ops.segsum import csr_gather_sum
from ihgnn_torch.train import train as ttrain
from ihgnn_tpu import graph as jgraph
from ihgnn_tpu.config import Config, ModelConfig, TrainConfig
from ihgnn_tpu.data.dataset import Batch
from ihgnn_tpu.data.synthetic import make_synthetic_data
from ihgnn_tpu.models import layers as jlayers
from ihgnn_tpu.models.rawgnn import RawGnn
from ihgnn_tpu.ops.hyperagg import _scatter_pallas
from ihgnn_tpu.ops.pallas import interact as pallas_interact
from ihgnn_tpu.ops.pallas.segsum import (csr_segment_sum,
                                         prepare_segment_inputs)
from ihgnn_tpu.train.train import (bce_with_logits, init_state,
                                   make_optimizer, make_train_step)

BF16 = torch.bfloat16
U, Q, I, VOCAB = 40, 25, 60, 30
N = U + Q + I
D = 16
P, B, K, LW = 400, 32, 10, 4
STEPS = 7
XLA_LOSS_RTOL, XLA_STEPS_RTOL = 1e-4, 1e-4
CASES = {"default": {}, "phase2": dict(phase2_attention=True)}
# the features' and gradients' tolerance against the XLA bf16 path, of
# each tensor's largest value (the module docstring)
XLA_TOL = {"default": 1e-2, "phase2": 2e-2}


# ---------------------------------------------------------------------------
# the float64 emulation of bf16 rounding
# ---------------------------------------------------------------------------


def rb(x):
    """float64 ``x`` rounded to bf16 (8 significant bits, to nearest even),
    in float64; no bf16 type involved."""
    m, e = np.frexp(np.asarray(x, np.float64))
    return np.ldexp(np.rint(m * 256.0), e - 8)


def ulp(x):
    """One bf16 ulp at |x| (0 at 0)."""
    _, e = np.frexp(np.abs(np.asarray(x, np.float64)))
    return np.where(x == 0, 0.0, np.ldexp(1.0, e - 8))


def assert_bf16_close(got, want, name=""):
    """Each element of ``got`` (a bf16 tensor or array) within 1 bf16 ulp
    of the larger of the two values, plus 1e-6 of the largest ``want``."""
    got = np.asarray(torch.as_tensor(got).float().numpy(), np.float64) \
        if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    tol = ulp(np.maximum(np.abs(got), np.abs(want))) \
        + 1e-6 * np.abs(want).max()
    bad = np.abs(got - want) > tol
    assert not bad.any(), (name, int(bad.sum()),
                           float(np.abs(got - want).max()))


def assert_f32_close(got, want, name=""):
    got = np.asarray(got.detach().numpy() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max(), err_msg=name)


def bf16_tensor(rng, *shape, scale=1.0):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return torch.from_numpy(x).to(BF16)


def f64(t):
    return t.float().numpy().astype(np.float64)


def emulate_parts(u, q, i, order):
    parts = [u, q, i]
    if order >= 2:
        parts += [rb(u * q), rb(q * i), rb(i * u)]
    if order >= 3:
        parts.append(rb(parts[3] * i))
    return parts


def emulate_fwd(u, q, i, w, b, order):
    d = u.shape[1]
    wr = rb(w)
    out = sum(p @ wr[j * d:(j + 1) * d]
              for j, p in enumerate(emulate_parts(u, q, i, order)))
    return rb(out + b)


def emulate_bwd(u, q, i, w, cot, order):
    d = u.shape[1]
    parts = emulate_parts(u, q, i, order)
    wr = rb(w)
    dp = [cot @ wr[j * d:(j + 1) * d].T for j in range(len(parts))]
    du, dq, di = dp[0], dp[1], dp[2]
    if order >= 2:
        du = du + dp[3] * q + dp[5] * i
        dq = dq + dp[3] * u + dp[4] * i
        di = di + dp[4] * q + dp[5] * u
    if order >= 3:
        du = du + dp[6] * (q * i)
        dq = dq + dp[6] * (u * i)
        di = di + dp[6] * (u * q)
    dw = np.concatenate([p.T @ cot for p in parts])
    return [rb(du), rb(dq), rb(di)], dw, cot.sum(0)


def _csr(rng, segments, rows, entries):
    ids = np.sort(rng.integers(0, segments, entries))
    col = rng.integers(0, rows, entries)
    rowptr = np.zeros(segments + 1, np.int64)
    np.cumsum(np.bincount(ids, minlength=segments), out=rowptr[1:])
    return ids, col.astype(np.int32), rowptr.astype(np.int32)


def _i32(a):
    return torch.from_numpy(np.asarray(a, np.int32))


# ---------------------------------------------------------------------------
# the twins against the float64 emulation of the contract
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("x_bf16", [False, True])
def test_gather_roles_bf16_twin_is_the_rounded_copy(x_bf16):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((50, 16)).astype(np.float32)
    i3 = rng.integers(0, 50, (80, 3)).astype(np.int32)
    xt = torch.from_numpy(x)
    if x_bf16:
        xt = xt.to(BF16)
    got = gather_roles(xt, _i32(i3), BF16)
    assert got.dtype == BF16 and got.shape == (3, 80, 16)
    for r in range(3):
        np.testing.assert_array_equal(f64(got[r]), rb(x.astype(np.float64)
                                                      [i3[:, r]]))
    assert torch.equal(got, gather_roles_plain(xt, _i32(i3), BF16))


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("e,d,out", [(37, 8, 8), (100, 16, 32),
                                     (64, 24, 16)])
def test_interact_fwd_bf16_twin_matches_f64_contract(order, e, d, out):
    rng = np.random.default_rng(order * 100 + d)
    u, q, i = (bf16_tensor(rng, e, d) for _ in range(3))
    w = torch.from_numpy(rng.standard_normal(
        (ORDER_PARTS[order] * d, out)).astype(np.float32)) / d
    b = torch.from_numpy(rng.standard_normal(out).astype(np.float32))
    got = interact_fwd(u, q, i, w, b, order)
    assert got.dtype == BF16 and got.shape == (e, out)
    assert_bf16_close(got, emulate_fwd(f64(u), f64(q), f64(i),
                                       w.double().numpy(),
                                       b.double().numpy(), order))


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("e,d,out", [(37, 8, 8), (100, 16, 32)])
def test_interact_bwd_bf16_twin_matches_f64_contract(order, e, d, out):
    rng = np.random.default_rng(order * 10 + e)
    u, q, i = (bf16_tensor(rng, e, d) for _ in range(3))
    cot = bf16_tensor(rng, e, out)
    w = torch.from_numpy(rng.standard_normal(
        (ORDER_PARTS[order] * d, out)).astype(np.float32)) / d
    droles, dw, db = interact_bwd(u, q, i, w, cot, order)
    assert droles.dtype == BF16 and droles.shape == (3, e, d)
    assert dw.dtype == db.dtype == torch.float32
    want_roles, want_dw, want_db = emulate_bwd(
        f64(u), f64(q), f64(i), w.double().numpy(), f64(cot), order)
    for r, name in enumerate("uqi"):
        assert_bf16_close(droles[r], want_roles[r], "d" + name)
    assert_f32_close(dw, want_dw, "dw")
    assert_f32_close(db, want_db, "db")


@pytest.mark.parametrize("segments,rows,entries", [(70, 40, 500),
                                                   (1, 5, 1), (30, 90, 0)])
def test_segsum_bf16_twin_matches_f64(segments, rows, entries):
    """K1's vector form on bf16 rows: f32 sums; rounded once to bf16 with
    ``out_dtype``."""
    rng = np.random.default_rng(segments + entries)
    _, col, rowptr = _csr(rng, segments, rows, entries)
    x = bf16_tensor(rng, rows, 16)
    want = np.zeros((segments, 16))
    np.add.at(want, np.repeat(np.arange(segments), np.diff(rowptr)),
              f64(x)[col])
    got = csr_gather_sum(x, _i32(col), _i32(rowptr))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * max(np.abs(want).max(), 1.0))
    got16 = csr_gather_sum(x, _i32(col), _i32(rowptr), out_dtype=BF16)
    assert got16.dtype == BF16
    assert_bf16_close(got16, rb(want))


def test_segsum_bf16_fixed_width_twin_matches_f64():
    """The scatter's backward: the node cotangent rounded to bf16, each
    edge's three rows summed in f32 and rounded once."""
    rng = np.random.default_rng(7)
    cot = rng.standard_normal((60, 16)).astype(np.float32)
    i3 = rng.integers(0, 60, (90, 3)).astype(np.int32)
    rowptr = np.arange(0, 3 * 90 + 1, 3, dtype=np.int32)
    got = csr_gather_sum(torch.from_numpy(cot).to(BF16), _i32(i3.reshape(-1)),
                         _i32(rowptr), width=3, out_dtype=BF16)
    c = rb(cot.astype(np.float64))
    assert_bf16_close(got, rb(c[i3[:, 0]] + c[i3[:, 1]] + c[i3[:, 2]]))


def test_bf16_twins_refuse_what_no_form_takes():
    x = torch.zeros(4, 8, dtype=BF16)
    col, rowptr = _i32([0, 1]), _i32([0, 2])
    with pytest.raises(ValueError, match="out_dtype"):
        csr_gather_sum(x, col, rowptr, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="f32 or bf16"):
        gather_roles(torch.zeros(4, 8), _i32([[0, 1, 2]]), torch.float16)


# ---------------------------------------------------------------------------
# the twins against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------


def _pallas_inputs(order, out, seed):
    e = pallas_interact.BLK
    rng = np.random.default_rng(seed)
    u, q, i = (bf16_tensor(rng, e, 8) for _ in range(3))
    w = rng.standard_normal((ORDER_PARTS[order] * 8, out)).astype(
        np.float32) / 8
    return e, rng, u, q, i, w


def _jt(t):
    """A bf16 tensor as a feature-major JAX bf16 array."""
    return jnp.asarray(t.float().numpy().T).astype(jnp.bfloat16)


@pytest.mark.parametrize("order", [1, 2, 3])
def test_interact_fwd_bf16_matches_pallas_kernel(order):
    e, rng, u, q, i, w = _pallas_inputs(order, 8, 30 + order)
    b = rng.standard_normal(8).astype(np.float32)
    ref = pallas_interact.interact_fwd(
        _jt(u), _jt(q), _jt(i), jnp.asarray(w), jnp.asarray(b[:, None]),
        order, interpret=True)
    assert ref.dtype == jnp.bfloat16
    got = interact_fwd(u, q, i, torch.from_numpy(w), torch.from_numpy(b),
                       order)
    assert_bf16_close(got, np.asarray(ref.astype(jnp.float32)).T)


@pytest.mark.parametrize("order", [1, 3])
def test_interact_bwd_bf16_matches_pallas_kernel(order):
    e, rng, u, q, i, w = _pallas_inputs(order, 8, 40 + order)
    cot = bf16_tensor(rng, e, 8)
    du, dq, di, dw, db = pallas_interact.interact_bwd(
        _jt(u), _jt(q), _jt(i), jnp.asarray(w), _jt(cot), order,
        interpret=True)
    droles, tdw, tdb = interact_bwd(u, q, i, torch.from_numpy(w), cot, order)
    for r, ref in enumerate((du, dq, di)):
        assert ref.dtype == jnp.bfloat16
        assert_bf16_close(droles[r], np.asarray(ref.astype(jnp.float32)).T)
    assert_f32_close(tdw, np.asarray(dw))
    assert_f32_close(tdb, np.asarray(db)[:, 0])


def test_segsum_bf16_matches_pallas_kernel():
    """K1's bf16 vector form against ``csr_segment_sum_t`` on bf16 values
    (f32 accumulation, ``segsum.py:211-215``)."""
    rng = np.random.default_rng(9)
    ids, col, rowptr = _csr(rng, 300, 200, 2048)
    x = bf16_tensor(rng, 200, 32)
    vals = jnp.asarray(x.float().numpy()[col]).astype(jnp.bfloat16)
    v, ids2d, ptr = prepare_segment_inputs(vals, ids, 300)
    ref = np.asarray(csr_segment_sum(v, ids2d, ptr, 300, interpret=True))
    got = csr_gather_sum(x, _i32(col), _i32(rowptr))
    assert_f32_close(got, ref)


@pytest.fixture(scope="module")
def graphs():
    data = make_synthetic_data(user_count=6, query_count=5, item_count=9,
                               vocab_size=12, log_count=60, seed=3)
    return data.hypergraph, tgraph.build_hypergraph(
        data.pos_uqif, data.node_count, data.user_count, data.query_count)


def _edge_pos(kp):
    """σ position of each edge id in a Pallas pack's edge stream."""
    if not kp.sigma:
        return np.arange(kp.e_pad)
    from ihgnn_tpu.ops.pallas.permute import unpack_stage_perm
    p2q = np.asarray(unpack_stage_perm(kp.sig_stage))
    return (np.arange(kp.rows)[:, None] * kp.cols + p2q).reshape(-1)


def test_scatter_bf16_backward_against_pallas(graphs):
    """The departure of the scatter's backward (ROADMAP §3): the port
    rounds the f32 sum of an edge's three bf16 node-cotangent rows once;
    the Pallas path (``hyperagg.py:463-476``) adds the three bf16
    expansions in bf16, two roundings. On this graph they differ in about
    a quarter of the elements, each by at most one bf16 ulp of |c_u| +
    |c_q| + |c_i| (the magnitudes of the three rounded rows), which is up
    to 0.7% of the gradient's largest value where the three cancel."""
    jg, tg = graphs
    kp = jg.kp
    rng = np.random.default_rng(12)
    ef = rng.standard_normal((kp.e_pad, 8)).astype(np.float32)
    cot = rng.standard_normal((jg.node_count, 8)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = jax.grad(lambda e_t: jnp.sum(_scatter_pallas(
            e_t, kp) * jnp.asarray(cot.T)))(jnp.asarray(ef.T).astype(
                jnp.bfloat16))
    assert ref.dtype == jnp.bfloat16
    ref = np.asarray(ref.astype(jnp.float32)).T[_edge_pos(kp)[:kp.e]]
    edge = torch.from_numpy(ef[_edge_pos(kp)[:kp.e]]).to(
        BF16).requires_grad_()
    _, scatter = torch_hyper_ops(tg, bf16_stream=True)
    (scatter(edge) * torch.from_numpy(cot)).sum().backward()
    assert edge.grad.dtype == BF16
    c = rb(cot.astype(np.float64))
    i3 = tg.i3.numpy()
    magnitude = sum(np.abs(c[i3[:, r]]) for r in range(3))
    diff = np.abs(f64(edge.grad) - ref)
    assert (diff <= ulp(magnitude)).all()
    assert 0.0 < (diff > 0).mean() < 0.5
    assert diff.max() <= 1e-2 * np.abs(ref).max()


def test_hyper_ops_bf16_match_f64(graphs):
    """The direct path's (gather, scatter) pair on bf16 streams, forward
    and backward, against the emulation: bf16 roles, f32 node sums, an f32
    ``x`` gradient and a bf16 edge gradient."""
    _, tg = graphs
    rng = np.random.default_rng(13)
    n, e = tg.node_count, tg.edge_count
    x = torch.from_numpy(rng.standard_normal((n, 8)).astype(
        np.float32)).requires_grad_()
    croles = bf16_tensor(rng, 3, e, 8)
    gather, scatter = torch_hyper_ops(tg, bf16_stream=True)
    roles = gather(x)
    assert roles.dtype == BF16
    (roles.float() * croles.float()).sum().backward()
    i3 = tg.i3.numpy()
    want = np.zeros((n, 8))
    for r in range(3):
        np.add.at(want, i3[:, r], f64(croles[r]))
    assert x.grad.dtype == torch.float32
    assert_f32_close(x.grad, want)
    edge = bf16_tensor(rng, e, 8).requires_grad_()
    out = scatter(edge)
    assert out.dtype == torch.float32
    want = np.zeros((n, 8))
    for r in range(3):
        np.add.at(want, i3[:, r], f64(edge.detach()))
    assert_f32_close(out, want)


# ---------------------------------------------------------------------------
# the layer and the model against the JAX XLA bf16 path
# ---------------------------------------------------------------------------


def _synth(seed):
    rng = np.random.default_rng(seed)
    uqif = np.stack([rng.integers(0, U, P), rng.integers(0, Q, P),
                     rng.integers(0, I, P), np.ones(P, np.int64)], axis=1)
    qw = np.zeros((Q, LW), np.int32)
    qc = rng.integers(1, LW + 1, Q).astype(np.int32)
    for q in range(Q):
        qw[q, :qc[q]] = rng.integers(1, VOCAB + 1, qc[q])
    return uqif, qw, qc


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _np(t):
    return t.detach().float().numpy()


def _scale_close(got, want, tol, name=""):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max(), err_msg=name)


def _batches(uqif, steps, seed):
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


def _jax_batch(b):
    return Batch(**{f.name: getattr(b, f.name)
                    for f in dataclasses.fields(TBatch)})


def _tensors(batch):
    return [torch.from_numpy(getattr(batch, f.name))
            for f in dataclasses.fields(TBatch)]


def grad_scale(name, grads):
    """The largest value of gradient ``name``, or for an attention score
    head the largest gradient of its layer (``tests/test_torch_layers.py``
    says why)."""
    if ".feature_aggregate." in name:
        layer = name.split(".")[:2]
        return max(g.abs().max().item() for k, g in grads.items()
                   if k.split(".")[:2] == layer)
    return max(grads[name].abs().max().item(), 1e-30)


@pytest.mark.parametrize("case", list(CASES))
def test_layer_bf16_matches_jax_xla(case):
    """``IHGNNLayer(bf16_stream=True)``'s forward and its gradients of x
    and of every parameter, with carried-over weights."""
    kw = CASES[case]
    uqif, _, _ = _synth(4)
    jg = jgraph.build_hypergraph(uqif, N, U, Q, pack_kernels=False)
    tg = tgraph.build_hypergraph(uqif, N, U, Q)
    theirs = jlayers.IHGNNLayer(D, D, interaction_order=3, bf16_stream=True,
                                **kw)
    ours = tlayers.IHGNNLayer(D, D, interaction_order=3, bf16_stream=True,
                              **kw)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((N, D)).astype(np.float32)
    cot = rng.standard_normal((N, D)).astype(np.float32)
    params = theirs.init(jax.random.key(1), jnp.asarray(x.T), jg)
    ours.load_state_dict(layer_params_from_jax(_numpy_tree(params)["params"]),
                         strict=True)

    def f(p, x_t):
        y = theirs.apply(p, x_t, jg)
        return jnp.sum(y * jnp.asarray(cot.T)), y
    (_, ref), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x.T))
    xt = torch.from_numpy(x).requires_grad_()
    got = ours(xt, tg)
    assert got.dtype == torch.float32
    tol = XLA_TOL[case]
    _scale_close(_np(got), np.asarray(ref).T, tol, "forward")
    (got * torch.from_numpy(cot)).sum().backward()
    _scale_close(_np(xt.grad), np.asarray(gx).T, tol, "x")
    want = layer_params_from_jax(_numpy_tree(gp)["params"])
    # the score head's gradients against the layer's largest (grad_scale)
    layer_max = max(g.abs().max().item() for g in want.values())
    for name, p in ours.named_parameters():
        scale = layer_max if ".feature_aggregate." in f".{name}" else \
            want[name].abs().max().item()
        np.testing.assert_allclose(_np(p.grad), want[name].numpy(), rtol=0,
                                   atol=tol * scale, err_msg=name)


def _rawgnn_pair(case, seed, **cfg_kw):
    kw = dict(CASES[case], **cfg_kw)
    uqif, qw, qc = _synth(seed)
    jg = jgraph.build_hypergraph(uqif, N, U, Q, pack_kernels=False)
    tg = tgraph.build_hypergraph(uqif, N, U, Q)
    model = RawGnn(ModelConfig(embedding_size=D, **kw), U, Q, I, VOCAB)
    z = jnp.zeros((1,), jnp.int32)
    params = model.init(jax.random.key(seed), jg, jnp.asarray(qw),
                        jnp.asarray(qc), z, z, z)
    ours = TRawGnn(tcfg.ModelConfig(embedding_size=D, **kw), U, Q, I, VOCAB)
    ours.load_state_dict(params_from_jax(_numpy_tree(params)), strict=True)
    return model, params, jg, tg, ours, uqif, qw, qc


def _step0(model, params, jg, tg, ours, uqif, qw, qc):
    """(JAX features, loss, gradients; the port's features, loss,
    gradients) of one batch."""
    jqw, jqc = jnp.asarray(qw), jnp.asarray(qc)
    feats = model.apply(params, jg, jqw, jqc, method=RawGnn.all_features)
    batch = _batches(uqif, 1, 13)[0]
    jb = _jax_batch(batch)

    def loss_fn(p):
        logits = model.apply(p, jg, jqw, jqc, jb.users, jb.queries, jb.items)
        return bce_with_logits(logits, jb.flags, jb.weight)
    loss, grads = jax.value_and_grad(loss_fn)(params)
    bag = make_word_bag(qw, qc, VOCAB + 1)
    with torch.no_grad():
        got = ours.all_features(tg, bag)
    t = _tensors(batch)
    got_loss = ttrain.bce_with_logits(ours(tg, bag, *t[:3]), t[3], t[4])
    got_loss.backward()
    return (np.asarray(feats).T, float(loss),
            params_from_jax(_numpy_tree(grads)), got, got_loss.item(),
            {k: p.grad for k, p in ours.named_parameters()})


@pytest.mark.parametrize("case", list(CASES))
def test_rawgnn_bf16_features_and_grads_match_jax_xla(case):
    feats, loss, want, got, got_loss, grads = _step0(
        *_rawgnn_pair(case, 12, bf16_stream=True))
    _scale_close(_np(got), feats, XLA_TOL[case], "features")
    assert got_loss == pytest.approx(loss, rel=XLA_LOSS_RTOL)
    assert set(grads) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(_np(grads[name]), g.numpy(), rtol=0,
                                   atol=XLA_TOL[case] * grad_scale(name, want),
                                   err_msg=name)


def _train_losses(model, params, jg, tg, ours, uqif, qw, qc, case,
                  **cfg_kw):
    cfg = Config(model=ModelConfig(embedding_size=D, **CASES[case],
                                   **cfg_kw),
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
    return losses, tlosses


@pytest.mark.parametrize("case", list(CASES))
def test_rawgnn_bf16_train_steps_match_jax_xla(case):
    """STEPS steps of both train steps on bf16 streams from the same
    weights and batches."""
    pair = _rawgnn_pair(case, 14, bf16_stream=True)
    losses, tlosses = _train_losses(*pair, case, bf16_stream=True)
    np.testing.assert_allclose(tlosses, losses, rtol=XLA_STEPS_RTOL)
    assert len(set(tlosses)) == STEPS


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case,bf16", [("default", False),
                                       ("default", True),
                                       ("phase2", False), ("phase2", True)])
def test_remat_is_bit_for_bit(case, bf16):
    """Two train steps with ``remat`` against the same steps without it:
    the losses, every gradient and every parameter equal bit for bit."""
    uqif, qw, qc = _synth(16)
    tg = tgraph.build_hypergraph(uqif, N, U, Q)
    runs = []
    for remat in (False, True):
        cfg = tcfg.ModelConfig(embedding_size=D, bf16_stream=bf16,
                               remat=remat, **CASES[case])
        model = TRawGnn(cfg, U, Q, I, VOCAB,
                        generator=torch.Generator().manual_seed(3))
        opt = ttrain.make_optimizer(model.parameters(), tcfg.TrainConfig())
        step = ttrain.make_train_step(model, tg, qw, qc, opt, device="cpu")
        losses = [step(b).item() for b in _batches(uqif, 2, 17)]
        runs.append((losses, {k: p.grad.clone() for k, p in
                              model.named_parameters()},
                     {k: v.clone() for k, v in model.state_dict().items()}))
    (l0, g0, p0), (l1, g1, p1) = runs
    assert l0 == l1
    assert all(torch.equal(g0[k], g1[k]) for k in g0)
    assert all(torch.equal(p0[k], p1[k]) for k in p0)


def test_remat_recomputes_each_layer(monkeypatch):
    """With remat and grad on, each layer's forward runs twice a step (once
    more in the backward); under no_grad once."""
    uqif, qw, qc = _synth(18)
    tg = tgraph.build_hypergraph(uqif, N, U, Q)
    model = TRawGnn(tcfg.ModelConfig(embedding_size=D, remat=True), U, Q, I,
                    VOCAB)
    calls = []
    forward = tlayers.IHGNNLayer.forward

    def counted(self, x, graph):
        calls.append(self)
        return forward(self, x, graph)
    monkeypatch.setattr(tlayers.IHGNNLayer, "forward", counted)
    bag = make_word_bag(qw, qc, VOCAB + 1)
    with torch.no_grad():
        model.all_features(tg, bag)
    assert len(calls) == 2
    t = _tensors(_batches(uqif, 1, 19)[0])
    ttrain.bce_with_logits(model(tg, bag, *t[:3]), t[3], t[4]).backward()
    assert len(calls) == 2 + 2 * 2


@pytest.mark.parametrize("case", list(CASES))
def test_remat_matches_jax_remat(case):
    """The port's ``remat=True`` against JAX's ``remat=True`` (f32): the
    features, the step-0 loss and every gradient within 1e-5."""
    feats, loss, want, got, got_loss, grads = _step0(
        *_rawgnn_pair(case, 20, remat=True))
    np.testing.assert_allclose(_np(got), feats, rtol=1e-5, atol=1e-5)
    assert got_loss == pytest.approx(loss, rel=1e-5)
    for name, g in want.items():
        np.testing.assert_allclose(_np(grads[name]), g.numpy(), rtol=0,
                                   atol=1e-5 * grad_scale(name, want),
                                   err_msg=name)


def test_interact_fn_bf16_gradients_are_bf16():
    """``InteractFn`` on bf16 roles: a bf16 output, bf16 role gradients and
    f32 parameter gradients, equal to the twins'."""
    rng = np.random.default_rng(21)
    roles = bf16_tensor(rng, 3, 40, 8).requires_grad_()
    w = torch.from_numpy(rng.standard_normal((56, 8)).astype(
        np.float32)).requires_grad_()
    b = torch.zeros(8, requires_grad=True)
    out = InteractFn.apply(roles, w, b, 3)
    assert out.dtype == BF16
    cot = bf16_tensor(rng, 40, 8)
    out.backward(cot)
    droles, dw, db = interact_bwd_plain(*roles.detach(), w.detach(), cot, 3)
    assert roles.grad.dtype == BF16 and torch.equal(roles.grad, droles)
    assert torch.equal(w.grad, dw) and torch.equal(b.grad, db)
    assert torch.equal(out.detach(), interact_fwd_plain(
        *roles.detach(), w.detach(), b.detach(), 3))
    x = torch.zeros(5, 8, requires_grad=True)
    GatherRolesFn.apply(x, _i32([[0, 1, 2]]), _i32([0, 1, 2]),
                        _i32([0, 1, 2, 3, 3, 3]), BF16).float().sum().backward()
    assert x.grad.dtype == torch.float32
    e = torch.zeros(1, 8, dtype=BF16, requires_grad=True)
    SpmmFn.apply(e, _i32([0, 0, 0]), _i32([0, 1, 2, 3, 3, 3]), None,
                 _i32([0, 1, 2]), _i32([0, 3]), None, 3).sum().backward()
    assert e.grad.dtype == BF16
    assert torch.equal(e.grad, torch.full((1, 8), 3.0, dtype=BF16))
