"""The port's training path against the JAX package on the CPU: the
backward of every kernel module, the word-bag and hypergraph autograd
Functions, the train step with Adam and grad accumulation, the LR decay,
and the data layer that feeds it (``GraphData``, ``TrainSampler``).

Inputs come from numpy seeds and weights are carried over with
``ihgnn_torch.convert.params_from_jax``. The port's wrappers run their
plain twins on CPU tensors; each autograd Function's backward runs the
plain twin of its backward sum over the index arrays the CUDA kernels use
(``inc_slot``, ``edge_rowptr``, the word-major bag transpose). The JAX
side runs its XLA path (kernel packs stripped), except where a test names
the Pallas kernel in interpret mode.

Tolerances:
* against the f32 XLA path: 1e-5 (f32 sums in another order);
* against the Pallas ``interact_bwd`` in interpret mode: 2e-2 of the
  largest output, because that kernel rounds its MXU operands to bf16;
* parameters after several Adam steps: rtol 1e-4, atol 1e-5. Adam divides
  each gradient by its running RMS, so an element whose gradient is tiny
  moves by about lr whatever its size, and rounding in the gradient shows
  in the parameter at lr scale rather than at gradient scale.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ihgnn_torch import config as tcfg
from ihgnn_torch.convert import params_from_jax
from ihgnn_torch.data.collections import SearchLogCollection as TLogs
from ihgnn_torch.data.dataset import Batch as TBatch
from ihgnn_torch.data.dataset import GraphData as TGraphData
from ihgnn_torch.data.dataset import TrainSampler as TTrainSampler
from ihgnn_torch.data.dataset import prefetch as tprefetch
from ihgnn_torch.data.schema import PosInteraction as TPosInteraction
from ihgnn_torch.data.schema import SearchLog as TSearchLog
from ihgnn_torch.graph import build_hypergraph
from ihgnn_torch.models.rawgnn import RawGnn as TRawGnn
from ihgnn_torch.ops.bag import BagMeanFn, make_word_bag
from ihgnn_torch.ops.gather import gather_roles
from ihgnn_torch.ops.hyperagg import (GatherRolesFn, SpmmFn,
                                      make_hyper_ops as torch_hyper_ops)
from ihgnn_torch.ops.interact import (ORDER_PARTS, InteractFn, interact_bwd,
                                      interact_bwd_plain, interact_fwd)
from ihgnn_torch.ops.segsum import csr_gather_sum
from ihgnn_torch.train import train as ttrain
from ihgnn_tpu.config import Config, ModelConfig, TrainConfig, V
from ihgnn_tpu.data.artifacts import write_synthetic_dataset
from ihgnn_tpu.data.dataset import GraphData, TrainSampler
from ihgnn_tpu.data.schema import PosInteraction
from ihgnn_tpu.data.synthetic import make_synthetic_data
from ihgnn_tpu.models.embedding import EmbeddingTables
from ihgnn_tpu.models.interaction import FeatureInteractor
from ihgnn_tpu.models.rawgnn import RawGnn
from ihgnn_tpu.ops.hyperagg import make_hyper_ops, strip_kernel_packing
from ihgnn_tpu.ops.pallas import interact as pallas_interact
from ihgnn_tpu.train.train import (bce_with_logits, init_state,
                                   make_optimizer, make_train_step)

D = 8
TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def data():
    return make_synthetic_data(user_count=20, query_count=12, item_count=30,
                               vocab_size=25, log_count=150, seed=0)


@pytest.fixture(scope="module")
def graphs(data):
    """(JAX HyperGraph without kernel packs, the port's HyperGraph)."""
    return strip_kernel_packing(data.hypergraph), build_hypergraph(
        data.pos_uqif, data.node_count, data.user_count, data.query_count)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _roles(e, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((e, d)).astype(np.float32) for _ in range(3)]


def _five(bwd):
    """``interact_bwd``'s ``(droles, dw, db)`` as (du, dq, di, dw, db)."""
    droles, dw, db = bwd
    return (*droles, dw, db)


def _port_logs(logs):
    return TLogs(TSearchLog.parse(log.tostr()) for log in logs)


def _port_batch(b):
    return TBatch(*(np.asarray(getattr(b, f.name))
                    for f in dataclasses.fields(TBatch)))


def _assert_batches_equal(a, b):
    for f in dataclasses.fields(TBatch):
        x, y = getattr(a, f.name), np.asarray(getattr(b, f.name))
        assert x.dtype == y.dtype, f.name
        np.testing.assert_array_equal(x, y, err_msg=f.name)


# ---------------------------------------------------------------------------
# K3 interact_bwd
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("order", [1, 2, 3])
def test_interact_bwd_matches_pallas_kernel(order):
    e, out = 2 * pallas_interact.BLK, 8
    u, q, i = _roles(e, D, 30 + order)
    rng = np.random.default_rng(40 + order)
    w = rng.standard_normal((ORDER_PARTS[order] * D, out)).astype(np.float32)
    cot = rng.standard_normal((e, out)).astype(np.float32)
    ref = pallas_interact.interact_bwd(
        jnp.asarray(u.T), jnp.asarray(q.T), jnp.asarray(i.T), jnp.asarray(w),
        jnp.asarray(cot.T), order, interpret=True)
    ref = [np.asarray(r) for r in ref]
    ref = [ref[0].T, ref[1].T, ref[2].T, ref[3], ref[4][:, 0]]
    got = _five(interact_bwd_plain(
        *(torch.from_numpy(a) for a in (u, q, i, w, cot)), order))
    for name, g, r in zip(("du", "dq", "di", "dw", "db"), got, ref):
        scale = np.abs(r).max()
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=2e-2 * scale,
                                   err_msg=name)


@pytest.mark.parametrize("order,e,out", [(1, 37, 8), (2, 64, 16),
                                         (3, 100, 8), (3, 5, 4), (3, 1, 8)])
def test_interact_bwd_matches_jax_grad(order, e, out):
    """Against ``jax.vjp`` of the f32 XLA ``FeatureInteractor``, on ragged
    edge counts."""
    u, q, i = _roles(e, D, 50 + order)
    cot = np.random.default_rng(e).standard_normal((e, out)).astype(np.float32)
    roles_t = tuple(jnp.asarray(a.T) for a in (u, q, i))
    mod = FeatureInteractor(order, D, out)
    params = mod.init(jax.random.key(order), roles_t, fused_ok=False)
    _, vjp = jax.vjp(lambda p, r: mod.apply(p, r, fused_ok=False), params,
                     roles_t)
    dparams, droles = vjp(jnp.asarray(cot.T))
    dense = dparams["params"]["aggregation"]["dense"]
    w = np.array(params["params"]["aggregation"]["dense"]["kernel"])
    got = _five(interact_bwd(*(torch.from_numpy(a) for a in (u, q, i, w, cot)),
                             order))
    want = [np.asarray(r).T for r in droles] + [np.asarray(dense["kernel"]),
                                                np.asarray(dense["bias"])]
    for name, g, r in zip(("du", "dq", "di", "dw", "db"), got, want):
        np.testing.assert_allclose(g.numpy(), r, err_msg=name, **TOL)


def test_interact_bwd_writes_one_role_buffer():
    u, q, i = (torch.from_numpy(a) for a in _roles(33, D, 1))
    w, cot = torch.randn(7 * D, 16), torch.randn(33, 16)
    droles, dw, db = interact_bwd(u, q, i, w, cot, 3)
    assert droles.shape == (3, 33, D) and droles.is_contiguous()
    assert dw.shape == (7 * D, 16) and db.shape == (16,)


def test_interact_fn_gradients_are_interact_bwd():
    roles = torch.from_numpy(np.stack(_roles(21, D, 2))).requires_grad_()
    w = torch.randn(6 * D, 8, requires_grad=True)
    b = torch.randn(8, requires_grad=True)
    cot = torch.randn(21, 8)
    out = InteractFn.apply(roles, w, b, 2)
    torch.testing.assert_close(out, interact_fwd(*roles, w, b, 2))
    out.backward(cot)
    want = interact_bwd_plain(*roles.detach(), w.detach(), cot, 2)
    for t, g in zip((roles, w, b), want):
        assert torch.equal(t.grad, g)


def test_gather_roles_fn_takes_a_strided_cotangent(graphs):
    """A role cotangent that reaches the gather's backward as a strided
    view gives the same gradient as its contiguous copy."""
    _, tg = graphs
    x = torch.randn(tg.node_count, D)
    cot = torch.randn(3, D, tg.edge_count).transpose(1, 2)
    assert not cot.is_contiguous()
    grads = []
    for c in (cot, cot.contiguous()):
        xt = x.clone().requires_grad_()
        GatherRolesFn.apply(xt, tg.i3, tg.inc_slot, tg.rowptr).backward(c)
        grads.append(xt.grad)
    assert torch.equal(grads[0], grads[1])


# ---------------------------------------------------------------------------
# hypergraph and word-bag autograd
# ---------------------------------------------------------------------------


def test_backward_index_arrays(graphs):
    _, tg = graphs
    e = tg.edge_count
    i3 = tg.i3.numpy()
    slot = tg.inc_slot.numpy()
    # entry k of node n reads row role·E + edge, and that edge's role is n
    np.testing.assert_array_equal(slot % e, tg.inc_edge.numpy())
    np.testing.assert_array_equal(i3[slot % e, slot // e],
                                  tg.inc_node.numpy())
    np.testing.assert_array_equal(tg.edge_rowptr.numpy(),
                                  np.arange(0, 3 * e + 1, 3))


def test_gather_roles_fn_grad_matches_jax(graphs):
    jg, tg = graphs
    rng = np.random.default_rng(3)
    x = rng.standard_normal((jg.node_count, D)).astype(np.float32)
    cots = [rng.standard_normal((jg.edge_count, D)).astype(np.float32)
            for _ in range(3)]
    gather_x, _ = make_hyper_ops(jg)

    def loss(x_t):
        return sum(jnp.sum(r * jnp.asarray(c.T))
                   for r, c in zip(gather_x(x_t), cots))
    ref = np.asarray(jax.grad(loss)(jnp.asarray(x.T))).T

    xt = torch.from_numpy(x).requires_grad_()
    roles = GatherRolesFn.apply(xt, tg.i3, tg.inc_slot, tg.rowptr)
    for a, b in zip(roles, gather_roles(xt.detach(), tg.i3)):
        assert torch.equal(a, b)
    sum((r * torch.from_numpy(c)).sum() for r, c in zip(roles, cots)).backward()
    np.testing.assert_allclose(xt.grad.numpy(), ref, **TOL)


def test_scatter_incidence_fn_grad_matches_jax(graphs):
    jg, tg = graphs
    rng = np.random.default_rng(4)
    edge = rng.standard_normal((jg.edge_count, D)).astype(np.float32)
    cot = rng.standard_normal((jg.node_count, D)).astype(np.float32)
    _, scatter_x = make_hyper_ops(jg)
    ref = np.asarray(jax.grad(lambda e_t: jnp.sum(
        scatter_x(e_t) * jnp.asarray(cot.T)))(jnp.asarray(edge.T))).T

    et = torch.from_numpy(edge).requires_grad_()
    out = SpmmFn.apply(et, tg.inc_edge, tg.rowptr, None, tg.i3.view(-1),
                       tg.edge_rowptr, None)
    torch.testing.assert_close(out, csr_gather_sum(
        et.detach(), tg.inc_edge, tg.rowptr))
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(et.grad.numpy(), ref, **TOL)


def test_hyper_ops_layer_grad_matches_jax(graphs):
    """gather → interaction → scatter / dv, as the layer composes them:
    the role cotangents reach the gather's backward as one buffer."""
    jg, tg = graphs
    rng = np.random.default_rng(6)
    x = rng.standard_normal((jg.node_count, D)).astype(np.float32)
    w = rng.standard_normal((7 * D, D)).astype(np.float32) / 8
    b = rng.standard_normal(D).astype(np.float32)
    cot = rng.standard_normal((jg.node_count, D)).astype(np.float32)
    gather_x, scatter_x = make_hyper_ops(jg)

    def f(x_t, w):
        u, q, i = gather_x(x_t)
        parts = [u, q, i, u * q, q * i, i * u, u * q * i]
        edge = sum(w[j * D:(j + 1) * D].T @ p for j, p in enumerate(parts))
        edge = edge + jnp.asarray(b)[:, None]
        return jnp.sum(scatter_x(edge) / jnp.asarray(jg.dv).T
                       * jnp.asarray(cot.T))
    gx, gw = jax.grad(f, argnums=(0, 1))(jnp.asarray(x.T), jnp.asarray(w))

    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    gather, scatter = torch_hyper_ops(tg)
    edge = InteractFn.apply(gather(xt), wt, torch.from_numpy(b), 3)
    (scatter(edge) / tg.dv * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx).T, **TOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw), **TOL)


def test_word_bag_transpose():
    qw = np.array([[3, 0, 5], [0, 0, 0], [5, 2, 3]], np.int32)
    qc = np.array([2, 0, 3], np.int32)
    bag = make_word_bag(qw, qc, vocab_rows=7)
    assert bag.vocab_rows == 7
    # vocab rows 0..6: entries of rows 2, 3, 5 only; queries ascending
    assert bag.t_rowptr.tolist() == [0, 0, 0, 1, 3, 3, 5, 5]
    assert bag.t_col.tolist() == [2, 0, 2, 0, 2]
    np.testing.assert_allclose(bag.t_weight.numpy(),
                               [1 / 3, 1 / 2, 1 / 3, 1 / 2, 1 / 3])
    with pytest.raises(ValueError):
        make_word_bag(qw, qc, vocab_rows=5)


@pytest.mark.parametrize("table_rows_extra", [0, 3])
def test_bag_mean_fn_grad_matches_jax(data, table_rows_extra):
    """The vocab gradient of the bag mean against ``jax.grad`` of the XLA
    ``embed_query``; rows of a longer table that no word reaches get zero
    gradient."""
    mod = EmbeddingTables(data.user_count, data.item_count, data.vocab_size,
                          D)
    qw, qc = jnp.asarray(data.query_words), jnp.asarray(data.query_word_counts)
    params = mod.init(jax.random.key(2), qw, qc,
                      method=EmbeddingTables.all_features_t)
    cot = np.random.default_rng(7).standard_normal(
        (data.query_count, D)).astype(np.float32)
    grads = jax.grad(lambda p: jnp.sum(mod.apply(
        p, qw, qc, method=EmbeddingTables.embed_query) * jnp.asarray(cot)))(
            params)
    ref = np.asarray(grads["params"]["vocab_table"]).T        # [V+1, d]

    rows = data.vocab_size + 1
    table = np.concatenate([
        np.asarray(params["params"]["vocab_table"]).T,
        np.zeros((table_rows_extra, D), np.float32)])
    tt = torch.from_numpy(table).requires_grad_()
    bag = make_word_bag(data.query_words, data.query_word_counts,
                        table.shape[0])
    out = BagMeanFn.apply(tt, bag)
    (out * torch.from_numpy(cot)).sum().backward()
    assert tt.grad.shape == table.shape
    np.testing.assert_allclose(tt.grad[:rows].numpy(), ref, **TOL)
    assert torch.equal(tt.grad[0], torch.zeros(D))
    assert torch.equal(tt.grad[rows:], torch.zeros(table_rows_extra, D))


def test_bag_mean_fn_refuses_a_short_table(data):
    bag = make_word_bag(data.query_words, data.query_word_counts,
                        data.vocab_size + 1)
    for rows in (data.vocab_size, data.vocab_size + 2):
        with pytest.raises(ValueError):
            BagMeanFn.apply(torch.zeros(rows, D), bag)


# ---------------------------------------------------------------------------
# loss, optimizer, LR decay
# ---------------------------------------------------------------------------


def test_bce_with_logits_matches_jax():
    rng = np.random.default_rng(8)
    logits = (rng.standard_normal(50) * 6).astype(np.float32)
    labels = (rng.random(50) < 0.3).astype(np.float32)
    weight = (rng.random(50) < 0.8).astype(np.float32)
    for w in (weight, np.zeros(50, np.float32)):
        ref = float(bce_with_logits(jnp.asarray(logits), jnp.asarray(labels),
                                    jnp.asarray(w)))
        got = ttrain.bce_with_logits(torch.from_numpy(logits),
                                     torch.from_numpy(labels),
                                     torch.from_numpy(w)).item()
        assert got == pytest.approx(ref, rel=1e-6, abs=1e-7)


@pytest.mark.parametrize("decay", [0.0, 0.05])
def test_adam_with_coupled_decay_matches_optax(decay):
    """``torch.optim.Adam(weight_decay=…)`` against the JAX package's chain
    (``add_decayed_weights`` then ``scale_by_adam``, scaled by -lr)."""
    lr = 3e-3
    rng = np.random.default_rng(9)
    p0 = rng.standard_normal((6, 5)).astype(np.float32)
    grads = [rng.standard_normal((6, 5)).astype(np.float32)
             for _ in range(5)]
    tx = make_optimizer(Config(train=TrainConfig(weight_decay=decay)))
    p = jnp.asarray(p0)
    state = tx.init(p)
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = ttrain.make_optimizer(
        [param], tcfg.TrainConfig(learning_rate=lr, weight_decay=decay))
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, p)
        p = optax.apply_updates(p, -lr * upd)
        param.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(param.detach().numpy(), np.asarray(p),
                               rtol=1e-5, atol=1e-7)


def test_adjust_lr_after_epoch():
    cfg = tcfg.TrainConfig(learning_rate=1e-3)
    opt = ttrain.make_optimizer([torch.nn.Parameter(torch.zeros(2))], cfg)
    assert not ttrain.adjust_lr_after_epoch(opt, 0.5, cfg)
    assert opt.param_groups[0]["lr"] == pytest.approx(1e-3)
    assert ttrain.adjust_lr_after_epoch(opt, 0.001, cfg)
    assert opt.param_groups[0]["lr"] == pytest.approx(1e-3 * 0.98)
    assert not ttrain.adjust_lr_after_epoch(opt, 0.001, cfg,
                                            is_rawgnn=False)
    off = dataclasses.replace(cfg, adjust_learning_rate=False)
    assert not ttrain.adjust_lr_after_epoch(opt, 0.001, off)
    # stops once lr is at the floor
    opt.param_groups[0]["lr"] = 4e-4
    assert not ttrain.adjust_lr_after_epoch(opt, 0.001, cfg)
    assert opt.param_groups[0]["lr"] == 4e-4


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def _models(data, jg, seed, **kw):
    """(JAX RawGnn, its params, the port's RawGnn with the same weights)."""
    model = RawGnn(ModelConfig(**kw), data.user_count, data.query_count,
                   data.item_count, data.vocab_size)
    qw, qc = jnp.asarray(data.query_words), jnp.asarray(data.query_word_counts)
    z = jnp.zeros((1,), jnp.int32)
    params = model.init(jax.random.key(seed), jg, qw, qc, z, z, z)
    ours = TRawGnn(tcfg.ModelConfig(**kw), data.user_count, data.query_count,
                   data.item_count, data.vocab_size)
    ours.load_state_dict(params_from_jax(_numpy_tree(params)), strict=True)
    return model, params, ours


def _jax_batches(data, n, seed, batch_size=16, rand_neg=4):
    it = TrainSampler(data, batch_size, rand_neg, seed=seed).epoch()
    return [next(it) for _ in range(n)]


VARIANTS = [
    # (order, query transform, cosine head)
    (3, V.MEAN, False),             # the default model
    (1, V.ACTIVATION, True),
]


@pytest.mark.parametrize("order,transform,cosine", VARIANTS)
def test_step0_loss_and_grads_match_jax(data, graphs, order, transform,
                                        cosine):
    """The loss ``make_graph_train_step`` takes (``model.apply`` then
    ``bce_with_logits``) and the gradient of every parameter."""
    jg, tg = graphs
    kw = dict(embedding_size=D, feature_interaction_order=order,
              query_transform=transform, use_cosine_similarity=cosine)
    model, params, ours = _models(data, jg, 11, **kw)
    batch = _jax_batches(data, 1, seed=3)[0]
    qw, qc = jnp.asarray(data.query_words), jnp.asarray(data.query_word_counts)

    def loss_fn(p):
        logits = model.apply(p, jg, qw, qc, batch.users, batch.queries,
                             batch.items)
        return bce_with_logits(logits, batch.flags, batch.weight)
    loss, grads = jax.value_and_grad(loss_fn)(params)
    want = params_from_jax(_numpy_tree(grads))

    opt = ttrain.make_optimizer(ours.parameters(), tcfg.TrainConfig())
    bag = make_word_bag(data.query_words, data.query_word_counts,
                        data.vocab_size + 1)
    b = _port_batch(batch)
    t = [torch.from_numpy(a) for a in (b.users, b.queries, b.items, b.flags,
                                       b.weight)]
    got = ttrain.bce_with_logits(ours(tg, bag, *t[:3]), t[3], t[4])
    opt.zero_grad()
    got.backward()
    assert got.item() == pytest.approx(float(loss), rel=1e-5)
    named = dict(ours.named_parameters())
    assert set(named) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(named[name].grad.numpy(), g.numpy(),
                                   err_msg=name, **TOL)


def _jax_state(model, params, data, jg, cfg):
    tx = make_optimizer(cfg)
    state = init_state(model, jax.random.key(0), jg, data.query_words,
                       data.query_word_counts, cfg, tx)
    return tx, dataclasses.replace(state, params=params,
                                   opt_state=tx.init(params))


def _assert_params_match(ours, params):
    want = params_from_jax(_numpy_tree(params))
    for name, p in ours.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   err_msg=name, **PARAM_TOL)


def test_train_steps_match_jax(data, graphs):
    """Seven steps of the port's train step against ``make_train_step`` on
    the same batches: losses within rtol 1e-5, parameters after them
    within PARAM_TOL."""
    jg, tg = graphs
    model, params, ours = _models(data, jg, 12, embedding_size=D)
    cfg = Config(model=ModelConfig(embedding_size=D),
                 train=TrainConfig(learning_rate=5e-3))
    tx, state = _jax_state(model, params, data, jg, cfg)
    step = make_train_step(model, jg, data.query_words,
                           data.query_word_counts, tx)
    opt = ttrain.make_optimizer(ours.parameters(), tcfg.TrainConfig(
        learning_rate=5e-3))
    tstep = ttrain.make_train_step(ours, tg, data.query_words,
                                   data.query_word_counts, opt, device="cpu")
    sampler = TTrainSampler(TGraphData(
        data.user_count, data.query_count, data.item_count, data.vocab_size,
        data.query_words, data.query_word_counts,
        _port_logs(data.search_logs)), 16, 4, seed=5)
    jsampler = TrainSampler(data, 16, 4, seed=5)
    losses, tlosses = [], []
    for batch, jbatch, _ in zip(sampler.epoch(), jsampler.epoch(), range(7)):
        _assert_batches_equal(batch, jbatch)
        state, loss = step(state, jbatch)
        losses.append(float(loss))
        tlosses.append(tstep(batch).item())
    assert len(tlosses) == 7
    np.testing.assert_allclose(tlosses, losses, rtol=1e-5)
    _assert_params_match(ours, state.params)


def test_grad_accum_matches_jax_and_summed_grads(data, graphs):
    """k = 2: the port's step against the JAX step with
    ``grad_accum_steps=2``, and against the two batches' gradients summed
    by hand and applied in one update."""
    jg, tg = graphs
    model, params, ours = _models(data, jg, 13, embedding_size=D)
    manual = copy.deepcopy(ours)
    cfg = Config(model=ModelConfig(embedding_size=D),
                 train=TrainConfig(learning_rate=5e-3))
    tx, state = _jax_state(model, params, data, jg, cfg)
    jbatches = _jax_batches(data, 2, seed=6)
    stepk = make_train_step(model, jg, data.query_words,
                            data.query_word_counts, tx, grad_accum_steps=2)
    state, loss_sum = stepk(state, jax.tree.map(lambda *xs: np.stack(xs),
                                                *jbatches))

    tcfg_train = tcfg.TrainConfig(learning_rate=5e-3)
    opt = ttrain.make_optimizer(ours.parameters(), tcfg_train)
    tstep = ttrain.make_train_step(ours, tg, data.query_words,
                                   data.query_word_counts, opt,
                                   grad_accum_steps=2, device="cpu")
    batches = [_port_batch(b) for b in jbatches]
    got = tstep(TBatch.stack(batches))
    assert got.item() == pytest.approx(float(loss_sum), rel=1e-5)
    _assert_params_match(ours, state.params)
    with pytest.raises(ValueError):
        tstep(batches[0])

    bag = make_word_bag(data.query_words, data.query_word_counts,
                        data.vocab_size + 1)
    mparams = list(manual.parameters())
    gsum = None
    for b in batches:
        t = [torch.from_numpy(a) for a in (b.users, b.queries, b.items,
                                           b.flags, b.weight)]
        loss = ttrain.bce_with_logits(manual(tg, bag, *t[:3]), t[3], t[4])
        g = torch.autograd.grad(loss, mparams)
        gsum = g if gsum is None else [a + c for a, c in zip(gsum, g)]
    mopt = ttrain.make_optimizer(mparams, tcfg_train)
    for p, g in zip(mparams, gsum):
        p.grad = g
    mopt.step()
    for (name, a), b in zip(ours.named_parameters(), mparams):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_train_step_on_cpu_launches_no_kernel(data, graphs):
    from ihgnn_torch.ops.gather import gather_roles as k2
    _, tg = graphs
    ours = TRawGnn(tcfg.ModelConfig(embedding_size=D), data.user_count,
                   data.query_count, data.item_count, data.vocab_size)
    opt = ttrain.make_optimizer(ours.parameters(), tcfg.TrainConfig())
    step = ttrain.make_train_step(ours, tg, data.query_words,
                                  data.query_word_counts, opt, device="cpu")
    wrappers = (csr_gather_sum, k2, interact_fwd, interact_bwd)
    before = [w.launches for w in wrappers]
    loss = step(_port_batch(_jax_batches(data, 1, seed=1)[0]))
    assert torch.isfinite(loss) and loss.dim() == 0
    assert [w.launches for w in wrappers] == before
    with pytest.raises(ValueError):       # the model is not on that device
        ttrain.make_train_step(ours, tg, data.query_words,
                               data.query_word_counts, opt,
                               device=torch.device("meta"))


# ---------------------------------------------------------------------------
# the data layer
# ---------------------------------------------------------------------------


def test_pos_interaction_matches_jax(data):
    for log in list(data.search_logs)[:30]:
        for flag_policy in (True, False):
            ours = TPosInteraction.from_search_log(
                TSearchLog.parse(log.tostr()), treat_all_1=flag_policy)
            theirs = PosInteraction.from_search_log(log,
                                                    treat_all_1=flag_policy)
            assert [tuple(p) for p in ours] == [tuple(p) for p in theirs]
            assert [p.uqif() for p in ours] == [p.uqif() for p in theirs]


def test_graph_data_from_files_matches_jax(tmp_path):
    write_synthetic_dataset(str(tmp_path), seed=11, user_count=25,
                            query_count=15, item_count=40, vocab_size=30,
                            log_count=300)
    theirs = GraphData.from_files(str(tmp_path))
    ours = TGraphData.from_files(str(tmp_path))
    for name in ("user_count", "query_count", "item_count", "vocab_size",
                 "node_count", "pos_count"):
        assert getattr(ours, name) == getattr(theirs, name), name
    np.testing.assert_array_equal(ours.pos_uqif, theirs.pos_uqif)
    np.testing.assert_array_equal(ours.query_words, theirs.query_words)
    np.testing.assert_array_equal(ours.query_word_counts,
                                  theirs.query_word_counts)
    assert ours.neg_items_for_uq == theirs.neg_items_for_uq
    jg, tg = theirs.hypergraph, ours.hypergraph
    np.testing.assert_array_equal(tg.i3.numpy(), np.asarray(jg.i3))
    np.testing.assert_array_equal(tg.inc_edge.numpy(),
                                  np.asarray(jg.inc_edge))
    assert ours.hypergraph is tg
    with pytest.raises(FileNotFoundError):
        TGraphData.from_files(str(tmp_path), split="nope")


@pytest.mark.parametrize("batch_size,rand_neg,nonrand_neg,shuffle,multiple", [
    (16, 4, 0, True, 1),      # the default sampler
    (16, 2, 2, True, 1),      # logged negatives with random top-up
    (23, 3, 0, False, 8),     # no shuffle; rows padded to a multiple of 8
])
def test_train_sampler_matches_jax(data, batch_size, rand_neg, nonrand_neg,
                                   shuffle, multiple):
    """Two epochs from one seed: identical batches, including the
    zero-weight tail of the last one."""
    ours = TTrainSampler(TGraphData(
        data.user_count, data.query_count, data.item_count, data.vocab_size,
        data.query_words, data.query_word_counts,
        _port_logs(data.search_logs)), batch_size, rand_neg, nonrand_neg,
        seed=4, shuffle=shuffle, row_multiple=multiple)
    theirs = TrainSampler(data, batch_size, rand_neg, nonrand_neg, seed=4,
                          shuffle=shuffle, row_multiple=multiple)
    assert ours.steps_per_epoch == theirs.steps_per_epoch
    for _ in range(2):
        a, b = list(ours.epoch()), list(theirs.epoch())
        assert len(a) == len(b) == ours.steps_per_epoch
        for x, y in zip(a, b):
            _assert_batches_equal(x, y)
        assert a[-1].weight.sum() < a[0].weight.sum()
        assert sum(x.weight[:batch_size].sum() for x in a) == data.pos_count


def test_batch_stack_and_prefetch():
    bs = [TBatch(*(np.full(6, k + j, np.float32) for j in range(5)))
          for k in range(3)]
    stacked = TBatch.stack(bs)
    assert stacked.users.shape == (3, 6)
    for a, b in zip(stacked.unstack(), bs):
        _assert_batches_equal(a, b)
    assert bs[0].unstack()[0] is bs[0]
    assert [b.users[0] for b in tprefetch(iter(bs))] == [0, 1, 2]

    def broken():
        yield bs[0]
        raise KeyError("producer")
    got = tprefetch(broken())
    assert next(got) is bs[0]
    with pytest.raises(KeyError):
        next(got)
