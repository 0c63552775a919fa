"""The port's model modules and the whole serving forward against the JAX
package's XLA path, with the same weights carried over by
``ihgnn_torch.convert.params_from_jax``.

Both sides run on the CPU in f32: the JAX graph has its kernel packs
stripped (the XLA oracle), and the port's wrappers run their plain twins
on CPU tensors. Layouts: the JAX package is feature-major ([F, N]); the
port is row-major ([N, F]), so features are transposed at the boundary.

Tolerance: rtol = atol = 1e-5 everywhere (f32 sums taken in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ihgnn_torch import config as tcfg
from ihgnn_torch.convert import params_from_jax
from ihgnn_torch.graph import build_hypergraph
from ihgnn_torch.models.embedding import EmbeddingTables as TEmbeddingTables
from ihgnn_torch.models.embedding import make_word_bag
from ihgnn_torch.models.interaction import \
    FeatureInteractor as TFeatureInteractor
from ihgnn_torch.models.layers import IHGNNLayer as TIHGNNLayer
from ihgnn_torch.models.rawgnn import RawGnn as TRawGnn
from ihgnn_tpu.config import ModelConfig, TrainConfig, V
from ihgnn_tpu.data.synthetic import make_synthetic_data
from ihgnn_tpu.models.embedding import EmbeddingTables
from ihgnn_tpu.models.interaction import FeatureInteractor
from ihgnn_tpu.models.layers import IHGNNLayer
from ihgnn_tpu.models.rawgnn import RawGnn
from ihgnn_tpu.ops.hyperagg import strip_kernel_packing

D = 16
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def data():
    # the shapes of the single-chip compile check (__graft_entry__.py)
    return make_synthetic_data(user_count=20, query_count=12, item_count=30,
                               vocab_size=25, log_count=150, seed=0)


@pytest.fixture(scope="module")
def graphs(data):
    """(JAX HyperGraph without kernel packs, the port's HyperGraph)."""
    return strip_kernel_packing(data.hypergraph), build_hypergraph(
        data.pos_uqif, data.node_count, data.user_count, data.query_count)


def _numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _state_dict(params, prefix):
    """Flax ``{kernel, bias}`` dense leaves of ``params[...prefix]`` as an
    ``nn.Linear`` state dict."""
    dense = params
    for key in prefix:
        dense = dense[key]
    return {"weight": torch.from_numpy(np.array(dense["kernel"]).T.copy()),
            "bias": torch.from_numpy(np.array(dense["bias"]))}


def _batch(data, rows, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, data.user_count, rows).astype(np.int32),
            rng.integers(0, data.query_count, rows).astype(np.int32),
            rng.integers(0, data.item_count, rows).astype(np.int32))


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


def test_config_defaults_match_jax():
    ours, theirs = tcfg.ModelConfig(), ModelConfig()
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    assert ours.output_feature_size == theirs.output_feature_size
    for order in (1, 2, 3):
        a = tcfg.ModelConfig(feature_interaction_order=order)
        b = ModelConfig(feature_interaction_order=order)
        assert [a.layer_order(k) for k in range(3)] == \
            [b.layer_order(k) for k in range(3)]
    ours, theirs = tcfg.TrainConfig(), TrainConfig()
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    assert ours.negative_sample_size == theirs.negative_sample_size
    assert {f.name for f in dataclasses.fields(ours)} >= {
        "batch_size", "learning_rate", "weight_decay",
        "random_negative_sample_size", "non_random_negative_sample_size",
        "adjust_learning_rate", "lr_decay_factor", "lr_decay_loss_threshold",
        "lr_floor", "grad_accum_steps", "eval_batch_size"}
    assert ours.eval_batch_size == 256


# ---------------------------------------------------------------------------
# the modules that call kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("transform", [V.MEAN, V.ACTIVATION])
def test_embedding_all_features_match_jax(data, transform):
    """X0 = [users | bag-mean queries | items]: the bag mean is K1."""
    mod = EmbeddingTables(data.user_count, data.item_count, data.vocab_size,
                          D, query_transform=transform)
    qw, qc = jnp.asarray(data.query_words), jnp.asarray(data.query_word_counts)
    params = mod.init(jax.random.key(1), qw, qc,
                      method=EmbeddingTables.all_features_t)
    ref = np.asarray(mod.apply(params, qw, qc,
                               method=EmbeddingTables.all_features_t)).T

    ours = TEmbeddingTables(data.user_count, data.item_count,
                            data.vocab_size, D, query_transform=transform)
    p = _numpy_tree(params)["params"]
    sd = {f"{name}_table": torch.from_numpy(p[f"{name}_table"].T.copy())
          for name in ("user", "item", "vocab")}
    if transform == V.ACTIVATION:
        sd.update({f"query_mlp.{k}": v for k, v in _state_dict(
            params, ("params", "query_mlp", "dense")).items()})
    ours.load_state_dict(sd, strict=True)
    got = ours.all_features(make_word_bag(data.query_words,
                                          data.query_word_counts,
                                          data.vocab_size + 1))
    assert got.shape == (data.node_count, D)
    np.testing.assert_allclose(got.detach().numpy(), ref, **TOL)


def test_word_bag_drops_padding_and_weighs_by_count():
    qw = np.array([[3, 0, 5], [0, 0, 0], [2, 2, 0]], np.int32)
    qc = np.array([2, 0, 2], np.int32)
    bag = make_word_bag(qw, qc, 6)
    assert bag.rowptr.tolist() == [0, 2, 2, 4]
    assert bag.col.tolist() == [3, 5, 2, 2]
    np.testing.assert_allclose(bag.weight.numpy(), [0.5, 0.5, 0.5, 0.5])


@pytest.mark.parametrize("order", [1, 2, 3])
def test_feature_interactor_matches_jax(order):
    rng = np.random.default_rng(order)
    e, out = 45, 8
    roles = [rng.standard_normal((e, D)).astype(np.float32) for _ in range(3)]
    roles_t = tuple(jnp.asarray(r.T) for r in roles)
    mod = FeatureInteractor(order, D, out)
    params = mod.init(jax.random.key(order), roles_t)
    ref = np.asarray(mod.apply(params, roles_t)).T

    ours = TFeatureInteractor(order, D, out)
    ours.aggregation.load_state_dict(
        _state_dict(params, ("params", "aggregation", "dense")))
    got = ours(torch.from_numpy(np.stack(roles)))
    np.testing.assert_allclose(got.detach().numpy(), ref, **TOL)


@pytest.mark.parametrize("order", [1, 2, 3])
def test_ihgnn_layer_matches_jax(data, graphs, order):
    """feature_transform → K2 gather → K3 interaction → K1 scatter → /dv."""
    jg, tg = graphs
    x = np.random.default_rng(10 + order).standard_normal(
        (data.node_count, D)).astype(np.float32)
    layer = IHGNNLayer(D, D, interaction_order=order)
    params = layer.init(jax.random.key(order), jnp.asarray(x.T), jg)
    ref = np.asarray(layer.apply(params, jnp.asarray(x.T), jg)).T

    ours = TIHGNNLayer(D, D, interaction_order=order)
    ours.feature_transform.load_state_dict(
        _state_dict(params, ("params", "feature_transform", "dense")))
    ours.interactor.aggregation.load_state_dict(
        _state_dict(params, ("params", "interactor", "aggregation", "dense")))
    got = ours(torch.from_numpy(x), tg)
    np.testing.assert_allclose(got.detach().numpy(), ref, **TOL)


def test_ihgnn_layer_zero_degree_nodes_stay_zero():
    # node 3 (a user) and the last item have no edge
    g = build_hypergraph(np.array([[0, 0, 0], [2, 1, 0], [0, 1, 1]]),
                         4 + 2 + 3, 4, 2)
    out = TIHGNNLayer(4, 4, interaction_order=3)(torch.randn(9, 4), g)
    assert torch.isfinite(out).all()
    assert torch.equal(out[3], torch.zeros(4))
    assert torch.equal(out[8], torch.zeros(4))


def test_ihgnn_layer_phase2_is_not_ported():
    """Phase 2 is ported now: the layer holds the JAX package's
    phase-2 parameters (``phase2_transform``, ``phase2_gat``) with their
    shapes, and only with phase 2 on."""
    shapes = {k: tuple(v.shape) for k, v in
              TIHGNNLayer(4, 4, phase2_attention=True).state_dict().items()}
    assert shapes["phase2_transform.weight"] == (4, 4)
    assert shapes["phase2_gat.feature_aggregate.weight"] == (1, 8)
    assert shapes["phase2_gat.feature_aggregate.bias"] == (1,)
    product = TIHGNNLayer(4, 4, phase2_attention=True, gat_head=V.PRODUCT)
    assert product.phase2_gat.feature_aggregate.weight.shape == (1, 4)
    assert not any(k.startswith("phase2") for k in
                   TIHGNNLayer(4, 4).state_dict())


# ---------------------------------------------------------------------------
# the whole serving forward
# ---------------------------------------------------------------------------

VARIANTS = [
    # (order, query transform, cosine head, λ of m_uq = λ·q + (1-λ)·u)
    (3, V.MEAN, False, 0.5),        # the default model
    (2, V.MEAN, False, 0.5),
    (1, V.MEAN, False, 0.3),
    (3, V.ACTIVATION, False, 0.5),
    (3, V.MEAN, True, 0.8),
    (1, V.ACTIVATION, True, 0.5),
]


@pytest.mark.parametrize("order,transform,cosine,lam", VARIANTS)
def test_rawgnn_matches_jax(data, graphs, order, transform, cosine, lam):
    jg, tg = graphs
    kw = dict(embedding_size=D, gnn_layer_count=2,
              feature_interaction_order=order, query_transform=transform,
              use_cosine_similarity=cosine, lambda_muq=lam)
    model = RawGnn(ModelConfig(**kw), data.user_count, data.query_count,
                   data.item_count, data.vocab_size)
    qw, qc = jnp.asarray(data.query_words), jnp.asarray(data.query_word_counts)
    users, queries, items = _batch(data, 24, seed=order)
    params = model.init(jax.random.key(7), jg, qw, qc, users[:1],
                        queries[:1], items[:1])
    feats = model.apply(params, jg, qw, qc, method=RawGnn.all_features)
    ref_feats = np.asarray(feats).T
    ref_score = np.asarray(model.apply(params, feats, users, queries, items,
                                       method=RawGnn.score))
    ref_all = np.asarray(model.apply(params, feats, users, queries,
                                     method=RawGnn.score_all_items))
    ref_call = np.asarray(model.apply(params, jg, qw, qc, users, queries))

    ours = TRawGnn(tcfg.ModelConfig(**kw), data.user_count,
                   data.query_count, data.item_count, data.vocab_size)
    ours.load_state_dict(params_from_jax(_numpy_tree(params)), strict=True)
    bag = make_word_bag(data.query_words, data.query_word_counts,
                        data.vocab_size + 1)
    t = [torch.from_numpy(a) for a in (users, queries, items)]
    with torch.no_grad():
        got_feats = ours.all_features(tg, bag)
        got_score = ours.score(got_feats, *t)
        got_all = ours.score_all_items(got_feats, t[0], t[1])
        got_call = ours(tg, bag, t[0], t[1])

    assert got_feats.shape == (data.node_count, 3 * D)
    assert got_all.shape == (24, data.item_count)
    np.testing.assert_allclose(got_feats.numpy(), ref_feats, **TOL)
    np.testing.assert_allclose(got_score.numpy(), ref_score, **TOL)
    np.testing.assert_allclose(got_all.numpy(), ref_all, **TOL)
    np.testing.assert_allclose(got_call.numpy(), ref_call, **TOL)


def test_params_from_jax_layouts(data, graphs):
    """Tables [d, rows] → [rows, d] with row 0 the padding row; flax kernels
    [in, out] → Linear.weight [out, in]; items_bias is N(0, 1), not zero."""
    jg, _ = graphs
    model = RawGnn(ModelConfig(embedding_size=D), data.user_count,
                   data.query_count, data.item_count, data.vocab_size)
    qw, qc = jnp.asarray(data.query_words), jnp.asarray(data.query_word_counts)
    z = jnp.zeros((1,), jnp.int32)
    tree = _numpy_tree(model.init(jax.random.key(3), jg, qw, qc, z, z, z))
    sd = params_from_jax(tree)
    p = tree["params"]
    assert sd["embeddings.user_table"].shape == (data.user_count + 1, D)
    assert torch.equal(sd["embeddings.user_table"][0], torch.zeros(D))
    np.testing.assert_array_equal(sd["embeddings.item_table"].numpy(),
                                  p["embeddings"]["item_table"].T)
    ft = p["gnn_0"]["feature_transform"]["dense"]["kernel"]
    np.testing.assert_array_equal(
        sd["gnns.0.feature_transform.weight"].numpy(), ft.T)
    assert sd["gnns.0.interactor.aggregation.weight"].shape == (D, 7 * D)
    assert sd["gnns.1.interactor.aggregation.weight"].shape == (D, 3 * D)
    assert sd["prediction.items_bias"].abs().sum() > 0
    TRawGnn(tcfg.ModelConfig(embedding_size=D), data.user_count,
            data.query_count, data.item_count,
            data.vocab_size).load_state_dict(sd, strict=True)


def test_port_init_statistics():
    """The port's own seeded init: padding rows zero, item bias N(0, 1),
    same seed gives the same weights."""
    def make():
        return TRawGnn(tcfg.ModelConfig(embedding_size=8), 50, 20, 400, 30,
                       generator=torch.Generator().manual_seed(4))
    a, b = make(), make()
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    assert torch.equal(a.embeddings.user_table[0], torch.zeros(8))
    assert torch.equal(a.embeddings.item_table[0], torch.zeros(8))
    bias = a.prediction.items_bias
    assert abs(bias.mean().item()) < 0.2 and 0.8 < bias.std().item() < 1.2


def test_rawgnn_rejects_unported_layers(graphs):
    """Every layer type is ported now; an unknown one is refused, and so is
    a graph of another type than the layers read."""
    with pytest.raises(ValueError):
        TRawGnn(tcfg.ModelConfig(gnn="sage"), 3, 3, 3, 3)
    _, tg = graphs
    bag = make_word_bag(np.ones((12, 1), np.int32), np.ones(12, np.int32),
                        26)
    for gnn in (V.GCN, V.GAT):
        model = TRawGnn(tcfg.ModelConfig(gnn=gnn, embedding_size=4), 20, 12,
                        30, 25)
        with pytest.raises(TypeError):
            model.all_features(tg, bag)
