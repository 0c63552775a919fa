"""The port's Srrl (model, KG sampler, alternating KG/PS trainer) against
the JAX package's, on the CPU at d = 8 over ``tests/test_srrl.py``'s
split.

The cases of ``tests/test_srrl.py`` run on the port (meta-path indexing,
the mode rotation, the phase-mask partition, unit-norm table rows, the
logged negatives, the chunked catalog scorer against the row-wise one).
Against JAX, from the same weights (carried over with
``convert.srrl_params_from_jax``) and the same batches:
* ``trainkg`` in each mode, ``all_features`` and ``score_all_items``
  (both scorers): 1e-5 absolute (f32 sums in another order);
* the KG sampler's batches: equal, element for element;
* 6 KG steps (two rotations of the modes) then 6 PS steps: each loss
  within 1e-5 relative and every parameter after them within 1e-5
  absolute (Adam moves an element by about lr whatever its gradient's
  size, so the tolerance is set against lr = 5e-3, not the gradient);
* ``MLP`` and ``Aggregation`` of ``models/common.py``: 1e-6.
The penalty of ``srrl_regularization`` is held to add to the loss and
leave every parameter bit for bit as without it; a checkpoint round trip
and the step after it are held bit for bit.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ihgnn_torch import config as tcfg
from ihgnn_torch.convert import srrl_params_from_jax
from ihgnn_torch.data import synthetic as tsynthetic
from ihgnn_torch.data.dataset import TrainSampler as TTrainSampler
from ihgnn_torch.data.srrl_sampler import MetaPaths as TMetaPaths
from ihgnn_torch.data.srrl_sampler import SrrlKGSampler as TKGSampler
from ihgnn_torch.models import common as tcommon
from ihgnn_torch.models.srrl import KG_MODES as T_KG_MODES
from ihgnn_torch.models.srrl import Srrl as TSrrl
from ihgnn_torch.train import checkpoint as tckpt
from ihgnn_torch.train import srrl_loop as tloop
from ihgnn_tpu.config import Config, ModelConfig, TrainConfig
from ihgnn_tpu.data.dataset import Batch as JBatch
from ihgnn_tpu.data.srrl_sampler import MetaPaths, SrrlKGSampler
from ihgnn_tpu.data.synthetic import make_synthetic_splits
from ihgnn_tpu.models import common as jcommon
from ihgnn_tpu.models.srrl import KG_MODES, Srrl
from ihgnn_tpu.train import srrl_loop as jloop

D = 8
SPLIT = dict(user_count=10, query_count=8, item_count=15, vocab_size=12,
             log_count=120)
LR, B, K = 5e-3, 16, 4
ATOL = 1e-5
LOSS_RTOL = 1e-5


def _configs(**model):
    j = Config(model=ModelConfig(embedding_size=D, **model),
               train=TrainConfig(batch_size=B, random_negative_sample_size=K,
                                 learning_rate=LR))
    t = tcfg.Config(model=tcfg.ModelConfig(embedding_size=D, **model),
                    train=tcfg.TrainConfig(batch_size=B,
                                           random_negative_sample_size=K,
                                           learning_rate=LR))
    return j, t


@pytest.fixture(scope="module")
def split():
    j_train, _, j_test = make_synthetic_splits(seed=9, **SPLIT)
    t_train, _, t_test = tsynthetic.make_synthetic_splits(seed=9, **SPLIT)
    return j_train, j_test, t_train, t_test


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_model(t_cfg, t_train, params, prediction="mlp"):
    model = TSrrl(t_cfg.model, t_train.user_count, t_train.query_count,
                  t_train.item_count, t_train.vocab_size,
                  prediction=prediction)
    model.load_state_dict(srrl_params_from_jax(_numpy(params)))
    return model


@pytest.fixture(scope="module")
def init(split):
    """JAX's ``init_srrl`` and the port's ``Srrl`` from its weights."""
    j_train, _, t_train, _ = split
    j_cfg, t_cfg = _configs()
    model, state, tx_kg, tx_ps = jloop.init_srrl(j_cfg, j_train,
                                                 jax.random.key(0))
    return model, state, _port_model(t_cfg, t_train, state.params)


def _words(t_train):
    return (torch.as_tensor(t_train.query_words).long(),
            torch.as_tensor(t_train.query_word_counts).long())


def _state_close(model, j_params, atol=ATOL):
    want = srrl_params_from_jax(_numpy(j_params))
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=atol, rtol=0, err_msg=k)


# ---- the cases of tests/test_srrl.py, on the port ----

def test_metapaths_indexing(split):
    t_train = split[2]
    mp = TMetaPaths(t_train)
    assert len(mp.positive_interactions) == t_train.pos_count
    u, q, i = mp.positive_interactions[0]
    assert i in mp.positive_tails[(u, q)]
    assert u in mp.positive_heads[(q, i)]
    assert q in mp.positive_queries[(u, i)]
    count = sum(1 for uu, qq, _ in mp.positive_interactions
                if (uu, qq) == (u, q))
    assert mp.head_query_frequency[(u, q)] == 3 + count


def test_kg_sampler_rotates_modes(split):
    sampler = TKGSampler(TMetaPaths(split[2]), batch_size=8,
                         negative_sample_size=3, seed=0)
    modes = [sampler.next()[0] for _ in range(6)]
    assert modes == list(T_KG_MODES) * 2 and T_KG_MODES == KG_MODES
    _, triples, negs, weights, company = sampler.next()
    assert triples.shape == (8, 3) and negs.shape == (8, 3)
    assert np.all(weights > 0) and np.all(weights <= 1 / 2)


def test_phase_masks_partition_equal_jax(init):
    model, state, t_model = init
    kg, ps = tloop.phase_masks(t_model)
    assert "KG.user_table" in kg and "ps_mlp_uq.fc1.weight" in ps
    assert "KG.vocab_table" in kg and "KG.vocab_table" in ps
    assert not any(n.startswith("PS.") for n in kg)
    assert kg | ps == {n for n, _ in t_model.named_parameters()}
    j_kg, j_ps = jloop._phase_masks(state.params)

    def names(mask):
        ones = jax.tree_util.tree_map(
            lambda m, p: np.full(np.shape(p), float(m), np.float32), mask,
            _numpy(state.params))
        return {k for k, v in srrl_params_from_jax(ones).items()
                if bool(v.all())}
    assert names(j_kg) == kg and names(j_ps) == ps


def test_srrl_embedding_rows_unit_norm(split):
    t_train = split[2]
    model = TSrrl(tcfg.ModelConfig(embedding_size=D), t_train.user_count,
                  t_train.query_count, t_train.item_count,
                  t_train.vocab_size,
                  generator=torch.Generator().manual_seed(0))
    for space in (model.KG, model.PS):
        for table in (space.user_table, space.item_table):
            w = table.detach().numpy()
            np.testing.assert_allclose(np.linalg.norm(w[1:], axis=1), 1.0,
                                       rtol=1e-5)
            assert np.all(w[0] == 0.0)
    vocab = model.KG.vocab_table.detach().numpy()
    np.testing.assert_allclose(np.linalg.norm(vocab, axis=1), 1.0,
                               rtol=1e-5)
    assert not hasattr(model.PS, "vocab_table")
    for name, p in model.named_parameters():
        if name.endswith(".bias"):
            assert torch.all(p == 0), name


def test_kg_sampler_nonrandom_negatives(split):
    mp = TMetaPaths(split[2])
    sampler = TKGSampler(mp, batch_size=8, negative_sample_size=3, seed=0,
                         only_random_negatives=False)
    _, triples, negs, _, _ = sampler.next()
    for r, (u, q, i) in enumerate(triples):
        pool = mp.negative_tails.get((int(u), int(q)))
        if pool:
            assert set(negs[r]) <= set(pool)


def test_chunked_catalog_scorer_matches_rowwise(init, split):
    _, _, model = init
    t_train = split[2]
    qw, qc = _words(t_train)
    with torch.no_grad():
        feats = model.all_features(qw, qc)
        users = torch.tensor([0, 3, 7])
        queries = torch.tensor([1, 0, 5])
        scores = model.score_all_items(feats, users, queries, 4)
        assert scores.shape == (3, t_train.item_count)
        items = torch.arange(t_train.item_count)
        for r in range(3):
            ref = model(qw, qc, users[r].repeat(len(items)),
                        queries[r].repeat(len(items)), items)
            np.testing.assert_allclose(scores[r].numpy(), ref.numpy(),
                                       rtol=1e-5, atol=1e-5)


# ---- against JAX ----

@pytest.mark.parametrize("mode", KG_MODES)
def test_trainkg_equal_jax(init, split, mode):
    model, state, t_model = init
    j_train, _, t_train, _ = split
    rng = np.random.default_rng(1)
    triples = np.asarray(t_train.pos_uqif[:6, :3], np.int32)
    negs = rng.integers(0, t_train.item_count, (6, 5)).astype(np.int32)
    company = rng.integers(0, 8, 6).astype(np.int32)
    qw, qc = _words(t_train)
    for n in (None, negs):
        want = model.apply(state.params, triples, n, company, mode,
                           j_train.query_words, j_train.query_word_counts,
                           method=model.trainkg)
        with torch.no_grad():
            got = t_model.trainkg(torch.as_tensor(triples),
                                  None if n is None else torch.as_tensor(n),
                                  torch.as_tensor(company), mode, qw, qc)
        assert got.shape == (6, 1 if n is None else 5)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("prediction", ["mlp", "hem"])
def test_features_and_scores_equal_jax(split, prediction):
    j_train, _, t_train, _ = split
    j_cfg, t_cfg = _configs()
    model = Srrl(cfg=j_cfg.model, user_count=j_train.user_count,
                 query_count=j_train.query_count,
                 item_count=j_train.item_count,
                 vocab_size=j_train.vocab_size, prediction=prediction)
    params = _numpy(jax.jit(lambda r: model.init(
        r, j_train.query_words, j_train.query_word_counts,
        method=model.init_all))(jax.random.key(3)))
    if prediction == "hem":
        # a nonzero item bias, so the scorer's bias is held too
        params["params"]["prediction"]["items_bias"] = \
            np.random.default_rng(2).normal(
                size=j_train.item_count).astype(np.float32)
    t_model = _port_model(t_cfg, t_train, params, prediction)
    feats = model.apply(params, j_train.query_words,
                        j_train.query_word_counts, method=model.all_features)
    qw, qc = _words(t_train)
    users, queries = np.array([0, 3, 7, 9]), np.array([1, 0, 5, 7])
    with torch.no_grad():
        t_feats = t_model.all_features(qw, qc)
        np.testing.assert_allclose(t_feats.numpy(), np.asarray(feats),
                                   atol=ATOL, rtol=0)
        for chunk in (4, 8192):
            want = model.apply(params, feats, users, queries, chunk,
                               method=model.score_all_items)
            got = t_model.score_all_items(t_feats, torch.as_tensor(users),
                                          torch.as_tensor(queries), chunk)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=ATOL, rtol=0)


@pytest.mark.parametrize("only_random", [True, False])
def test_kg_sampler_batches_equal_jax(split, only_random):
    j_train, _, t_train, _ = split
    j = SrrlKGSampler(MetaPaths(j_train), 8, 3, seed=4,
                      only_random_negatives=only_random)
    t = TKGSampler(TMetaPaths(t_train), 8, 3, seed=4,
                   only_random_negatives=only_random)
    assert t.steps_per_epoch == j.steps_per_epoch
    for _ in range(9):
        (jm, *j_arrays), (tm, *t_arrays) = j.next(), t.next()
        assert tm == jm
        for a, b in zip(t_arrays, j_arrays):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def _batches(t_train, seed=1):
    kg = TKGSampler(TMetaPaths(t_train), B, K, seed=seed)
    ps = TTrainSampler(t_train, B, K, seed=seed)
    return [kg.next() for _ in range(6)], list(ps.epoch())[:6]


def _train_jax(j_cfg, j_train, kg_batches, ps_batches, snap_after=None):
    model, state, tx_kg, tx_ps = jloop.init_srrl(j_cfg, j_train,
                                                 jax.random.key(0))
    params0 = _numpy(state.params)
    kg_steps = jloop.make_kg_steps(model, j_train.query_words,
                                   j_train.query_word_counts, tx_kg, j_cfg)
    ps_step = jloop.make_ps_step(model, j_train.query_words,
                                 j_train.query_word_counts, tx_ps, j_cfg)
    losses, snaps = [], {}
    for k, (mode, *arrays) in enumerate(kg_batches):
        state, loss = kg_steps[mode](state, *arrays)
        losses.append(float(loss))
        snaps[k] = _numpy(state.params)
    for batch in ps_batches:
        state, loss = ps_step(state, JBatch(
            **{f.name: jnp.asarray(getattr(batch, f.name))
               for f in dataclasses.fields(batch)}))
        losses.append(float(loss))
    return params0, losses, snaps, state.params


def _train_port(t_cfg, t_train, params0, kg_batches, ps_batches):
    model = _port_model(t_cfg, t_train, params0)
    opt = tloop.make_optimizer(model, t_cfg.train.learning_rate)
    kg_steps = tloop.make_kg_steps(model, t_train.query_words,
                                   t_train.query_word_counts, opt, t_cfg,
                                   device="cpu")
    ps_step = tloop.make_ps_step(model, t_train.query_words,
                                 t_train.query_word_counts, opt, t_cfg,
                                 device="cpu")
    losses, snaps = [], {}
    for k, (mode, *arrays) in enumerate(kg_batches):
        losses.append(kg_steps[mode](*arrays).item())
        snaps[k] = copy.deepcopy(model.state_dict())
    for batch in ps_batches:
        losses.append(ps_step(batch).item())
    return model, opt, losses, snaps


@pytest.mark.parametrize("model_flags", [
    {}, {"srrl_uni_weight": True, "srrl_regularization": 0.1},
    {"srrl_kg_loss": False}])
def test_train_steps_equal_jax(split, model_flags):
    """6 KG steps (tail, head, query twice) then 6 PS steps from the same
    weights and batches: every loss and, after them, every parameter;
    ``kg_aggre_head`` also after the second tail step, where its gradient
    is zero and Adam still moves it by its moments."""
    j_train, _, t_train, _ = split
    j_cfg, t_cfg = _configs(**model_flags)
    kg_batches, ps_batches = _batches(t_train)
    params0, j_losses, j_snaps, j_params = _train_jax(
        j_cfg, j_train, kg_batches, ps_batches)
    model, _, t_losses, t_snaps = _train_port(t_cfg, t_train, params0,
                                              kg_batches, ps_batches)
    np.testing.assert_allclose(t_losses, j_losses, rtol=LOSS_RTOL)
    _state_close(model, j_params)
    assert kg_batches[3][0] == KG_MODES[0]
    for name in ("kg_aggre_head.fc.weight", "kg_aggre_head.fc.bias"):
        before, after = t_snaps[2][name], t_snaps[3][name]
        assert not torch.equal(before, after), name
        want = srrl_params_from_jax(j_snaps[3])[name]
        np.testing.assert_allclose(after.numpy(), want.numpy(), atol=ATOL,
                                   rtol=0, err_msg=name)


def test_penalty_inflates_loss_not_gradient(split, init):
    """``srrl_regularization`` adds coeff² · Σ‖table‖² to the reported
    loss and nothing to the gradient: the parameters after 12 steps are
    bit for bit those without it."""
    _, _, t_train, _ = split
    j_cfg, _ = _configs()
    kg_batches, ps_batches = _batches(t_train)
    params0 = _numpy(init[1].params)
    runs = {}
    for reg in (0.0, 0.1):
        _, t_cfg = _configs(srrl_regularization=reg)
        runs[reg] = _train_port(t_cfg, t_train, params0, kg_batches,
                                ps_batches)
    (plain, _, plain_losses, _), (reg_model, _, reg_losses, _) = \
        runs[0.0], runs[0.1]
    for k, v in plain.state_dict().items():
        assert torch.equal(v, reg_model.state_dict()[k]), k
    assert all(r > p for r, p in zip(reg_losses, plain_losses))
    # the first KG step's penalty, from the initial tables
    p = srrl_params_from_jax(params0)
    penalty = 0.01 * sum(float((p[f"KG.{n}"].double() ** 2).sum())
                         for n in ("user_table", "vocab_table", "item_table"))
    np.testing.assert_allclose(reg_losses[0] - plain_losses[0], penalty,
                               rtol=1e-5)


@pytest.mark.parametrize("cls,args", [("MLP", (12, 5)),
                                      ("Aggregation", (12, 5))])
def test_common_modules_equal_jax(cls, args):
    j_mod = getattr(jcommon, cls)(*args)
    x = np.random.default_rng(0).normal(size=(7, args[0])).astype(np.float32)
    params = _numpy(j_mod.init(jax.random.key(5), x))["params"]
    t_mod = getattr(tcommon, cls)(*args,
                                  generator=torch.Generator().manual_seed(0))
    sd = {}
    for leaf in ("fc", "fc1", "fc2"):
        if leaf in params:
            dense = params[leaf]["dense"]
            sd[f"{leaf}.weight"] = torch.from_numpy(dense["kernel"].T.copy())
            sd[f"{leaf}.bias"] = torch.from_numpy(dense["bias"].copy())
    t_mod.load_state_dict(sd)
    with torch.no_grad():
        got = t_mod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(j_mod.apply(
        {"params": params}, x)), atol=1e-6, rtol=0)
    # the port draws torch's default Linear init: U(±1/sqrt(in))
    fresh = getattr(tcommon, cls)(*args)
    for name, p in fresh.named_parameters():
        assert p.abs().max() <= 1 / np.sqrt(args[0]), name


def test_srrl_checkpoint_round_trip_bit_for_bit(split, init, tmp_path):
    """The model and the shared Adam (moments and each parameter's step,
    those the KG phase never stepped included) round trip bit for bit,
    and the step after a restore equals the step without one."""
    _, _, t_train, _ = split
    j_cfg, t_cfg = _configs()
    kg_batches, ps_batches = _batches(t_train)
    params0 = _numpy(init[1].params)
    model, opt, _, _ = _train_port(t_cfg, t_train, params0, kg_batches[:4],
                                   [])
    name = tckpt.save_checkpoint(str(tmp_path), 2, model, opt)
    fresh = _port_model(t_cfg, t_train, params0)
    fresh_opt = tloop.make_optimizer(fresh, LR)
    assert tckpt.restore_checkpoint(str(tmp_path), name, fresh,
                                    fresh_opt) == 2
    for k, v in model.state_dict().items():
        assert torch.equal(v, fresh.state_dict()[k]), k
    saved, loaded = opt.state_dict(), fresh_opt.state_dict()
    assert saved["state"].keys() == loaded["state"].keys()
    stepped = {n for n, p in model.named_parameters() if p in opt.state}
    assert "KG.user_table" in stepped and "PS.user_table" not in stepped
    for k, state in saved["state"].items():
        for field, value in state.items():
            assert torch.equal(value, loaded["state"][k][field]), field
    outs = []
    for m, o in ((model, opt), (fresh, fresh_opt)):
        step = tloop.make_ps_step(m, t_train.query_words,
                                  t_train.query_word_counts, o, t_cfg,
                                  device="cpu")
        outs.append((step(ps_batches[0]).item(),
                     {k: v.clone() for k, v in m.state_dict().items()}))
    assert outs[0][0] == outs[1][0]
    for k, v in outs[0][1].items():
        assert torch.equal(v, outs[1][1][k]), k
