"""``RawGnn`` on a packed graph (the port's routed path) against the JAX
package's XLA f32 path on the same weights, on the CPU: features, the
step-0 loss and gradients. Train steps on a packed graph are held in
``tests/test_torch_routed_train.py``.

Inputs come from numpy seeds; the JAX model runs on the unpacked graph,
the port's on ``build_hypergraph(..., pack_kernels=True)``, whose layers
run the plain twins of the routed kernels. Features, gradients (each
within 1e-5 of its tensor's largest value) and the step-0 loss agree
within 1e-5: the routed path sums each node's entries in stream order,
not edge order, so it agrees with the JAX XLA path to f32 rounding, not
bitwise.

The graphs have E = 400 edges on a 128 × 128 grid (e_pad = 16384), so σ
pads interleave with real edges in every row that holds the tail.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ihgnn_torch import config as tcfg
from ihgnn_torch import graph as tgraph
from ihgnn_torch.convert import params_from_jax
from ihgnn_torch.data.dataset import Batch as TBatch
from ihgnn_torch.models.embedding import make_word_bag
from ihgnn_torch.models.rawgnn import RawGnn as TRawGnn
from ihgnn_torch.ops.hyperagg import strip_kernel_packing
from ihgnn_torch.train import train as ttrain
from ihgnn_tpu import graph as jgraph
from ihgnn_tpu.config import ModelConfig, V
from ihgnn_tpu.data.dataset import Batch
from ihgnn_tpu.models.rawgnn import RawGnn
from ihgnn_tpu.train.train import bce_with_logits

U, Q, I, VOCAB = 40, 25, 60, 30
N = U + Q + I
D = 16
P, B, K, LW = 400, 32, 10, 4
TOL = dict(rtol=1e-5, atol=1e-5)
CASES = {"ihgnn": dict(), "hgcn": dict(gnn=V.HGCN),
         "phase2": dict(phase2_attention=True)}


def _np(t):
    return t.detach().numpy()


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _setup(case, seed):
    """(JAX RawGnn, params, JAX unpacked graph, the port's packed graph and
    RawGnn with the same weights, interactions, words)."""
    kw = CASES[case]
    rng = np.random.default_rng(seed)
    uqi = np.stack([rng.integers(0, U, P), rng.integers(0, Q, P),
                    rng.integers(0, I, P)], axis=1)
    rng = np.random.default_rng(seed + 1)
    qw = np.zeros((Q, LW), np.int32)
    qc = rng.integers(1, LW + 1, Q).astype(np.int32)
    for q in range(Q):
        qw[q, :qc[q]] = rng.integers(1, VOCAB + 1, qc[q])
    jg = jgraph.build_hypergraph(uqi, N, U, Q, pack_kernels=False)
    tg = tgraph.build_hypergraph(uqi, N, U, Q, pack_kernels=True)
    model = RawGnn(ModelConfig(embedding_size=D, **kw), U, Q, I, VOCAB)
    z = jnp.zeros((1,), jnp.int32)
    params = jax.jit(model.init)(jax.random.key(seed), jg, jnp.asarray(qw),
                                 jnp.asarray(qc), z, z, z)
    ours = TRawGnn(tcfg.ModelConfig(embedding_size=D, **kw), U, Q, I, VOCAB)
    ours.load_state_dict(params_from_jax(_numpy_tree(params)), strict=True)
    return model, params, jg, tg, ours, uqi, qw, qc


def _batches(uqi, steps, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        idx = rng.integers(0, len(uqi), B)
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


def grad_scale(name, grads):
    """The largest value of gradient ``name``; for the phase-2 score head
    the largest gradient of its layer (``tests/test_torch_layers.py``)."""
    if ".feature_aggregate." in name:
        layer = name.split(".")[:2]
        return max(g.abs().max().item() for k, g in grads.items()
                   if k.split(".")[:2] == layer)
    return max(grads[name].abs().max().item(), 1e-30)


@pytest.mark.parametrize("case", list(CASES))
def test_rawgnn_on_packed_graph_matches_jax(case):
    """Features, the step-0 loss and every gradient of ``RawGnn`` on a
    packed graph (the default model absorbs the i stage) against the JAX
    package's XLA path; the routed path's features also match the port's
    own direct path."""
    model, params, jg, tg, ours, uqi, qw, qc = _setup(case, 12)
    assert tg.kp is not None and tg.kp.sig_mask is not None
    bag = make_word_bag(qw, qc, VOCAB + 1)
    jqw, jqc = jnp.asarray(qw), jnp.asarray(qc)
    feats = jax.jit(lambda p: model.apply(p, jg, jqw, jqc,
                                          method=RawGnn.all_features))(params)
    got = ours.all_features(tg, bag)
    np.testing.assert_allclose(_np(got), np.asarray(feats).T, **TOL)
    direct = ours.all_features(strip_kernel_packing(tg), bag)
    np.testing.assert_allclose(_np(got), _np(direct), **TOL)

    batch = _batches(uqi, 1, 13)[0]
    jb = _jax_batch(batch)

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
    assert set(named) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(_np(named[name].grad), g.numpy(), rtol=0,
                                   atol=1e-5 * grad_scale(name, want),
                                   err_msg=name)
