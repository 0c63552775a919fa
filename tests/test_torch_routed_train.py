"""Train steps of ``RawGnn`` on a packed graph (the port's routed path)
against the JAX package's ``make_train_step`` on the same weights and
batches, on the CPU.

Inputs come from numpy seeds; the JAX model runs on the unpacked graph,
the port's on ``build_hypergraph(..., pack_kernels=True)``, whose layers
run the plain twins of the routed kernels. 6 train steps' losses agree
within rtol 1e-5: the routed path sums each node's entries in stream
order, not edge order, so it agrees with the JAX XLA path to f32
rounding, not bitwise.

The graphs have E = 400 edges on a 128 × 128 grid (e_pad = 16384), so σ
pads interleave with real edges in every row that holds the tail.
"""

import dataclasses

import jax
import numpy as np
import pytest

from ihgnn_torch import config as tcfg
from ihgnn_torch import graph as tgraph
from ihgnn_torch.convert import params_from_jax
from ihgnn_torch.data.dataset import Batch as TBatch
from ihgnn_torch.models.rawgnn import RawGnn as TRawGnn
from ihgnn_torch.train import train as ttrain
from ihgnn_tpu import graph as jgraph
from ihgnn_tpu.config import Config, ModelConfig, TrainConfig, V
from ihgnn_tpu.data.dataset import Batch
from ihgnn_tpu.models.rawgnn import RawGnn
from ihgnn_tpu.train.train import init_state, make_optimizer, make_train_step

U, Q, I, VOCAB = 40, 25, 60, 30
N = U + Q + I
D = 16
P, B, K, LW = 400, 32, 10, 4
STEPS = 6
CASES = {"ihgnn": dict(), "hgcn": dict(gnn=V.HGCN),
         "phase2": dict(phase2_attention=True)}


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _setup(case, seed):
    """(JAX RawGnn, JAX unpacked graph, the port's packed graph,
    interactions, words)."""
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
    model = RawGnn(ModelConfig(embedding_size=D, **CASES[case]), U, Q, I,
                   VOCAB)
    return model, jg, tg, uqi, qw, qc


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


@pytest.mark.parametrize("case", list(CASES))
def test_rawgnn_train_steps_on_packed_graph_match_jax(case):
    """STEPS train steps on the packed graph against ``make_train_step`` on
    the same weights and batches: losses within rtol 1e-5."""
    model, jg, tg, uqi, qw, qc = _setup(case, 14)
    cfg = Config(model=ModelConfig(embedding_size=D, **CASES[case]),
                 train=TrainConfig(batch_size=B,
                                   random_negative_sample_size=K))
    tx = make_optimizer(cfg)
    state = init_state(model, jax.random.key(14), jg, qw, qc, cfg, tx)
    step = make_train_step(model, jg, qw, qc, tx)
    ours = TRawGnn(tcfg.ModelConfig(embedding_size=D, **CASES[case]), U, Q,
                   I, VOCAB)
    ours.load_state_dict(params_from_jax(_numpy_tree(state.params)),
                         strict=True)
    opt = ttrain.make_optimizer(ours.parameters(), tcfg.TrainConfig())
    tstep = ttrain.make_train_step(ours, tg, qw, qc, opt, device="cpu")
    losses, tlosses = [], []
    for batch in _batches(uqi, STEPS, 15):
        state, loss = step(state, _jax_batch(batch))
        losses.append(float(loss))
        tlosses.append(tstep(batch).item())
    np.testing.assert_allclose(tlosses, losses, rtol=1e-5)
    assert len(set(tlosses)) == STEPS
