"""The port's K6/K7 permute twins and routed chains against the JAX
package's Pallas kernels in interpret mode, on the CPU.

Inputs come from numpy seeds. The JAX side runs its Pallas kernels in
interpret mode (as ``tests/test_permute_kernel.py`` and
``tests/test_hyperagg_pallas.py`` run them); the port's wrappers run
their plain twins on CPU tensors over the same tables the CUDA kernels
read.

Tolerances:
* the permute twins: exact (a copy). They are held on values that bf16
  holds exactly, which the TPU's f32 one-hot permutes (a bf16 hi/lo split)
  also copy exactly;
* the routed chains against the Pallas chains: 1e-4, the tolerance of
  ``tests/test_hyperagg_pallas.py`` (the windowed expand's one-hot matmul
  rounds f32 through its hi/lo split).

The graph has E = 400 edges on a 128 × 128 grid (e_pad = 16384), so σ
pads interleave with real edges in every row that holds the tail.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ihgnn_torch import graph as tgraph
from ihgnn_torch.ops.hyperagg import (GatherPreFn, RoutedGatherFn,
                                      RoutedScatterFn, Scatter2Fn)
from ihgnn_torch.ops.permute import (row_local_permute_plain,
                                     transposed_local_permute_plain)
from ihgnn_tpu import graph as jgraph
from ihgnn_tpu.ops.hyperagg import (_gather_pre_pallas, _gather_roles_pallas,
                                    _scatter2_pallas, _scatter_pallas)
from ihgnn_tpu.ops.pallas.permute import (block_transpose, row_local_permute,
                                          transposed_local_permute)

U, Q, I = 40, 25, 60
N = U + Q + I
P = 400
CHAIN_TOL = dict(rtol=1e-4, atol=1e-4)


def _np(t):
    return t.detach().numpy()


@pytest.fixture(scope="module")
def graphs():
    """(JAX packed graph, the port's packed graph) of 400 edges."""
    rng = np.random.default_rng(0)
    uqi = np.stack([rng.integers(0, U, P), rng.integers(0, Q, P),
                    rng.integers(0, I, P)], axis=1)
    return (jgraph.build_hypergraph(uqi, N, U, Q),
            tgraph.build_hypergraph(uqi, N, U, Q, pack_kernels=True))


# ---------------------------------------------------------------------------
# K6/K7 twins against the Pallas permutes in interpret mode
# ---------------------------------------------------------------------------


def test_permute_twins_match_pallas():
    """``row_local_permute``, ``block_transpose``,
    ``transposed_local_permute`` and the pre form (a transpose, then the
    transposed permute) against the Pallas kernels, bit for bit; the JAX
    layout is [d, R, C], the port's [R, C, d]. (The bf16 rows of the
    kernel are held on the card, ``tests/test_torch_cuda.py``.)"""
    d, r, c = 4, 128, 128
    rng = np.random.default_rng(3)
    x = np.asarray(jnp.asarray(rng.standard_normal((d, r, c)), jnp.bfloat16)
                   .astype(jnp.float32))
    p = np.stack([rng.permutation(c) for _ in range(r)]).astype(np.int32)
    pt = np.stack([rng.permutation(r) for _ in range(c)]).astype(np.int32)
    xj = jnp.asarray(x)
    xt = torch.from_numpy(x.transpose(1, 2, 0).copy())

    def same(ours, theirs):
        np.testing.assert_array_equal(ours.permute(2, 0, 1).numpy(),
                                      np.asarray(theirs))

    same(row_local_permute_plain(xt, torch.from_numpy(p)),
         row_local_permute(xj, jnp.asarray(p), interpret=True))
    same(transposed_local_permute_plain(xt),
         block_transpose(xj, interpret=True))
    same(transposed_local_permute_plain(xt, torch.from_numpy(p)),
         transposed_local_permute(xj, jnp.asarray(p), interpret=True))
    same(transposed_local_permute_plain(xt, torch.from_numpy(pt), pre=True),
         transposed_local_permute(block_transpose(xj, interpret=True),
                                  jnp.asarray(pt), interpret=True))


# ---------------------------------------------------------------------------
# the routed chains against the Pallas chains, values and gradients
# ---------------------------------------------------------------------------


def _chain_inputs(jk, seed, d=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, d)).astype(np.float32)
    cot3 = rng.standard_normal((3, jk.e_pad, d)).astype(np.float32)
    edge = rng.standard_normal((jk.e_pad, d)).astype(np.float32)
    cot_n = rng.standard_normal((N, d)).astype(np.float32)
    return x, cot3, edge, cot_n


def _x_pad(x, jk):
    return jnp.pad(jnp.asarray(x.T), ((0, 0), (0, jk.src_pad - N)))


@pytest.mark.parametrize("pre", [False, True])
def test_routed_gather_matches_pallas(graphs, pre):
    """``RoutedGatherFn`` / ``GatherPreFn`` against ``_gather_roles_pallas``
    / ``_gather_pre_pallas``: the three role streams and the gradient of x
    for one cotangent."""
    jg, tg = graphs
    jk = jg.kp
    x, cot3, _, _ = _chain_inputs(jk, 5)
    fn = _gather_pre_pallas if pre else _gather_roles_pallas
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(lambda a: fn(a, jk), _x_pad(x, jk))
        (gx,) = vjp(tuple(jnp.asarray(c.T) for c in cot3))
    xt = torch.from_numpy(x).requires_grad_()
    got = (GatherPreFn if pre else RoutedGatherFn).apply(xt, tg.kp)
    assert got.shape == (3, jk.e_pad, x.shape[1])
    for r in range(3):
        np.testing.assert_allclose(_np(got[r]), np.asarray(out[r]).T,
                                   **CHAIN_TOL)
    got.backward(torch.from_numpy(cot3))
    np.testing.assert_allclose(_np(xt.grad), np.asarray(gx)[:, :N].T,
                               **CHAIN_TOL)


def test_routed_scatter_matches_pallas(graphs):
    """``RoutedScatterFn`` against ``_scatter_pallas``: the node sums of a
    σ-ordered stream, and its gradient, zero at the σ pads."""
    jg, tg = graphs
    jk = jg.kp
    _, _, edge, cot_n = _chain_inputs(jk, 6)
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(lambda e: _scatter_pallas(e, jk),
                           jnp.asarray(edge.T))
        (ge,) = vjp(jnp.asarray(cot_n.T))
    et = torch.from_numpy(edge).requires_grad_()
    got = RoutedScatterFn.apply(et, tg.kp)
    np.testing.assert_allclose(_np(got), np.asarray(out).T, **CHAIN_TOL)
    got.backward(torch.from_numpy(cot_n))
    np.testing.assert_allclose(_np(et.grad), np.asarray(ge).T, **CHAIN_TOL)
    pads = _np(tg.kp.sig_mask) == 0
    assert pads.any() and (_np(et.grad)[pads] == 0).all()


def test_scatter2_matches_pallas(graphs):
    """``Scatter2Fn`` against ``_scatter2_pallas``: the node sums of the
    (σ stream, ρ-permuted stream) pair and both gradients."""
    jg, tg = graphs
    jk = jg.kp
    rng = np.random.default_rng(7)
    edge, pre_i = (rng.standard_normal((jk.e_pad, 8)).astype(np.float32)
                   for _ in range(2))
    cot_n = rng.standard_normal((N, 8)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(lambda a, b: _scatter2_pallas(a, b, jk),
                           jnp.asarray(edge.T), jnp.asarray(pre_i.T))
        ga, gb = vjp(jnp.asarray(cot_n.T))
    et, pt = (torch.from_numpy(a).requires_grad_() for a in (edge, pre_i))
    got = Scatter2Fn.apply(et, pt, tg.kp)
    np.testing.assert_allclose(_np(got), np.asarray(out).T, **CHAIN_TOL)
    got.backward(torch.from_numpy(cot_n))
    np.testing.assert_allclose(_np(et.grad), np.asarray(ga).T, **CHAIN_TOL)
    np.testing.assert_allclose(_np(pt.grad), np.asarray(gb).T, **CHAIN_TOL)
