"""The port's routed hypergraph pack and its twins against the JAX
package on the CPU: the routed pack, the native router, K5's and K8's
twins, the node sums over the pack's CSR and the σ → edge relabelling.
The K6/K7 twins and the routed chains are held in
``tests/test_torch_routed_chains.py``, ``RawGnn`` on a packed graph in
``tests/test_torch_routed_model.py``.

Inputs come from numpy seeds. The JAX side runs its Pallas kernels in
interpret mode where the port holds a kernel's twin against them (as
``tests/test_interact_kernel.py`` and ``tests/test_segscan.py`` run
them). The port's wrappers run their plain twins on CPU tensors over the
same tables the CUDA kernels read.

Tolerances:
* the pack and the router: exact (integer tables);
* K5's twin: 1e-5 (of the largest value) against the explicit-permute f32
  formula; 3e-2 of the largest value against the Pallas
  ``fused_interaction_absorb``, which rounds MXU operands to bf16
  (``tests/test_interact_kernel.py:119-163``);
* K8's twin: 1e-4, the tolerance of ``tests/test_segscan.py``.

The graphs have E = 400 edges on a 128 × 128 grid (e_pad = 16384), so σ
pads interleave with real edges in every row that holds the tail; the pack
test also takes E = e_pad = 16384, where no pad exists.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ihgnn_torch import graph as tgraph
from ihgnn_torch.ops import benes as tbenes
from ihgnn_torch.ops import native as tnative
from ihgnn_torch.ops.hyperagg import sigma_to_edge_order
from ihgnn_torch.ops.interact import (interact_bwd_absorb_plain,
                                      interact_fwd_absorb_plain)
from ihgnn_torch.ops.packing import row_inverse
from ihgnn_torch.ops.permute import pick_grid
from ihgnn_torch.ops.segment import segment_sum
from ihgnn_torch.ops.segscan import SENTINEL, csr_segment_scan_plain
from ihgnn_torch.ops.segscan import pack_scan_inputs as tpack_scan
from ihgnn_torch.ops.segsum import csr_gather_sum_plain
from ihgnn_tpu import graph as jgraph
from ihgnn_tpu.ops.pallas.interact import fused_interaction_absorb
from ihgnn_tpu.ops.pallas.permute import pick_grid as jpick_grid
from ihgnn_tpu.ops.pallas.permute import unpack_stage_perm
from ihgnn_tpu.ops.pallas.segscan import csr_segment_scan_t
from ihgnn_tpu.ops.pallas.segscan import pack_scan_inputs as jpack_scan
from ihgnn_tpu.ops.pallas.segsum import BLOCK

U, Q, I = 40, 25, 60
N = U + Q + I
P = 400


def _uqi(seed, count=P):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, U, count), rng.integers(0, Q, count),
                     rng.integers(0, I, count)], axis=1)


def _np(t):
    return t.detach().numpy()


@pytest.fixture(scope="module")
def graphs():
    """(JAX packed graph, the port's packed graph) of 400 edges."""
    uqi = _uqi(0)
    return (jgraph.build_hypergraph(uqi, N, U, Q),
            tgraph.build_hypergraph(uqi, N, U, Q, pack_kernels=True))


# ---------------------------------------------------------------------------
# the pack and the router
# ---------------------------------------------------------------------------


def _abs_index(ep):
    """A JAX ``ExpandPack``'s absolute index: ``idx_rel + win`` per row."""
    idx = np.asarray(ep.idx)
    return (idx.reshape(idx.shape[0], -1)
            + np.asarray(ep.win)[:, None]).reshape(-1)


@pytest.mark.parametrize("edges", [P, 16384])
def test_pack_matches_jax(edges):
    """Every table of the port's pack equals the JAX pack's, decoded:
    the expand indices, every stage, the σ mask and the node sums' ids;
    and the port's own CSR and scan order list exactly those ids."""
    uqi = _uqi(1, edges)
    jk = jgraph.build_hypergraph(uqi, N, U, Q).kp
    kp = tgraph.build_hypergraph(uqi, N, U, Q, pack_kernels=True).kp
    assert (kp.rows, kp.cols, kp.e_pad) == (jk.rows, jk.cols, jk.e_pad)
    assert (kp.rows, kp.cols) == jpick_grid(edges) == pick_grid(edges)
    for ours, theirs in ((kp.u.idx, jk.u_expand), (kp.q.idx, jk.q.gather),
                         (kp.i.idx, jk.i.gather)):
        np.testing.assert_array_equal(_np(ours).reshape(-1),
                                      _abs_index(theirs))
    for ours, theirs in ((kp.q.p1, jk.q.fwd_p1), (kp.q.p1_inv, jk.q.inv_p1),
                         (kp.i.p1, jk.i.fwd_p1), (kp.i.p1_inv, jk.i.inv_p1),
                         (kp.i.p2, jk.i.fwd_p2), (kp.i.p2_inv, jk.i.inv_p2),
                         (kp.sig, jk.sig_stage)):
        np.testing.assert_array_equal(_np(ours),
                                      np.asarray(unpack_stage_perm(theirs)))
    assert kp.q.p2 is None and jk.q.fwd_p2 is None
    np.testing.assert_array_equal(_np(kp.sig_inv), row_inverse(_np(kp.sig)))
    if edges == kp.e_pad:
        assert kp.sig_mask is None and jk.sig_mask is None
    else:
        np.testing.assert_array_equal(_np(kp.sig_mask),
                                      np.asarray(jk.sig_mask).reshape(-1))
    ids = np.asarray(jk.ids2d).reshape(-1)
    np.testing.assert_array_equal(_np(kp.seg_ids), ids)
    real = ids[ids != SENTINEL]
    col = _np(kp.seg_col)
    assert len(col) == 3 * edges
    np.testing.assert_array_equal(ids[col], np.sort(real))
    np.testing.assert_array_equal(
        _np(kp.seg_rowptr), np.searchsorted(np.sort(real), np.arange(N + 1)))
    np.testing.assert_array_equal(_np(kp.scan.pos), col)
    rowptr, block_seg = _np(kp.scan.rowptr), _np(kp.scan.block_seg)
    np.testing.assert_array_equal(rowptr, _np(kp.seg_rowptr))
    # a node's sum belongs to the block of its first entry
    live = np.flatnonzero(np.diff(rowptr) > 0)
    owner = col[rowptr[live]] // 1024
    assert np.all(block_seg[owner] <= live)
    assert np.all(live < block_seg[owner + 1])


@pytest.mark.parametrize("rows,cols", [(16, 8), (24, 32), (128, 128)])
def test_native_router_matches_numpy(rows, cols):
    """The native router gives the NumPy oracle's tables, and the tables
    run stage by stage give ``x[perm]``."""
    perm = np.random.default_rng(rows + cols).permutation(rows * cols)
    got = tnative.benes_route(perm, rows, cols)
    want = tbenes.benes_route_rect(perm, rows, cols)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    x = np.random.default_rng(1).standard_normal((rows * cols, 3))
    np.testing.assert_array_equal(tbenes.apply_benes_rect(x, *got), x[perm])


def test_native_router_refuses_a_bad_permutation():
    with pytest.raises(ValueError):
        tnative.benes_route(np.arange(12), 4, 3)          # cols not 2^k
    with pytest.raises(ValueError):
        tnative.benes_route(np.full(16, 99), 4, 4)        # out of range


# ---------------------------------------------------------------------------
# K5 and K8 twins
# ---------------------------------------------------------------------------


def _absorb_inputs(tk, seed, d=8, order=3):
    rng = np.random.default_rng(seed)
    e = tk.e_pad
    u, q, i_t1 = (rng.standard_normal((e, d)).astype(np.float32)
                  for _ in range(3))
    parts = {1: 3, 2: 6, 3: 7}[order]
    w = (rng.standard_normal((parts * d, d)) / np.sqrt(parts * d)).astype(
        np.float32)
    b = rng.standard_normal(d).astype(np.float32)
    c1, c2 = (rng.standard_normal((e, d)).astype(np.float32)
              for _ in range(2))
    return u, q, i_t1, w, b, c1, c2


def _explicit_absorb(u, q, i_t1, w, b, pi, mask, order):
    """The absorbed interaction written out with explicit row-local
    permutes in f32 (``jnp`` at HIGHEST precision): (o1, o2) with the σ
    pads of both zeroed by ``mask``, whose VJP is the masked backward."""
    rows, cols = pi.shape
    rho = row_inverse(pi)
    d = u.shape[1]

    def rows_permute(a, p):
        g = a.reshape(rows, cols, -1)
        return jnp.take_along_axis(g, jnp.asarray(p)[:, :, None],
                                   axis=1).reshape(a.shape)

    i = rows_permute(i_t1, pi)
    parts = [u, q, i]
    if order >= 2:
        parts += [u * q, q * i, i * u]
    if order >= 3:
        parts.append(u * q * i)
    o1 = b + sum(jnp.matmul(p, w[j * d:(j + 1) * d],
                            precision=jax.lax.Precision.HIGHEST)
                 for j, p in enumerate(parts))
    o1 = o1 * mask[:, None]
    return o1, rows_permute(o1, rho)


@pytest.mark.parametrize("order", [1, 3])
def test_interact_absorb_twin_matches_explicit_formula(graphs, order):
    """K5's twin (forward and masked backward) against the explicit-permute
    formula, within 1e-5 of each output's largest value."""
    _, tg = graphs
    kp = tg.kp
    u, q, i_t1, w, b, c1, c2 = _absorb_inputs(kp, 9, order=order)
    pi, mask = _np(kp.i.p2), _np(kp.sig_mask)
    ones = np.ones_like(mask)
    want = _explicit_absorb(u, q, i_t1, w, b, pi, ones, order)
    t = [torch.from_numpy(a) for a in (u, q, i_t1, w, b, c1, c2)]
    got = interact_fwd_absorb_plain(t[0], t[1], t[2], kp.i.p2, t[3], t[4],
                                    order)
    for a, c in zip(got, want):
        np.testing.assert_allclose(_np(a), np.asarray(c), rtol=0,
                                   atol=1e-5 * np.abs(c).max())
    _, vjp = jax.vjp(lambda *a: _explicit_absorb(*a, b, pi, mask, order),
                     u, q, i_t1, w)
    want_b = vjp((jnp.asarray(c1), jnp.asarray(c2)))
    droles, dw, _ = interact_bwd_absorb_plain(t[0], t[1], t[2], kp.i.p2,
                                              t[3], t[5], t[6], kp.sig_mask,
                                              order)
    for a, c in zip((droles[0], droles[1], droles[2], dw), want_b):
        np.testing.assert_allclose(_np(a), np.asarray(c), rtol=0,
                                   atol=1e-5 * np.abs(c).max())
    pads = mask == 0
    assert (_np(droles[0])[pads] == 0).all()


def test_interact_absorb_twin_matches_pallas(graphs):
    """K5's twin against the Pallas ``fused_interaction_absorb`` in
    interpret mode (dg word tables of the JAX pack, the σ mask), forward
    and backward, within 3e-2 of each output's largest value: the Pallas
    kernel rounds MXU operands to bf16."""
    jg, tg = graphs
    jk, kp = jg.kp, tg.kp
    u, q, i_t1, w, b, c1, c2 = _absorb_inputs(kp, 10)
    args = [jnp.asarray(a.T) for a in (u, q, i_t1)]

    def f(u_, q_, i_, w_, b_):
        return fused_interaction_absorb(u_, q_, i_, w_, b_[:, None],
                                        jk.i.fwd_p2.tab, jk.i.inv_p2.tab,
                                        jk.sig_mask, 3, jk.cols)

    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(f, *args, jnp.asarray(w), jnp.asarray(b))
        grads = vjp((jnp.asarray(c1.T), jnp.asarray(c2.T)))
    t = [torch.from_numpy(a) for a in (u, q, i_t1, w, b, c1, c2)]
    got = interact_fwd_absorb_plain(t[0], t[1], t[2], kp.i.p2, t[3], t[4], 3)
    for a, c in zip(got, out):
        c = np.asarray(c).T
        np.testing.assert_allclose(_np(a), c, rtol=0,
                                   atol=3e-2 * np.abs(c).max())
    droles, dw, db = interact_bwd_absorb_plain(
        t[0], t[1], t[2], kp.i.p2, t[3], t[5], t[6], kp.sig_mask, 3)
    for a, c in zip((*droles, dw, db), (*(np.asarray(g).T for g in grads[:3]),
                                        np.asarray(grads[3]),
                                        np.asarray(grads[4]).reshape(-1))):
        np.testing.assert_allclose(_np(a), c, rtol=0,
                                   atol=3e-2 * np.abs(c).max())


def _scan_case(seed, k, n, shuffle):
    """``tests/test_segscan.py``'s id streams and values."""
    rng = np.random.default_rng(seed)
    k_pad = -(-max(k, 1) // BLOCK) * BLOCK
    ids = np.sort(rng.integers(0, n, size=k))
    if shuffle:
        for b in range(0, k - BLOCK + 1, BLOCK):
            rng.shuffle(ids[b:b + BLOCK])
    ids_pad = np.concatenate([ids, np.full(k_pad - k, 2**31 - 1, np.int64)])
    vals = rng.standard_normal((8, k_pad)).astype(np.float32)
    return ids_pad, vals


@pytest.mark.parametrize("seed,k,n,shuffle", [(0, 2500, 300, False),
                                              (1, 2500, 300, True),
                                              (2, 3072, 10, True),
                                              (3, 1000, 1500, True)])
def test_segment_scan_twin_matches_pallas(seed, k, n, shuffle):
    """K8's twin against ``csr_segment_scan_t`` in interpret mode on the
    four id patterns of ``tests/test_segscan.py`` (sorted; shuffled within
    blocks; a few segments whose runs span blocks; more segments than
    entries), at about half their sizes; its pack's sorted order lists
    every real entry once."""
    ids, vals = _scan_case(seed, k, n, shuffle)
    want = csr_segment_scan_t(jnp.asarray(vals), jpack_scan(ids, n), n,
                              interpret=True)
    pack = tpack_scan(ids, n)
    got = csr_segment_scan_plain(torch.from_numpy(vals.T.copy()), pack)
    np.testing.assert_allclose(_np(got), np.asarray(want).T, rtol=1e-4,
                               atol=1e-4)
    real = ids != SENTINEL
    np.testing.assert_array_equal(ids[_np(pack.pos)], np.sort(ids[real]))
    np.testing.assert_array_equal(np.sort(_np(pack.pos)),
                                  np.flatnonzero(real))
    assert (np.diff(_np(pack.rowptr)) > 0).sum() == len(np.unique(ids[real]))


def test_segment_scan_pack_refuses_an_unsorted_stream():
    ids = np.concatenate([np.full(BLOCK, 5), np.full(BLOCK, 2)])
    with pytest.raises(ValueError):
        tpack_scan(ids, 10)


def test_routed_node_sums_match_segment_sum(graphs):
    """K1's three-region twin over the pack's CSR is the segment-sum of the
    [u | q | i] stream over its ids, sentinels dropped."""
    _, tg = graphs
    kp = tg.kp
    rng = np.random.default_rng(11)
    stream = torch.from_numpy(rng.standard_normal(
        (3 * kp.e_pad, 4)).astype(np.float32))
    ids = kp.seg_ids.long()
    real = ids != SENTINEL
    want = segment_sum(stream[real], ids[real], N)
    got = csr_gather_sum_plain(stream, kp.seg_col, kp.seg_rowptr)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)


def test_sigma_to_edge_order(graphs):
    """σ position (r, sig[r, c]) holds edge (r, c); the gradient puts each
    edge's cotangent back and leaves the pads at 0."""
    _, tg = graphs
    kp = tg.kp
    rng = np.random.default_rng(8)
    edge = torch.from_numpy(rng.standard_normal((kp.e_pad, 4)).astype(
        np.float32)).requires_grad_()
    pos = (np.arange(kp.rows)[:, None] * kp.cols + _np(kp.sig)).reshape(-1)
    got = sigma_to_edge_order(edge, kp)
    np.testing.assert_array_equal(_np(got), _np(edge)[pos[:P]])
    cot = torch.from_numpy(rng.standard_normal((P, 4)).astype(np.float32))
    got.backward(cot)
    want = np.zeros((kp.e_pad, 4), np.float32)
    want[pos[:P]] = cot.numpy()
    np.testing.assert_array_equal(_np(edge.grad), want)
