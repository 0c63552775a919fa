"""The redesigned kernels' arithmetic and host-side rules, on the CPU.

* ``interact_bwd`` runs both of its products on the tensor cores in
  3xTF32 (``csrc/interact_bwd.cu`` ``split_tf32``): each f32 operand is
  split into ``hi`` (x rounded to 11 significant bits by Veltkamp's
  split) and ``lo = x - hi``, of which the tensor cores read the leading
  11 bits, and a product is ``hi·hi + hi·lo + lo·hi``. The tests emulate
  that split in plain PyTorch, the tensor cores' reading of ``lo`` by
  masking its low 13 mantissa bits, and hold the emulated backward, at
  the train step's shapes (d = out = 32, orders 3 and 1), against the
  float64 product and against ``jax.vjp`` of the JAX
  ``FeatureInteractor``; plain TF32 (``hi`` alone) misses the same limit
  on rows of magnitude 1e3.
* K3 ``interact_fwd`` and K5's forward ``interact_fwd_absorb`` run their
  product, parts [E, parts·d] by W, the same way (``csrc/interact.cu``,
  the tensor-core form): the emulated forward at orders 1–3 (d = out =
  32) is held against the float64 product and against the JAX
  ``FeatureInteractor`` forward (XLA), and its π-read form against
  float64 and the Pallas ``interact_fwd_absorb`` in interpret mode.
* K5's backward ``interact_bwd_absorb`` is ``interact_bwd``'s fused
  kernel reading i and c2 through π: the emulated form (i_t1[e_π], the
  merged cotangent (c1 + c2[e_π])·mask, the 3xTF32 products, di stored at
  e_π) at orders 1–3, masked and unmasked, is held against float64 and
  the Pallas ``interact_bwd_absorb`` in interpret mode.
* The scalar segment sum (``csrc/segmax.cu``) adds long segments in a
  block order, not in entry order: ``csr_segment_sum_ordered`` (that
  order on the CPU) is held against float64 and the Pallas
  ``csr_segment_sum_t`` in interpret mode, on degree mixes with empty
  segments, segments longer than the kernel's block threshold and its
  shared-memory window, and runs of segments that cross its blocks.
* K1's fixed-width form (the scatter's backward, 3 entries an edge) and
  the rule that picks K1's vector form from the width and the alignment.
* The build hash covers the shared headers ``csrc/*.cuh``.

Tolerances: the emulated 3xTF32 products within 1e-6 of each output's
largest value from the float64 product (the split keeps about 22 bits of
each operand; f32 sums over 32 to 224 terms), and within 1e-5 from JAX's
f32 XLA results (``tests/test_torch_train.py``'s limit); plain TF32 is
shown to exceed 1e-4 (the card tests' limit) on the large rows. The π
form against the Pallas kernel: 3e-2 of the largest value, because that
kernel rounds its MXU operands to bf16 (``tests/test_torch_routed.py``);
the absorbed backward within 1e-5 of each output's largest value from
float64 (its dW sums 16k edges). The ordered segment sum within 1e-5 of
the largest |sum| from float64, and 2e-5 from the Pallas kernel, whose
own error from float64 reaches 1.04e-5 on a 9001-entry segment.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ihgnn_torch.graph import build_hypergraph
from ihgnn_torch.ops import _build
from ihgnn_torch.ops.hyperagg import SpmmFn
from ihgnn_torch.ops.hyperagg import make_hyper_ops as torch_hyper_ops
from ihgnn_torch.ops.interact import (CHUNK_EDGES, ORDER_PARTS,
                                      interact_bwd, interact_bwd_absorb,
                                      interact_fwd, interact_fwd_absorb,
                                      interact_parts)
from ihgnn_torch.ops.segmax import (BLOCK_THREADS, LONG_SEGMENT,
                                    csr_segment_sum_ordered,
                                    csr_segment_sum_plain)
from ihgnn_torch.ops.segsum import (csr_gather_sum, csr_gather_sum_plain,
                                    vector_form)
from ihgnn_tpu import graph as jgraph
from ihgnn_tpu.data.synthetic import make_synthetic_data
from ihgnn_tpu.models.interaction import FeatureInteractor
from ihgnn_tpu.ops.hyperagg import make_hyper_ops, strip_kernel_packing
from ihgnn_tpu.ops.pallas.interact import \
    interact_bwd_absorb as pallas_bwd_absorb
from ihgnn_tpu.ops.pallas.interact import \
    interact_fwd_absorb as pallas_fwd_absorb
from ihgnn_tpu.ops.pallas.segsum import (csr_segment_sum as pallas_segsum,
                                         prepare_segment_inputs)

D = OUT = 32


def _tensor_core_view(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a TF32 operand of the tensor cores: its low 13 mantissa
    bits ignored."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _split(x: torch.Tensor):
    """``split_tf32``: Veltkamp's split of f32 ``x`` at 11 significant
    bits (f32 elementwise operations round as the kernel's _rn steps)."""
    c = x * 8193.0
    hi = c - (c - x)
    assert torch.equal(_tensor_core_view(hi), hi)
    return hi, _tensor_core_view(x - hi)


def _mm(a: torch.Tensor, b: torch.Tensor, terms: int) -> torch.Tensor:
    """``a @ b`` from TF32 operands, summed in f32: 3 terms (3xTF32) or 1
    (plain TF32). Each TF32 product is exact in f64."""
    ah, al = _split(a)
    bh, bl = _split(b)
    pairs = [(ah, bl), (al, bh), (ah, bh)] if terms == 3 else [(ah, bh)]
    out = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for x, y in pairs:
        out = out + (x.double() @ y.double()).float()
    return out


def _emulated_bwd(u, q, i, w, cot, order, terms):
    """``interact_bwd`` as the fused kernel computes it: dparts by the
    split product, the product rule in f32, dW over each CHUNK_EDGES chunk
    by the split product, the chunks summed in order."""
    parts = interact_parts(u, q, i, order)
    dparts = [_mm(cot, w[j * D:(j + 1) * D].t(), terms)
              for j in range(len(parts))]
    du, dq, di = dparts[0], dparts[1], dparts[2]
    if order >= 2:
        du = du + (dparts[3] * q + dparts[5] * i)
        dq = dq + (dparts[3] * u + dparts[4] * i)
        di = di + (dparts[4] * q + dparts[5] * u)
    if order >= 3:
        du = du + dparts[6] * (q * i)
        dq = dq + dparts[6] * (u * i)
        di = di + dparts[6] * (u * q)
    stacked = torch.cat(parts, dim=1)
    dw = torch.zeros(stacked.shape[1], OUT)
    for c in range(0, u.shape[0], CHUNK_EDGES):
        dw = dw + _mm(stacked[c:c + CHUNK_EDGES].t().contiguous(),
                      cot[c:c + CHUNK_EDGES], terms)
    return (du, dq, di, dw, cot.sum(0))


def _f64_bwd(u, q, i, w, cot, order):
    u, q, i, w, cot = (t.double() for t in (u, q, i, w, cot))
    droles, dw, db = interact_bwd(u, q, i, w, cot, order)
    return (*droles, dw, db)


def _inputs(e, order, scale, seed):
    rng = np.random.default_rng(seed)
    u, q, i = (rng.standard_normal((e, D)).astype(np.float32)
               for _ in range(3))
    u *= scale
    parts = ORDER_PARTS[order]
    w = (rng.standard_normal((parts * D, OUT)) / np.sqrt(parts * D)).astype(
        np.float32)
    cot = rng.standard_normal((e, OUT)).astype(np.float32)
    return u, q, i, w, cot


def _max_rel_err(got, want):
    return max(((g.double() - r).abs().max() / r.abs().max()).item()
               for g, r in zip(got, want))


@pytest.mark.parametrize("order", [3, 1])
@pytest.mark.parametrize("scale", [1.0, 1e3])
def test_3xtf32_backward_matches_float64(order, scale):
    """At the step's shapes, with one role's rows at 1 or 1e3: the emulated
    3xTF32 backward within 1e-6 of float64; plain TF32 off by more than
    1e-4 on the large rows."""
    e = CHUNK_EDGES + 301                     # two chunks, a ragged one
    u, q, i, w, cot = (torch.from_numpy(a)
                       for a in _inputs(e, order, scale, 7 + order))
    want = _f64_bwd(u, q, i, w, cot, order)
    assert _max_rel_err(_emulated_bwd(u, q, i, w, cot, order, 3),
                        want) < 1e-6
    if scale > 1:
        assert _max_rel_err(_emulated_bwd(u, q, i, w, cot, order, 1),
                            want) > 1e-4


@pytest.mark.parametrize("order", [3, 1])
def test_3xtf32_backward_matches_jax_grad(order):
    """The emulated 3xTF32 backward against ``jax.vjp`` of the f32 XLA
    ``FeatureInteractor`` (d = out = 32), as the port's twin is held."""
    e = 700
    u, q, i, _, cot = _inputs(e, order, 1.0, 20 + order)
    roles_t = tuple(jnp.asarray(a.T) for a in (u, q, i))
    mod = FeatureInteractor(order, D, OUT)
    params = mod.init(jax.random.key(order), roles_t, fused_ok=False)
    _, vjp = jax.vjp(lambda p, r: mod.apply(p, r, fused_ok=False), params,
                     roles_t)
    dparams, droles = vjp(jnp.asarray(cot.T))
    dense = dparams["params"]["aggregation"]["dense"]
    w = np.array(params["params"]["aggregation"]["dense"]["kernel"])
    got = _emulated_bwd(*(torch.from_numpy(a) for a in (u, q, i, w, cot)),
                        order, 3)
    want = [np.asarray(r).T for r in droles] + [np.asarray(dense["kernel"]),
                                                np.asarray(dense["bias"])]
    for name, g, r in zip(("du", "dq", "di", "dw", "db"), got, want):
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-5,
                                   atol=1e-5 * np.abs(r).max(), err_msg=name)


# ---------------------------------------------------------------------------
# K3 and K5's forward: the product parts . W in 3xTF32
# ---------------------------------------------------------------------------


def _emulated_fwd(u, q, i, w, b, order, terms):
    """``interact_fwd`` as the tensor-core form computes it: the parts
    formed in f32, then one split product [E, parts·d] by W, plus b."""
    stacked = torch.cat(interact_parts(u, q, i, order), dim=1)
    return _mm(stacked, w, terms) + b


def _fwd_inputs(e, order, scale, seed):
    u, q, i, w, _ = _inputs(e, order, scale, seed)
    b = np.random.default_rng(seed + 1).standard_normal(OUT).astype(
        np.float32)
    return u, q, i, w, b


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("scale", [1.0, 1e3])
def test_3xtf32_forward_matches_float64(order, scale):
    """The emulated 3xTF32 forward, one role's rows at 1 or 1e3, within
    1e-6 of float64 (``interact_fwd``'s twin on float64 tensors); plain
    TF32 off by more than 1e-4 on the large rows."""
    u, q, i, w, b = (torch.from_numpy(a)
                     for a in _fwd_inputs(777, order, scale, 40 + order))
    want = interact_fwd(*(t.double() for t in (u, q, i, w, b)), order)
    got = _emulated_fwd(u, q, i, w, b, order, 3)
    assert _max_rel_err([got], [want]) < 1e-6
    if scale > 1:
        assert _max_rel_err([_emulated_fwd(u, q, i, w, b, order, 1)],
                            [want]) > 1e-4


@pytest.mark.parametrize("order", [1, 2, 3])
def test_3xtf32_forward_matches_jax(order):
    """The emulated 3xTF32 forward against the f32 XLA
    ``FeatureInteractor`` (d = out = 32) with the module's own weights."""
    u, q, i, _, _ = _fwd_inputs(600, order, 1.0, 50 + order)
    roles_t = tuple(jnp.asarray(a.T) for a in (u, q, i))
    mod = FeatureInteractor(order, D, OUT)
    params = mod.init(jax.random.key(10 + order), roles_t, fused_ok=False)
    want = np.asarray(mod.apply(params, roles_t, fused_ok=False)).T
    dense = params["params"]["aggregation"]["dense"]
    w, b = (torch.from_numpy(np.array(dense[k])) for k in ("kernel", "bias"))
    got = _emulated_fwd(*(torch.from_numpy(a) for a in (u, q, i)), w, b,
                        order, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.fixture(scope="module")
def packed():
    """(JAX packed graph, the port's packed graph) of 400 random edges on
    a 128 x 128 grid, as ``tests/test_torch_routed.py`` builds them."""
    users, queries, items = 40, 25, 60
    rng = np.random.default_rng(3)
    uqi = np.stack([rng.integers(0, users, 400),
                    rng.integers(0, queries, 400),
                    rng.integers(0, items, 400)], axis=1)
    n = users + queries + items
    return (jgraph.build_hypergraph(uqi, n, users, queries),
            build_hypergraph(uqi, n, users, queries, pack_kernels=True))


@pytest.mark.parametrize("order", [3, 1])
def test_3xtf32_forward_absorb(packed, order):
    """The π-read form: i read at e_π = r·C + π[r, c], o2[e_π] = o1[e].
    Emulated in 3xTF32 within 1e-6 of float64 (K5's twin on float64
    tensors), and within 3e-2 of the Pallas ``interact_fwd_absorb`` in
    interpret mode (bf16 MXU operands)."""
    jk, kp = packed[0].kp, packed[1].kp
    e = kp.e_pad
    u, q, i_t1, w, b = _fwd_inputs(e, order, 1.0, 60 + order)
    t = [torch.from_numpy(a) for a in (u, q, i_t1, w, b)]
    rows, cols = kp.i.p2.shape
    e_pi = (torch.arange(rows)[:, None] * cols + kp.i.p2.long()).reshape(-1)
    o1 = _emulated_fwd(t[0], t[1], t[2][e_pi], t[3], t[4], order, 3)
    o2 = torch.empty_like(o1)
    o2[e_pi] = o1
    want = interact_fwd_absorb(t[0].double(), t[1].double(), t[2].double(),
                               kp.i.p2, t[3].double(), t[4].double(), order)
    assert _max_rel_err([o1, o2], want) < 1e-6
    pallas = pallas_fwd_absorb(
        *(jnp.asarray(a.T) for a in (u, q, i_t1)), jk.i.fwd_p2.tab,
        jk.i.inv_p2.tab, jnp.asarray(w), jnp.asarray(b)[:, None], order,
        jk.cols, interpret=True)
    for got, ref in zip((o1, o2), pallas):
        ref = np.asarray(ref).T
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=3e-2 * np.abs(ref).max())


def _emulated_bwd_absorb(u, q, i_t1, pi, w, c1, c2, mask, order):
    """``interact_bwd_absorb`` as the fused kernel computes it under
    ABSORB: the i row and the c2 row read at e_π = r·C + π[r, c], the
    cotangent merged once as (c1 + c2[e_π])·mask (an f32 add, then an f32
    multiply), the 3xTF32 backward on it, di stored at row e_π."""
    rows, cols = pi.shape
    e_pi = (torch.arange(rows)[:, None] * cols + pi.long()).reshape(-1)
    cot = c1 + c2[e_pi]
    if mask is not None:
        cot = cot * mask[:, None]
    du, dq, di, dw, db = _emulated_bwd(u, q, i_t1[e_pi], w, cot, order, 3)
    di_t1 = torch.empty_like(di)
    di_t1[e_pi] = di
    return du, dq, di_t1, dw, db


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("masked", [False, True])
def test_3xtf32_backward_absorb(packed, order, masked):
    """K5's backward, emulated, on the 128 x 128 packed grid (16384 edges,
    the pack's σ mask or none): within 1e-5 of float64 (K5's twin on
    float64 tensors), within 3e-2 of the Pallas ``interact_bwd_absorb`` in
    interpret mode (bf16 MXU operands); σ pads reach no du or dq."""
    jk, kp = packed[0].kp, packed[1].kp
    e = kp.e_pad
    u, q, i_t1, w, _ = _inputs(e, order, 1.0, 70 + order)
    rng = np.random.default_rng(80 + order)
    c1, c2 = (rng.standard_normal((e, OUT)).astype(np.float32)
              for _ in range(2))
    mask = kp.sig_mask if masked else None
    t = [torch.from_numpy(a) for a in (u, q, i_t1, w, c1, c2)]
    got = _emulated_bwd_absorb(*t[:3], kp.i.p2, *t[3:], mask, order)
    droles, dw, db = interact_bwd_absorb(
        *(x.double() for x in t[:3]), kp.i.p2, *(x.double() for x in t[3:]),
        None if mask is None else mask.double(), order)
    want = (*droles, dw, db)
    for name, g, r in zip(("du", "dq", "di_t1", "dw", "db"), got, want):
        assert ((g.double() - r).abs().max() / r.abs().max()).item() < 1e-5, \
            name
    if masked:
        pads = mask == 0
        assert pads.any() and (got[0][pads] == 0).all() \
            and (got[1][pads] == 0).all()
    pallas = pallas_bwd_absorb(
        *(jnp.asarray(a.T) for a in (u, q, i_t1)), jk.i.fwd_p2.tab,
        jk.i.inv_p2.tab, jnp.asarray(w), jnp.asarray(c1.T),
        jnp.asarray(c2.T),
        None if mask is None else jnp.asarray(mask.numpy()[None, :]), order,
        jk.cols, interpret=True)
    refs = [np.asarray(r).T for r in pallas[:3]] + [
        np.asarray(pallas[3]), np.asarray(pallas[4]).reshape(-1)]
    for name, g, r in zip(("du", "dq", "di_t1", "dw", "db"), got, refs):
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=3e-2 * np.abs(r).max(), err_msg=name)


# ---------------------------------------------------------------------------
# the scalar segment sum's order of adds
# ---------------------------------------------------------------------------


def _degree_mix(case: str, rng) -> np.ndarray:
    """Segment lengths: short and empty ones, with long ones among them."""
    counts = rng.integers(0, 40, 1500)
    counts[rng.random(1500) < 0.3] = 0
    if case == "long":             # past the block threshold, and a window
        counts[[3, 400, 401, 1499]] = (LONG_SEGMENT + 1, 9001, 2 * LONG_SEGMENT
                                       + 3, 777)
    elif case == "straddle":       # runs of near-threshold segments
        counts[BLOCK_THREADS - 40:2 * BLOCK_THREADS + 40] = rng.integers(
            LONG_SEGMENT - 60, LONG_SEGMENT + 1, BLOCK_THREADS + 80)
    return counts


@pytest.mark.parametrize("case", ["short", "long", "straddle"])
def test_segment_sum_order_matches_float64_and_pallas(case):
    """``csr_segment_sum_ordered`` (the kernel's order) within 1e-5 of the
    largest |sum| from the float64 sum, and within 2e-5 from the Pallas
    ``csr_segment_sum_t`` in interpret mode, which is itself 1.04e-5 of
    the largest sum off float64 on the 9001-entry segment; on short
    segments it is the sequential f32 sum, which the twin's
    ``index_add_`` also gives."""
    rng = np.random.default_rng({"short": 1, "long": 2, "straddle": 3}[case])
    counts = _degree_mix(case, rng)
    rowptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    v = rng.standard_normal(int(rowptr[-1])).astype(np.float32)
    got = csr_segment_sum_ordered(torch.from_numpy(v),
                                  torch.from_numpy(rowptr)).numpy()
    want = np.add.reduceat(np.append(v.astype(np.float64), 0.0),
                           rowptr[:-1]) * (counts > 0)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    ids = np.repeat(np.arange(len(counts)), counts)
    vals, ids2d, ptr = prepare_segment_inputs(jnp.asarray(v[:, None]), ids,
                                              len(counts))
    ref = np.asarray(pallas_segsum(vals, ids2d, ptr, len(counts),
                                   interpret=True))[:, 0]
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5 * scale)
    short = counts <= LONG_SEGMENT
    plain = csr_segment_sum_plain(torch.from_numpy(v),
                                  torch.from_numpy(rowptr)).numpy()
    np.testing.assert_array_equal(got[short], plain[short])


# ---------------------------------------------------------------------------
# K1: the fixed-width form and the choice of form
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def graphs():
    data = make_synthetic_data(user_count=20, query_count=12, item_count=30,
                               vocab_size=25, log_count=150, seed=0)
    return strip_kernel_packing(data.hypergraph), build_hypergraph(
        data.pos_uqif, data.node_count, data.user_count, data.query_count)


def test_scatter_fixed_width_grad_matches_jax(graphs):
    """The direct scatter's backward takes K1's fixed-width form (3 entries
    an edge): its gradient equals JAX's, and ``SpmmFn`` gives the same
    gradient with and without the width."""
    jg, tg = graphs
    rng = np.random.default_rng(4)
    edge = rng.standard_normal((jg.edge_count, 8)).astype(np.float32)
    cot = rng.standard_normal((jg.node_count, 8)).astype(np.float32)
    _, scatter_x = make_hyper_ops(jg)
    ref = np.asarray(jax.grad(lambda e_t: jnp.sum(
        scatter_x(e_t) * jnp.asarray(cot.T)))(jnp.asarray(edge.T))).T
    _, scatter = torch_hyper_ops(tg)
    grads = []
    for fn in (scatter,
               lambda e: SpmmFn.apply(e, tg.inc_edge, tg.rowptr, None,
                                      tg.i3.view(-1), tg.edge_rowptr, None)):
        et = torch.from_numpy(edge).requires_grad_()
        (fn(et) * torch.from_numpy(cot)).sum().backward()
        grads.append(et.grad)
    np.testing.assert_allclose(grads[0].numpy(), ref, rtol=1e-5, atol=1e-5)
    assert torch.equal(grads[0], grads[1])


def test_csr_gather_sum_width_is_checked(graphs):
    _, tg = graphs
    x = torch.randn(tg.node_count, 8,
                    generator=torch.Generator().manual_seed(1))
    col, rowptr = tg.i3.view(-1), tg.edge_rowptr
    assert torch.equal(csr_gather_sum(x, col, rowptr, width=3),
                       csr_gather_sum_plain(x, col, rowptr))
    for bad in (0, 2, 4):
        with pytest.raises(ValueError):
            csr_gather_sum(x, col, rowptr, width=bad)


def test_vector_form_rule():
    """K1's vector form takes d % 4 == 0 and 16-byte aligned rows; any
    other d or alignment takes the scalar form."""
    x = torch.zeros(10, 32)
    assert x.data_ptr() % 16 == 0
    assert vector_form(32, x) and vector_form(4, x[1:])
    assert not vector_form(6, torch.zeros(10, 6))
    shifted = torch.zeros(321)[1:].view(10, 32)
    assert shifted.is_contiguous() and not vector_form(32, shifted)
    assert not vector_form(32, x, shifted)


# ---------------------------------------------------------------------------
# the build hash
# ---------------------------------------------------------------------------


def test_library_path_covers_headers(tmp_path):
    """An edit to a shared header (``tf32.cuh``) names a new library for
    every source, so no stale build survives it; an edit elsewhere in
    the directory does not."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for src in _build.CSRC.iterdir():
        if src.suffix in (".cu", ".cuh"):
            (csrc / src.name).write_bytes(src.read_bytes())
    assert (csrc / "tf32.cuh").exists()
    before = {stem: _build.library_path(stem, csrc)
              for stem in _build.SOURCES}
    assert before["interact"] == _build.library_path("interact")
    (csrc / "notes.txt").write_text("not a source")
    assert {s: _build.library_path(s, csrc) for s in _build.SOURCES} == before
    header = csrc / "tf32.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {stem: _build.library_path(stem, csrc)
             for stem in _build.SOURCES}
    assert all(after[s] != before[s] for s in _build.SOURCES)
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _build.library_path("interact", csrc) != after["interact"]
