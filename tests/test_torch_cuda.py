"""The CUDA kernels of ``ihgnn_torch`` against their plain PyTorch twins, on
the card, at shapes the main paths do not reach: other widths d, ragged
edge counts, empty segments, every interaction order and output width,
the wrappers' refusals, and the autograd Functions' gradients on the card
against the same Functions on the CPU.

Needs a CUDA card and nvcc; every test is marked ``cuda`` and skips
without a card. On the machine with the card (which has no JAX, so the
repository's conftest is left out):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

The routed path's kernels (K6/K7 permutes, K2's single-index forms, K1's
three-region form, K5, K8) and Functions are covered at the end, then the
bf16 forms, then the chunked pack (K1's three-region form over a CSR that
spans the chunks, ``csr_segment_sum3_multi``'s counterpart, in f32 and
bf16, with regions past 2^31 bytes; the chunked Functions) and the routed
2D graph (K2's d = 1 form ``gather_scalars``, ``RoutedSpmmFn``,
``RoutedGatConvFn``). Before them, the bf16 forms: K2, K1, K3 and ``interact_bwd`` (the direct path's), and the
routed pack's (``gather_rows[_t]``, the three-region K1, K5 and K8) with
the routed Functions on bf16 streams. K3's
forward (and K5's) has two forms, the tensor-core form (3xTF32 on staged
edge tiles) and the f32-core form; both are held at every order and
output width, on ragged edge counts and on rows of magnitude 1e3.

Tolerances: K2, K6/K7 are copies and K4 a max, all bitwise exact; K1, K3, the
scalar segment sum and ``csr_edge_dot`` sum in another order than the
twins, 1e-5 absolute (K1, the scalar sum) and 1e-5 of the largest output
(K3, ``csr_edge_dot``); K1 on long segments against float64, 2e-6 a term.
``interact_bwd``'s dW and db sum every edge in another order than the
twin's matmuls, on the tensor cores in 3xTF32: 1e-4 of each output's
largest value; so do K5's. K5's backward is ``interact_bwd``'s fused
kernel reading i and c2 through π, so it is also held bit for bit to
``interact_bwd`` on the pre-permuted inputs; the scalar segment sum is
held bit for bit to ``csr_segment_sum_ordered`` (its order of adds on the
CPU) and K4 to its twin.
K1 launched with a CSR's long segments (a block a hub) is held bit for
bit to K1 launched without them, and so are the node update and the
gather's backward of a hypergraph with hubs.
K8 sums each segment in stream order, as K1 does over the same entries:
bitwise equal to K1, 1e-5 of the largest run length from its twin.
``csr_edge_dot`` is also held bit for bit to a second run of itself. Values and
gradients of a small graph on the card against the CPU: 1e-5 of each
tensor's largest value (dW sums 400 edges of products of three normals);
the attention score head's kernel and bias, whose gradients are sums that
nearly cancel (the softmax ignores a per-destination shift), within 1e-5
of the largest gradient of x.
"""

import dataclasses

import pytest
import torch

import numpy as np

from ihgnn_torch.config import V
from ihgnn_torch.graph import (build_attention_csr, build_graph2d,
                               build_hypergraph, build_log_hypergraph)
from ihgnn_torch.ops.bag import BagMeanFn, make_word_bag
from ihgnn_torch.ops.edgedot import (CHUNK, csr_edge_dot, csr_edge_dot_plain,
                                     edge_dot_order)
from ihgnn_torch.ops.gatconv import GatConvFn
from ihgnn_torch.ops.gather import (gather_roles, gather_roles_plain,
                                   gather_rows, gather_rows_plain,
                                   gather_rows_t, round_bf16)
from ihgnn_torch.ops.hyperagg import (make_hyper_ops, make_log_ops,
                                      make_spmm_op, sigma_to_edge_order)
from ihgnn_torch.ops.interact import (CHUNK_EDGES, KERNEL_OUT_DIMS,
                                      ORDER_PARTS,
                                      InteractAbsorbFn, InteractFn,
                                      interact_bwd, interact_bwd_absorb,
                                      interact_bwd_absorb_plain,
                                      interact_bwd_absorb_via_direct,
                                      interact_bwd_plain, interact_fwd,
                                      interact_fwd_absorb,
                                      interact_fwd_absorb_cores,
                                      interact_fwd_absorb_plain,
                                      interact_fwd_cores, interact_fwd_form,
                                      interact_fwd_plain)
from ihgnn_torch.ops.permute import (row_local_permute,
                                     row_local_permute_plain,
                                     transposed_local_permute,
                                     transposed_local_permute_plain)
from ihgnn_torch.ops.segmax import (EMPTY_MAX, LONG_SEGMENT,
                                    csr_segment_max, csr_segment_max_plain,
                                    csr_segment_sum, csr_segment_sum_ordered,
                                    csr_segment_sum_plain)
from ihgnn_torch.ops.segscan import BLOCK as SCAN_BLOCK
from ihgnn_torch.ops.segscan import (csr_segment_scan, csr_segment_scan_plain,
                                     pack_scan_inputs)
from ihgnn_torch.ops.segsum import (LONG_ENTRIES, LongSegments, bf16_form,
                                    csr_gather_sum, csr_gather_sum_plain,
                                    csr_segment_sum3, csr_segment_sum3_plain,
                                    long_segments, vector_form)
from ihgnn_torch.utils import tracing

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


def rows_at(x, offset_bytes):
    """A contiguous copy of ``x`` whose data begins ``offset_bytes`` past a
    16-byte boundary (a row view aligned to 8 bytes only, for 8)."""
    n = offset_bytes // x.element_size()
    buf = torch.empty(x.numel() + n, dtype=x.dtype, device=x.device)
    view = buf[n:].view(x.shape)
    view.copy_(x)
    return view


def _csr(dev, segments, rows, entries, seed):
    """A random CSR in which every 7th segment is empty."""
    g = _gen(dev, seed)
    ids = torch.randint(0, segments, (entries,), device=dev, generator=g)
    ids = ids[ids % 7 != 0].sort().values
    col = torch.randint(0, rows, (ids.numel(),), device=dev, generator=g)
    counts = torch.bincount(ids, minlength=segments)
    rowptr = torch.zeros(segments + 1, dtype=torch.int64, device=dev)
    rowptr[1:] = counts.cumsum(0)
    return col.int(), rowptr.int()


@pytest.mark.parametrize("d", [4, 16, 32, 48, 96])
@pytest.mark.parametrize("weighted", [False, True])
def test_csr_gather_sum(dev, d, weighted):
    segments, rows, entries = 1000, 300, 7000
    col, rowptr = _csr(dev, segments, rows, entries, seed=d)
    g = _gen(dev, 100 + d)
    x = torch.randn(rows, d, device=dev, generator=g)
    w = (torch.rand(col.numel(), device=dev, generator=g) if weighted
         else None)
    before = csr_gather_sum.launches
    got = csr_gather_sum(x, col, rowptr, w)
    torch.cuda.synchronize()
    assert csr_gather_sum.launches == before + 1
    want = csr_gather_sum_plain(x, col, rowptr, w)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    empty = (rowptr[1:] == rowptr[:-1])
    assert empty.any() and (got[empty] == 0).all()


def test_csr_gather_sum_long_segment_is_deterministic(dev):
    """One segment of 100k entries: the kernel sums in entry order, so two
    runs agree bit for bit."""
    g = _gen(dev, 1)
    x = torch.randn(5000, 32, device=dev, generator=g)
    col = torch.randint(0, 5000, (100_000,), device=dev, generator=g).int()
    rowptr = torch.tensor([0, 0, 100_000, 100_000], device=dev).int()
    a = csr_gather_sum(x, col, rowptr)
    b = csr_gather_sum(x, col, rowptr)
    assert torch.equal(a, b)
    # a sequential f32 sum of 1e5 unit normals drifts by about 1e-2 from
    # the exact sum
    exact = x.double()[col.long()].sum(0).float()
    assert (a[0] == 0).all() and (a[2] == 0).all()
    torch.testing.assert_close(a[1], exact, rtol=0, atol=5e-2)


def _mixed_csr(dev, rows, seed):
    """A CSR whose segments have 0, 1, 3, 7, 8, 9, 33 and 5000 entries,
    mixed in one order, each length several times."""
    rng = np.random.default_rng(seed)
    lengths = rng.permutation(np.repeat([0, 1, 3, 7, 8, 9, 33, 5000], 5))
    rowptr = np.concatenate([[0], np.cumsum(lengths)])
    col = rng.integers(0, rows, rowptr[-1])
    return (torch.from_numpy(col).int().to(dev),
            torch.from_numpy(rowptr).int().to(dev), lengths)


@pytest.mark.parametrize("d", [32, 48, 8])
@pytest.mark.parametrize("weighted", [False, True])
def test_csr_gather_sum_mixed_segment_lengths(dev, d, weighted):
    """Short and long segments in one launch, against float64: each
    segment within 2e-6 a term of its length (an f32 sum in entry order);
    two launches agree bit for bit."""
    col, rowptr, lengths = _mixed_csr(dev, 3000, d)
    g = _gen(dev, 200 + d)
    x = torch.randn(3000, d, device=dev, generator=g)
    w = (torch.rand(col.numel(), device=dev, generator=g) if weighted
         else None)
    before = csr_gather_sum.launches
    got = csr_gather_sum(x, col, rowptr, w)
    again = csr_gather_sum(x, col, rowptr, w)
    torch.cuda.synchronize()
    assert csr_gather_sum.launches == before + 2
    assert torch.equal(got, again)
    exact = csr_gather_sum_plain(x.double(), col, rowptr,
                                 None if w is None else w.double())
    tol = torch.from_numpy(2e-6 * lengths + 1e-6).to(dev)[:, None]
    assert ((got.double() - exact).abs() <= tol).all()
    assert (got[torch.from_numpy(lengths == 0).to(dev)] == 0).all()


@pytest.mark.parametrize("d", [5, 32])
def test_csr_gather_sum_scalar_form(dev, d):
    """The scalar form (d % 4 != 0, or rows that are not 16-byte aligned)
    gives the vector form's bits."""
    col, rowptr = _csr(dev, 500, 300, 4000, seed=d)
    base = torch.randn(300 * d + 1, device=dev, generator=_gen(dev, d))
    x = base[1:].view(300, d)
    assert not vector_form(d, x)
    got = csr_gather_sum(x, col, rowptr)
    torch.testing.assert_close(got, csr_gather_sum_plain(x, col, rowptr),
                               rtol=0, atol=1e-5)
    if d % 4 == 0:
        assert torch.equal(got, csr_gather_sum(x.clone(), col, rowptr))


def test_csr_gather_sum_fixed_width(dev):
    """The scatter's backward form (3 entries a segment, no rowptr read):
    bitwise the CSR form's result."""
    g = _gen(dev, 9)
    x = torch.randn(777, 32, device=dev, generator=g)
    col = torch.randint(0, 777, (3 * 5001,), device=dev, generator=g).int()
    rowptr = torch.arange(0, 3 * 5001 + 1, 3, device=dev).int()
    before = csr_gather_sum.launches
    got = csr_gather_sum(x, col, rowptr, width=3)
    torch.cuda.synchronize()
    assert csr_gather_sum.launches == before + 1
    assert torch.equal(got, csr_gather_sum(x, col, rowptr))
    torch.testing.assert_close(got, csr_gather_sum_plain(x, col, rowptr),
                               rtol=0, atol=1e-5)


def _long_csr(dev, rows, seed, every_long=False):
    """(col, rowptr, lengths) of a CSR whose segments have 0, 1, 9,
    LONG_ENTRIES, LONG_ENTRIES + 1 and 3000-9000 entries in one order;
    with ``every_long``, only the last two kinds."""
    rng = np.random.default_rng(seed)
    lengths = np.concatenate([[LONG_ENTRIES + 1] * 3,
                              rng.integers(3000, 9001, 4)])
    if not every_long:
        lengths = np.concatenate([np.repeat([0, 1, 9], 40),
                                  [LONG_ENTRIES] * 3, lengths])
    lengths = rng.permutation(lengths)
    rowptr = np.concatenate([[0], np.cumsum(lengths)])
    col = rng.integers(0, rows, rowptr[-1])
    return (torch.from_numpy(col).int().to(dev),
            torch.from_numpy(rowptr).int().to(dev), lengths)


def _counters():
    return (csr_gather_sum.launches,
            tracing.COUNTERS.get("k1.long_segments", 0),
            tracing.COUNTERS.get("k1.long_entries", 0))


@pytest.mark.parametrize("d", [8, 32, 48, 1040])
@pytest.mark.parametrize("weighted", [False, True])
def test_csr_gather_sum_long_segments(dev, d, weighted):
    """Hubs summed by a block each: the launch with the CSR's long
    segments gives the bits of the launch without them (segments of
    LONG_ENTRIES entries stay with their groups, those of one more go to
    their blocks, empty ones are zero; d = 1040 runs the block in three
    feature chunks); one launch, counted with its segments and entries."""
    col, rowptr, lengths = _long_csr(dev, 2000, d)
    hubs = long_segments(rowptr.cpu())
    assert hubs.ids.numel() == (lengths > LONG_ENTRIES).sum() == 7
    g = _gen(dev, 300 + d)
    x = torch.randn(2000, d, device=dev, generator=g)
    w = (torch.rand(col.numel(), device=dev, generator=g) if weighted
         else None)
    want = csr_gather_sum(x, col, rowptr, w)
    before = _counters()
    got = csr_gather_sum(x, col, rowptr, w, long_segments=hubs.to(dev))
    torch.cuda.synchronize()
    assert _counters() == (before[0] + 1, before[1] + 7,
                           before[2] + int(lengths[lengths > LONG_ENTRIES]
                                           .sum()))
    assert torch.equal(got, want)
    assert (got[torch.from_numpy(lengths == 0).to(dev)] == 0).all()
    exact = csr_gather_sum_plain(x.double(), col, rowptr,
                                 None if w is None else w.double())
    tol = torch.from_numpy(2e-6 * lengths + 1e-6).to(dev)[:, None]
    assert ((got.double() - exact).abs() <= tol).all()


@pytest.mark.parametrize("listed", ["every segment long", "every id"])
def test_csr_gather_sum_list_of_every_segment(dev, listed):
    """A list that holds every segment: a CSR whose segments are all long
    (the regular warps write nothing), or every id of the hub CSR (a short
    or empty segment summed by its block and by its group, to one value)."""
    col, rowptr, lengths = _long_csr(dev, 3000, 5,
                                    every_long=listed == "every segment long")
    s = lengths.size
    hubs = (long_segments(rowptr.cpu()).to(dev) if listed.endswith("long")
            else LongSegments(torch.arange(s, dtype=torch.int32, device=dev),
                              int(lengths.sum())))
    assert hubs.ids.numel() == s
    x = torch.randn(3000, 32, device=dev, generator=_gen(dev, 6))
    got = csr_gather_sum(x, col, rowptr, long_segments=hubs)
    assert torch.equal(got, csr_gather_sum(x, col, rowptr))


def test_hyper_ops_with_long_segments(dev):
    """A hypergraph with two hubs through the gather and the scatter,
    forward and backward: the graph's long segments engage in the node
    update and in the gather's backward (two launches of two segments) and
    leave the node sums and the gradient of x bit for bit as without
    them."""
    rng = np.random.default_rng(8)
    e = 9000
    uqi = np.stack([rng.integers(0, 300, e),
                    np.where(rng.random(e) < 0.4, 0, rng.integers(0, 50, e)),
                    np.where(rng.random(e) < 0.2, 7, rng.integers(0, 900, e))],
                   axis=1)
    graph = build_hypergraph(uqi, 1250, 300, 50).to(dev)
    assert graph.long_segments.ids.numel() == 2
    plain = dataclasses.replace(graph, long_segments=None)
    outs = []
    for g in (graph, plain):
        gather, scatter = make_hyper_ops(g)
        x = torch.randn(1250, 32, device=dev, generator=_gen(dev, 9))
        x.requires_grad_()
        before = _counters()
        nodes = scatter(gather(x).sum(0))
        nodes.backward(torch.randn(1250, 32, device=dev,
                                   generator=_gen(dev, 10)))
        torch.cuda.synchronize()
        outs.append((nodes.detach(), x.grad, _counters()[1] - before[1]))
    assert outs[0][2] == 2 * 2 and outs[1][2] == 0
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def test_csr_segment_sum3_mixed_segment_lengths(dev):
    """The three-region form on short and long segments: bitwise K1 on the
    concatenation."""
    col, rowptr, _ = _mixed_csr(dev, 3 * 1000, 3)
    g = _gen(dev, 14)
    u, q, i = (torch.randn(1000, 32, device=dev, generator=g)
               for _ in range(3))
    got = csr_segment_sum3(u, q, i, col, rowptr)
    assert torch.equal(got, csr_gather_sum(torch.cat([u, q, i]), col, rowptr))
    assert torch.equal(got, csr_segment_sum3(u, q, i, col, rowptr))


@pytest.mark.parametrize("d,edges", [(4, 1), (16, 999), (32, 4097),
                                     (64, 300)])
def test_gather_roles(dev, d, edges):
    g = _gen(dev, d)
    x = torch.randn(777, d, device=dev, generator=g)
    i3 = torch.randint(0, 777, (edges, 3), device=dev, generator=g).int()
    before = gather_roles.launches
    got = gather_roles(x, i3)
    torch.cuda.synchronize()
    assert gather_roles.launches == before + 1
    for a, b in zip(got, gather_roles_plain(x, i3)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("d,out", [(d, o) for d in (32, 16, 8)
                                   for o in KERNEL_OUT_DIMS])
def test_interact_fwd(dev, order, d, out):
    edges = 3 * 128 + 5           # a ragged tail
    g = _gen(dev, 10 * order + d + out)
    u, q, i = (torch.randn(edges, d, device=dev, generator=g)
               for _ in range(3))
    parts = ORDER_PARTS[order]
    w = (torch.randn(parts * d, out, device=dev, generator=g)
         / (parts * d) ** .5)
    b = torch.randn(out, device=dev, generator=g)
    before = interact_fwd.launches
    got = interact_fwd(u, q, i, w, b, order)
    torch.cuda.synchronize()
    assert interact_fwd.launches == before + 1
    want = interact_fwd_plain(u, q, i, w, b, order)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * want.abs().max().item())


def test_interact_fwd_many_blocks(dev):
    """More edges than one wave of resident blocks: the persistent loop."""
    g = _gen(dev, 3)
    u, q, i = (torch.randn(600_001, 32, device=dev, generator=g)
               for _ in range(3))
    w = torch.randn(7 * 32, 32, device=dev, generator=g) / 15.0
    b = torch.randn(32, device=dev, generator=g)
    got = interact_fwd(u, q, i, w, b, 3)
    want = interact_fwd_plain(u, q, i, w, b, 3)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * want.abs().max().item())


def _fwd_inputs(dev, edges, d, out, order, seed, scale=1.0):
    g = _gen(dev, seed)
    u, q, i = (torch.randn(edges, d, device=dev, generator=g)
               for _ in range(3))
    parts = ORDER_PARTS[order]
    w = torch.randn(parts * d, out, device=dev, generator=g) / (parts * d) ** .5
    b = torch.randn(out, device=dev, generator=g)
    return u * scale, q, i, w, b


def _assert_fwd_close(got, want):
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * want.abs().max().item())


def test_interact_fwd_form_rule(dev):
    """The tensor-core form takes every width the model uses (d % 8 == 0
    with W's split in shared memory); d % 8 != 0 and a W too large to
    split in shared memory take the f32-core form."""
    for order in (1, 2, 3):
        for d in (8, 16, 32):
            for out in KERNEL_OUT_DIMS:
                assert interact_fwd_form(d, out, order) == "tensor_cores"
    for d in (4, 12, 20):
        assert interact_fwd_form(d, 32, 3) == "f32_cores"
    assert interact_fwd_form(64, 64, 3) == "f32_cores"


@pytest.mark.parametrize("edges", [1, 15, 17, 31, 33, 100, 1023, 4099])
def test_interact_fwd_ragged_tails(dev, edges):
    """E not a multiple of a warp's 32-edge tile: the tail is zero-filled
    on load and masked on store."""
    u, q, i, w, b = _fwd_inputs(dev, edges, 32, 32, 3, edges)
    _assert_fwd_close(interact_fwd(u, q, i, w, b, 3),
                      interact_fwd_plain(u, q, i, w, b, 3))


@pytest.mark.parametrize("order", [1, 2, 3])
def test_interact_fwd_large_rows(dev, order):
    """One role's rows at magnitude 1e3: 3xTF32 keeps f32 accuracy, where
    plain TF32 would miss the limit (tests/test_torch_tf32_split.py)."""
    u, q, i, w, b = _fwd_inputs(dev, 20_011, 32, 32, order, 30 + order,
                                scale=1e3)
    _assert_fwd_close(interact_fwd(u, q, i, w, b, order),
                      interact_fwd_plain(u, q, i, w, b, order))


def test_interact_fwd_is_bitwise_repeatable(dev):
    u, q, i, w, b = _fwd_inputs(dev, 300_001, 32, 32, 3, 8)
    a = interact_fwd(u, q, i, w, b, 3)
    assert torch.equal(a, interact_fwd(u, q, i, w, b, 3))
    o = interact_fwd_absorb(u[:300_000], q[:300_000], i[:300_000],
                            _perm_table(dev, 300, 1000, 9), w, b, 3)
    p = interact_fwd_absorb(u[:300_000], q[:300_000], i[:300_000],
                            _perm_table(dev, 300, 1000, 9), w, b, 3)
    assert all(torch.equal(x, y) for x, y in zip(o, p))


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("d,out", [(4, 8), (12, 32), (20, 64), (32, 32),
                                   (64, 64)])
def test_interact_fwd_f32_core_form(dev, order, d, out):
    """K3's second form: by shape through ``interact_fwd`` (d % 8 != 0,
    or a W too large to split), and forced by ``interact_fwd_cores`` at
    any d; each call counts in its own wrapper."""
    u, q, i, w, b = _fwd_inputs(dev, 2 * 128 + 3, d, out, order,
                                7 * order + d)
    want = interact_fwd_plain(u, q, i, w, b, order)
    before = (interact_fwd.launches, interact_fwd_cores.launches)
    _assert_fwd_close(interact_fwd(u, q, i, w, b, order), want)
    _assert_fwd_close(interact_fwd_cores(u, q, i, w, b, order), want)
    torch.cuda.synchronize()
    assert (interact_fwd.launches - before[0],
            interact_fwd_cores.launches - before[1]) == (1, 1)


@pytest.mark.parametrize("order", [1, 3])
@pytest.mark.parametrize("rows,cols,d,scale", [(3, 7, 32, 1.0),
                                               (37, 24, 32, 1.0),
                                               (40, 256, 8, 1.0),
                                               (64, 128, 32, 1e3)])
def test_interact_fwd_absorb_shapes(dev, order, rows, cols, d, scale):
    """K5's forward on grids whose E is not a multiple of the 32-edge
    tile, narrow rows and rows of magnitude 1e3, in both forms: o1 and
    o2 = ρ(o1) against the twin; every o2 row is written."""
    u, q, i_t1, w, b = _fwd_inputs(dev, rows * cols, d, 32, order,
                                   rows + cols + order, scale)
    pi = _perm_table(dev, rows, cols, rows * cols)
    want = interact_fwd_absorb_plain(u, q, i_t1, pi, w, b, order)
    for fn in (interact_fwd_absorb, interact_fwd_absorb_cores):
        got = fn(u, q, i_t1, pi, w, b, order)
        for a, c in zip(got, want):
            _assert_fwd_close(a, c)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.randn(10, 8, device=dev)
    i3 = torch.zeros(4, 3, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):                  # int64 indices
        gather_roles(x, i3.long())
    with pytest.raises(ValueError):                  # mixed devices
        gather_roles(x, i3.cpu())
    with pytest.raises(ValueError):                  # d not a multiple of 4
        gather_roles(torch.randn(10, 6, device=dev), i3)
    col = torch.zeros(3, dtype=torch.int32, device=dev)
    rowptr = torch.tensor([0, 3], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):                  # f64 rows
        csr_gather_sum(x.double(), col, rowptr)
    u = torch.randn(4, 8, device=dev)
    with pytest.raises(ValueError):                  # no kernel for out = 24
        interact_fwd(u, u, u, torch.randn(56, 24, device=dev),
                     torch.randn(24, device=dev), 3)
    w = torch.randn(24, 8, device=dev)
    with pytest.raises(ValueError):                  # cot of the wrong width
        interact_bwd(u, u, u, w, torch.randn(4, 16, device=dev), 1)
    with pytest.raises(ValueError):                  # non-contiguous cot
        interact_bwd(u, u, u, w, torch.randn(8, 4, device=dev).t(), 1)
    with pytest.raises(ValueError):                  # d not a multiple of 4
        v = torch.randn(4, 6, device=dev)
        interact_bwd(v, v, v, torch.randn(18, 8, device=dev),
                     torch.randn(4, 8, device=dev), 1)
    # a kernel's output has no grad_fn: outside its Function, a CUDA call
    # that needs a gradient raises
    with pytest.raises(RuntimeError):
        interact_fwd(u.requires_grad_(), u, u, w, torch.randn(8, device=dev),
                     1)
    with pytest.raises(RuntimeError):
        csr_gather_sum(x.requires_grad_(), col, rowptr)


def _bwd_inputs(dev, edges, d, out, order, seed):
    g = _gen(dev, seed)
    u, q, i = (torch.randn(edges, d, device=dev, generator=g)
               for _ in range(3))
    parts = ORDER_PARTS[order]
    w = torch.randn(parts * d, out, device=dev, generator=g) / (parts * d) ** .5
    cot = torch.randn(edges, out, device=dev, generator=g)
    return u, q, i, w, cot


def _five(bwd):
    """``interact_bwd``'s ``(droles, dw, db)`` as (du, dq, di, dw, db)."""
    droles, dw, db = bwd
    return (*droles, dw, db)


def _assert_bwd_close(got, want):
    for name, a, b in zip(("du", "dq", "di", "dw", "db"), _five(got),
                          _five(want)):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-4 * b.abs().max().item(),
                                   msg=name)


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("out", KERNEL_OUT_DIMS)
@pytest.mark.parametrize("edges", [1, 999, 4097])
def test_interact_bwd(dev, order, out, edges):
    u, q, i, w, cot = _bwd_inputs(dev, edges, 32, out, order,
                                  100 * order + out + edges)
    before = interact_bwd.launches
    got = interact_bwd(u, q, i, w, cot, order)
    torch.cuda.synchronize()
    assert interact_bwd.launches == before + 1
    _assert_bwd_close(got, interact_bwd_plain(u, q, i, w, cot, order))
    # du, dq, di are the planes of one [3, E, d] buffer
    assert got[0].shape == (3, edges, 32) and got[0].is_contiguous()


@pytest.mark.parametrize("d,out", [(16, 16), (8, 32), (64, 8), (48, 64)])
def test_interact_bwd_other_widths(dev, d, out):
    """Other d: at d = 64 and out = 8 the dW rows span several slabs."""
    u, q, i, w, cot = _bwd_inputs(dev, 5000, d, out, 3, d + out)
    _assert_bwd_close(interact_bwd(u, q, i, w, cot, 3),
                      interact_bwd_plain(u, q, i, w, cot, 3))


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("out", KERNEL_OUT_DIMS)
def test_interact_bwd_ragged_chunks(dev, order, out):
    """E neither a multiple of the 32-edge tile nor of CHUNK_EDGES: three
    chunks, the last one ragged."""
    edges = 2 * CHUNK_EDGES + 45
    u, q, i, w, cot = _bwd_inputs(dev, edges, 32, out, order,
                                  300 + 10 * order + out)
    _assert_bwd_close(interact_bwd(u, q, i, w, cot, order),
                      interact_bwd_plain(u, q, i, w, cot, order))


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("d,out", [(4, 8), (12, 16), (36, 64), (96, 32)])
def test_interact_bwd_feature_widths(dev, order, d, out):
    """Widths whose feature blocks of 8 are ragged (d % 8 == 4) or span
    several slabs (d > 32, out = 64)."""
    u, q, i, w, cot = _bwd_inputs(dev, 3001, d, out, order, d + out + order)
    _assert_bwd_close(interact_bwd(u, q, i, w, cot, order),
                      interact_bwd_plain(u, q, i, w, cot, order))


@pytest.mark.parametrize("order", [1, 3])
def test_interact_bwd_large_rows(dev, order):
    """Rows of magnitude 1e3 in u and q: a product on TF32 operands alone
    (about 11 bits) misses 1e-4 of the largest value; the 3xTF32 split
    keeps f32 accuracy."""
    u, q, i, w, cot = _bwd_inputs(dev, 5000, 32, 32, order, 40 + order)
    u, q = u * 1e3, q * 1e3
    _assert_bwd_close(interact_bwd(u, q, i, w, cot, order),
                      interact_bwd_plain(u, q, i, w, cot, order))


def test_interact_bwd_is_bitwise_repeatable(dev):
    """dW and db are per-chunk partials summed in a fixed order: two calls
    agree bit for bit, over many chunks."""
    u, q, i, w, cot = _bwd_inputs(dev, 300_001, 32, 32, 3, 7)
    a = interact_bwd(u, q, i, w, cot, 3)
    b = interact_bwd(u, q, i, w, cot, 3)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    _assert_bwd_close(a, interact_bwd_plain(u, q, i, w, cot, 3))


def _small_graph():
    rng = np.random.default_rng(0)
    users, queries, items, edges = 30, 20, 50, 400
    uqi = np.stack([rng.integers(0, users, edges),
                    rng.integers(0, queries, edges),
                    rng.integers(0, items, edges)], axis=1)
    return build_hypergraph(uqi, users + queries + items, users, queries)


def _grads(dev, fn, *inputs):
    """Gradients of ``sum(fn(*inputs) * fixed weights)`` on ``dev``."""
    xs = [x.detach().to(dev).requires_grad_() for x in inputs]
    out = fn(dev, *xs)
    outs = out if isinstance(out, tuple) else (out,)
    g = torch.Generator().manual_seed(1)
    loss = sum((o * torch.randn(o.shape, generator=g).to(dev)).sum()
               for o in outs)
    loss.backward()
    return [o.detach().cpu() for o in outs], [x.grad.cpu() for x in xs]


def test_functions_grads_on_card_match_cpu(dev):
    """GatherRolesFn, InteractFn, SpmmFn (the scatter) and BagMeanFn: values
    and gradients on the card against the plain twins on the CPU."""
    graph = _small_graph()
    gathers = {}

    def layer(device, x, w, b):
        if device not in gathers:
            gathers[device] = make_hyper_ops(graph.to(device))
        gather, scatter = gathers[device]
        edge = InteractFn.apply(gather(x), w, b, 3)
        return scatter(edge)

    g = torch.Generator().manual_seed(2)
    x = torch.randn(graph.node_count, 32, generator=g)
    w = torch.randn(7 * 32, 32, generator=g) / 15
    b = torch.randn(32, generator=g)
    launches = (csr_gather_sum.launches, gather_roles.launches,
                interact_fwd.launches, interact_bwd.launches)
    cuda = _grads(dev, layer, x, w, b)
    assert (csr_gather_sum.launches - launches[0],
            gather_roles.launches - launches[1],
            interact_fwd.launches - launches[2],
            interact_bwd.launches - launches[3]) == (3, 1, 1, 1)
    cpu = _grads(torch.device("cpu"), layer, x, w, b)
    for a, c in zip(cuda[0] + cuda[1], cpu[0] + cpu[1]):
        torch.testing.assert_close(a, c, rtol=0,
                                   atol=1e-5 * c.abs().max().item())

    qw = np.random.default_rng(3).integers(0, 41, (20, 4)).astype(np.int32)
    qc = (qw > 0).sum(1).astype(np.int32)
    bag = make_word_bag(qw, qc, 41)
    bags = {}

    def bag_mean(device, table):
        if device not in bags:
            bags[device] = bag.to(device)
        return BagMeanFn.apply(table, bags[device])

    table = torch.randn(41, 32, generator=g)
    cuda = _grads(dev, bag_mean, table)
    cpu = _grads(torch.device("cpu"), bag_mean, table)
    for a, c in zip(cuda[0] + cuda[1], cpu[0] + cpu[1]):
        torch.testing.assert_close(a, c, rtol=0,
                                   atol=1e-5 * c.abs().max().item())
    assert torch.equal(cuda[1][0][0], torch.zeros(32))


# ---------------------------------------------------------------------------
# K4, the scalar segment sum, csr_edge_dot and the attention conv
# ---------------------------------------------------------------------------


def _rowptr(dev, counts):
    rowptr = torch.zeros(len(counts) + 1, dtype=torch.int64)
    rowptr[1:] = torch.tensor(counts).cumsum(0)
    return rowptr.int().to(dev)


def test_csr_segment_max(dev):
    """Random scores over 1000 segments, every 7th empty: bitwise equal to
    the twin, and -3e38 where empty."""
    _, rowptr = _csr(dev, 1000, 1, 20_000, seed=4)
    k = int(rowptr[-1])
    scores = torch.randn(k, device=dev, generator=_gen(dev, 5)) * 10
    before = csr_segment_max.launches
    got = csr_segment_max(scores, rowptr)
    torch.cuda.synchronize()
    assert csr_segment_max.launches == before + 1
    assert torch.equal(got, csr_segment_max_plain(scores, rowptr))
    empty = rowptr[1:] == rowptr[:-1]
    assert empty.any() and (got[empty] == EMPTY_MAX).all()


def test_csr_segment_max_long_and_masked_segments(dev):
    """One segment over 10k entries, one whose entries are all -1e30 (the
    attention's masked score), empty ones around them."""
    rowptr = _rowptr(dev, [0, 10_000, 0, 37, 5, 0])
    scores = torch.randn(10_042, device=dev, generator=_gen(dev, 6))
    scores[10_000:10_037] = -1e30
    scores[1234] = 50.0
    got = csr_segment_max(scores, rowptr)
    assert torch.equal(got, csr_segment_max_plain(scores, rowptr))
    assert got[1] == 50.0 and got[3] == -1e30
    assert got[0] == EMPTY_MAX and got[2] == EMPTY_MAX and got[5] == EMPTY_MAX


def test_csr_segment_sum(dev):
    """The scalar sum mode against its twin, a 10k-entry segment included;
    two calls agree bit for bit."""
    _, rowptr = _csr(dev, 1000, 1, 20_000, seed=7)
    rowptr = torch.cat([rowptr, rowptr[-1:] + 10_000])
    v = torch.rand(int(rowptr[-1]), device=dev, generator=_gen(dev, 8))
    before = csr_segment_sum.launches
    got = csr_segment_sum(v, rowptr)
    torch.cuda.synchronize()
    assert csr_segment_sum.launches == before + 1
    want = csr_segment_sum_plain(v, rowptr)
    torch.testing.assert_close(got[:-1], want[:-1], rtol=0, atol=1e-5)
    # 10k uniforms in another order than the twin's
    torch.testing.assert_close(got[-1], want[-1], rtol=1e-5, atol=0)
    assert torch.equal(got, csr_segment_sum(v, rowptr))
    empty = rowptr[1:] == rowptr[:-1]
    assert (got[empty] == 0).all()


def _assert_sum_ordered(got, v, rowptr):
    """The kernel's sum bit for bit against its order of adds on the CPU."""
    want = csr_segment_sum_ordered(v.cpu(), rowptr.cpu())
    assert torch.equal(got.cpu(), want)


def _skewed_rowptr(dev, seed):
    """A skewed CSR: 20k segments, about 40 % empty, the rest 1-30 entries,
    and four segments of 257 to 100k entries (longer than a block's
    shared-memory window) placed among them."""
    g = np.random.default_rng(seed)
    counts = g.integers(1, 31, 20_000)
    counts[g.random(20_000) < 0.4] = 0
    counts[g.choice(20_000, 4, replace=False)] = (100_000, 30_000, 1000, 257)
    return _rowptr(dev, counts.tolist())


def test_segment_reduce_empty(dev):
    """No segments: no launch and an empty result. Only empty segments:
    -3e38 and 0 everywhere."""
    rowptr = torch.zeros(1, dtype=torch.int32, device=dev)
    v = torch.zeros(0, device=dev)
    before = (csr_segment_max.launches, csr_segment_sum.launches)
    assert csr_segment_max(v, rowptr).shape == (0,)
    assert csr_segment_sum(v, rowptr).shape == (0,)
    assert (csr_segment_max.launches, csr_segment_sum.launches) == before
    rowptr = torch.zeros(1001, dtype=torch.int32, device=dev)
    assert (csr_segment_max(v, rowptr) == EMPTY_MAX).all()
    assert (csr_segment_sum(v, rowptr) == 0).all()


@pytest.mark.parametrize("counts", [[3, 0, 1_000_000, 5, 0],
                                    [1_000_000]])
def test_segment_reduce_one_long_segment(dev, counts):
    """One segment of 1M entries (the block path), short ones around it:
    the max equals its twin, the sum its order of adds and, within 1e-6,
    the float64 sum."""
    rowptr = _rowptr(dev, counts)
    v = torch.rand(int(rowptr[-1]), device=dev, generator=_gen(dev, 11))
    assert torch.equal(csr_segment_max(v, rowptr),
                       csr_segment_max_plain(v, rowptr))
    got = csr_segment_sum(v, rowptr)
    _assert_sum_ordered(got, v, rowptr)
    want = csr_segment_sum_plain(v.double(), rowptr)
    torch.testing.assert_close(got.double(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("aligned", [True, False])
def test_segment_reduce_windows(dev, aligned):
    """Segments of 150-256 entries, so each block's entries span several
    shared-memory windows and segments straddle them; and v starting off a
    16-byte boundary (the scalar loads)."""
    g = np.random.default_rng(12)
    counts = g.integers(150, LONG_SEGMENT + 1, 3000)
    counts[::11] = 0
    rowptr = _rowptr(dev, counts.tolist())
    buf = torch.randn(int(rowptr[-1]) + 1, device=dev, generator=_gen(dev, 13))
    v = buf[:-1] if aligned else buf[1:]
    assert torch.equal(csr_segment_max(v, rowptr),
                       csr_segment_max_plain(v, rowptr))
    got = csr_segment_sum(v, rowptr)
    _assert_sum_ordered(got, v, rowptr)    # all short: sequential sums
    torch.testing.assert_close(got, csr_segment_sum_plain(v, rowptr),
                               rtol=0, atol=1e-4)


def test_segment_reduce_skewed_is_repeatable(dev):
    """The skewed CSR (long segments among short and empty ones): the max
    equals its twin, the sum its order of adds, and two calls agree bit
    for bit."""
    rowptr = _skewed_rowptr(dev, 14)
    v = torch.randn(int(rowptr[-1]), device=dev, generator=_gen(dev, 15))
    got_max = csr_segment_max(v, rowptr)
    got_sum = csr_segment_sum(v, rowptr)
    assert torch.equal(got_max, csr_segment_max_plain(v, rowptr))
    _assert_sum_ordered(got_sum, v, rowptr)
    assert torch.equal(got_max, csr_segment_max(v, rowptr))
    assert torch.equal(got_sum, csr_segment_sum(v, rowptr))
    torch.testing.assert_close(got_sum.double(),
                               csr_segment_sum_plain(v.double(), rowptr),
                               rtol=0, atol=1e-4)


def test_segment_max_nan_and_masked_scores(dev):
    """A NaN wins in short and long segments; segments of -1e30 scores
    (the attention's masked entries) read -1e30."""
    counts = [10, 300, 4, 2000, 7, 0]
    rowptr = _rowptr(dev, counts)
    v = torch.randn(sum(counts), device=dev, generator=_gen(dev, 16))
    v[3] = float("nan")                  # short segment 0
    v[10 + 123] = float("nan")           # long segment 1
    v[310:314] = -1e30                   # short segment 2, all masked
    v[314:2314] = -1e30                  # long segment 3, all masked
    got = csr_segment_max(v, rowptr)
    torch.testing.assert_close(got, csr_segment_max_plain(v, rowptr),
                               rtol=0, atol=0, equal_nan=True)
    assert got[:2].isnan().all() and (got[2:4] == -1e30).all()
    assert got[5] == EMPTY_MAX


def _assert_edge_dot(dev, a, b, col, rowptr):
    """csr_edge_dot against its twin (1e-5 of the largest output), one
    launch, and bit for bit the same on a second run."""
    order = edge_dot_order(col, rowptr)
    before = csr_edge_dot.launches
    got = csr_edge_dot(a, b, order)
    torch.cuda.synchronize()
    assert csr_edge_dot.launches == before + 1
    want = csr_edge_dot_plain(a, b, col, rowptr)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * want.abs().max().item())
    assert torch.equal(got, csr_edge_dot(a, b, order))


@pytest.mark.parametrize("d", [4, 8, 12, 32, 64, 136])
def test_csr_edge_dot(dev, d):
    """Every lane-group width: d/4 of 1 to over 8 float4s a row (slices)."""
    col, rowptr = _csr(dev, 800, 500, 12_000, seed=d)
    g = _gen(dev, 200 + d)
    a = torch.randn(800, d, device=dev, generator=g)
    b = torch.randn(500, d, device=dev, generator=g)
    _assert_edge_dot(dev, a, b, col, rowptr)


@pytest.mark.parametrize("d", range(4, 168, 4))
def test_csr_edge_dot_every_width(dev, d):
    """Every width the wrapper takes up to 164, on a CSR of several
    chunks; a has more rows than segments."""
    col, rowptr = _csr(dev, 600, 900, 9000, seed=1000 + d)
    g = _gen(dev, 300 + d)
    a = torch.randn(650, d, device=dev, generator=g)
    b = torch.randn(900, d, device=dev, generator=g)
    _assert_edge_dot(dev, a, b, col, rowptr)


@pytest.mark.parametrize("spread", ["table", "band"])
def test_csr_edge_dot_large(dev, spread):
    """1.2M entries over 100k segments; b [2M, 32] (256 MB, larger than L2
    and than any wave's band), its columns spread over the whole table or
    packed in one band of 2000 rows; a has more rows than segments."""
    segments, rows, k = 100_000, 2_000_000, 1_200_000
    g = _gen(dev, 31)
    ids = torch.randint(0, segments, (k,), device=dev, generator=g).sort()
    lo = 0 if spread == "table" else 1_000_000
    hi = rows if spread == "table" else lo + 2000
    col = torch.randint(lo, hi, (k,), device=dev, generator=g).int()
    counts = torch.bincount(ids.values, minlength=segments)
    rowptr = torch.zeros(segments + 1, dtype=torch.int64, device=dev)
    rowptr[1:] = counts.cumsum(0)
    a = torch.randn(segments + 1000, 32, device=dev, generator=g)
    b = torch.randn(rows, 32, device=dev, generator=g)
    _assert_edge_dot(dev, a, b, col, rowptr.int())


def test_csr_edge_dot_empty_and_long_segments(dev):
    """Empty segments around one segment of 150k entries (many chunks of
    one segment), at the start, in the middle and at the end."""
    counts = [0, 0, 5, 150_000, 0, 3, 0, 0, 2 * CHUNK + 1, 7, 0]
    rowptr = _rowptr(dev, counts)
    g = _gen(dev, 32)
    k = sum(counts)
    col = torch.randint(0, 40_000, (k,), device=dev, generator=g).int()
    a = torch.randn(len(counts), 32, device=dev, generator=g)
    b = torch.randn(40_000, 32, device=dev, generator=g)
    _assert_edge_dot(dev, a, b, col, rowptr)
    empty = _rowptr(dev, [0, 0, 0])
    none = torch.zeros(0, dtype=torch.int32, device=dev)
    out = csr_edge_dot(a, b, edge_dot_order(none, empty))
    assert out.shape == (0,)


def test_new_wrappers_refuse_what_the_kernels_do_not_take(dev):
    v = torch.randn(6, device=dev)
    rowptr = torch.tensor([0, 2, 6], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):                  # int64 rowptr
        csr_segment_max(v, rowptr.long())
    with pytest.raises(ValueError):                  # [K, 1] scores
        csr_segment_sum(v[:, None], rowptr)
    col = torch.zeros(6, dtype=torch.int32, device=dev)
    order = edge_dot_order(col, rowptr)
    a = torch.randn(2, 6, device=dev)
    with pytest.raises(ValueError):                  # d not a multiple of 4
        csr_edge_dot(a, a, order)
    a = torch.randn(2, 8, device=dev)
    with pytest.raises(ValueError):                  # widths differ
        csr_edge_dot(a, torch.randn(2, 4, device=dev), order)
    with pytest.raises(ValueError):                  # misaligned rows
        csr_edge_dot(a, torch.randn(17, device=dev)[1:].view(2, 8), order)
    with pytest.raises(ValueError):                  # fewer a rows than S
        csr_edge_dot(torch.randn(1, 8, device=dev), a, order)
    with pytest.raises(ValueError):                  # the order on the CPU
        csr_edge_dot(a, a, edge_dot_order(col.cpu(), rowptr.cpu()))
    with pytest.raises(RuntimeError):                # needs a gradient
        csr_segment_max(v.requires_grad_(), rowptr)


def _small_inputs():
    rng = np.random.default_rng(0)
    users, queries, items, edges = 30, 20, 50, 400
    uqif = np.stack([rng.integers(0, users, edges),
                     rng.integers(0, queries, edges),
                     rng.integers(0, items, edges),
                     (rng.random(edges) > 0.1).astype(np.int64)], axis=1)
    logs = [[int(rng.integers(0, users)), users + int(rng.integers(0, queries))]
            + [users + queries + int(i)
               for i in rng.choice(items, int(rng.integers(1, 4)), replace=False)]
            for _ in range(150)]
    return uqif, logs, users + queries + items, users, queries


def _assert_grads_close(cuda, cpu, head_grads=()):
    """Values and gradients within 1e-5 of each tensor's largest value;
    the entries of ``head_grads`` (positions in the gradient list) within
    1e-5 of the largest gradient of the first input."""
    (c_out, c_grads), (p_out, p_grads) = cuda, cpu
    for a, c in zip(c_out, p_out):
        torch.testing.assert_close(a, c, rtol=0,
                                   atol=1e-5 * c.abs().max().item())
    x_scale = p_grads[0].abs().max().item()
    for j, (a, c) in enumerate(zip(c_grads, p_grads)):
        scale = x_scale if j in head_grads else c.abs().max().item()
        torch.testing.assert_close(a, c, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("head", [V.CONCAT, V.PRODUCT])
@pytest.mark.parametrize("kind", ["graph2d", "phase2"])
def test_gat_conv_grads_on_card_match_cpu(dev, head, kind):
    """``GatConvFn`` on the card against the CPU: values and the gradients
    of x, the head's kernel and bias; then the launches one forward and
    backward makes."""
    uqif, _, n, users, queries = _small_inputs()
    if kind == "graph2d":
        csr = build_graph2d(uqif, n, users, queries).attention
        assert csr.mask is not None           # some i-u entries sum to 0
    else:
        csr = build_hypergraph(uqif, n, users, queries).phase2
    csrs = {}
    g = torch.Generator().manual_seed(3)
    x = torch.randn(csr.node_count, 32, generator=g)
    k = torch.randn(64 if head == V.CONCAT else 32, generator=g) / 8
    b = torch.randn(1, generator=g)

    def conv(device, x, k, b):
        if device not in csrs:
            csrs[device] = csr.to(device)
        return GatConvFn.apply(x, k, b, csrs[device], head)

    wrappers = (csr_gather_sum, csr_segment_max, csr_segment_sum,
                csr_edge_dot)
    before = [w.launches for w in wrappers]
    cuda = _grads(dev, conv, x, k, b)
    torch.cuda.synchronize()
    launched = [w.launches - n0 for w, n0 in zip(wrappers, before)]
    # forward: K1, K4, one sum (+ the product head's scores); backward: K1,
    # tt, then tsum, gd, gs (concat) or tsum and one K1 a side (product)
    assert launched == ([2, 1, 4, 1] if head == V.CONCAT else [4, 1, 2, 2])
    _assert_grads_close(cuda, _grads(torch.device("cpu"), conv, x, k, b),
                        head_grads=(1, 2))


def test_gat_backward_is_bitwise_repeatable(dev):
    uqif, _, n, users, queries = _small_inputs()
    csr = build_graph2d(uqif, n, users, queries).attention.to(dev)
    g = _gen(dev, 9)
    x = torch.randn(n, 32, device=dev, generator=g)
    k = torch.randn(64, device=dev, generator=g) / 8
    b = torch.randn(1, device=dev, generator=g)
    cot = torch.randn(n, 32, device=dev, generator=g)
    grads = []
    for _ in range(2):
        xs = [t.clone().requires_grad_() for t in (x, k, b)]
        GatConvFn.apply(*xs, csr, V.CONCAT).backward(cot)
        grads.append([t.grad for t in xs])
    for a, c in zip(*grads):
        assert torch.equal(a, c)


def test_spmm_and_log_ops_grads_on_card_match_cpu(dev):
    uqif, logs, n, users, queries = _small_inputs()
    graph2d = build_graph2d(uqif, n, users, queries)
    log_graph = build_log_hypergraph(logs, n)
    ops = {}

    def aggregate(device, x):
        if device not in ops:
            ops[device] = (make_spmm_op(graph2d.to(device)),
                           make_log_ops(log_graph.to(device)),
                           log_graph.de.to(device))
        spmm, (edge_sum, node_sum), de = ops[device]
        return spmm(x), node_sum(edge_sum(x) / de)

    x = torch.randn(n, 32, generator=torch.Generator().manual_seed(4))
    before = csr_gather_sum.launches
    cuda = _grads(dev, aggregate, x)
    assert csr_gather_sum.launches - before == 6
    _assert_grads_close(cuda, _grads(torch.device("cpu"), aggregate, x))


# ---------------------------------------------------------------------------
# the routed path: K6/K7 permutes, K2's single-index forms, K1's three-region
# form, K5 (the absorbed interaction), K8 and the routed Functions
# ---------------------------------------------------------------------------


def _perm_table(dev, rows, cols, seed):
    """An int32 [rows, cols] table whose rows are permutations."""
    g = torch.Generator().manual_seed(seed)
    return torch.stack([torch.randperm(cols, generator=g)
                        for _ in range(rows)]).int().to(dev)


@pytest.mark.parametrize("dtype,d", [(torch.float32, 32), (torch.float32, 4),
                                     (torch.bfloat16, 32),
                                     (torch.bfloat16, 8)])
@pytest.mark.parametrize("rows,cols", [(128, 128), (256, 512)])
def test_permute_forms(dev, dtype, d, rows, cols):
    """The four forms, bitwise against their twins, f32 and bf16 rows."""
    x = torch.randn(rows, cols, d, device=dev,
                    generator=_gen(dev, rows + d)).to(dtype)
    p = _perm_table(dev, rows, cols, 1)
    pt = _perm_table(dev, cols, rows, 2)
    count = "launches_bf16" if dtype == torch.bfloat16 else "launches"
    before = (getattr(row_local_permute, count),
              getattr(transposed_local_permute, count))
    got = [row_local_permute(x, p), transposed_local_permute(x),
           transposed_local_permute(x, p),
           transposed_local_permute(x, pt, pre=True)]
    torch.cuda.synchronize()
    assert (getattr(row_local_permute, count) - before[0],
            getattr(transposed_local_permute, count) - before[1]) == (1, 3)
    want = [row_local_permute_plain(x, p),
            transposed_local_permute_plain(x),
            transposed_local_permute_plain(x, p),
            transposed_local_permute_plain(x, pt, pre=True)]
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b)
    # the pre form is a transpose, then the transposed permute
    assert torch.equal(got[3], transposed_local_permute(
        transposed_local_permute(x), pt))


@pytest.mark.parametrize("transposed", [False, True])
def test_gather_rows(dev, transposed):
    g = _gen(dev, 11)
    x = torch.randn(999, 32, device=dev, generator=g)
    idx = torch.randint(0, 999, (128, 256), device=dev, generator=g).int()
    fn = gather_rows_t if transposed else gather_rows
    before = fn.launches
    got = fn(x, idx)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert torch.equal(got, gather_rows_plain(x, idx, transposed))
    out = torch.empty_like(got)
    assert fn(x, idx, out=out) is out and torch.equal(out, got)


def test_csr_segment_sum3(dev):
    """Three regions through three base pointers: bitwise what K1 gives on
    their concatenation, every 7th segment empty."""
    col, rowptr = _csr(dev, 1000, 3 * 700, 9000, seed=12)
    g = _gen(dev, 13)
    u, q, i = (torch.randn(700, 32, device=dev, generator=g)
               for _ in range(3))
    before = csr_segment_sum3.launches
    got = csr_segment_sum3(u, q, i, col, rowptr)
    torch.cuda.synchronize()
    assert csr_segment_sum3.launches == before + 1
    torch.testing.assert_close(
        got, csr_segment_sum3_plain(u, q, i, col, rowptr), rtol=0, atol=1e-5)
    assert torch.equal(got, csr_gather_sum(torch.cat([u, q, i]), col, rowptr))


def _absorb_inputs(dev, rows, cols, d, order, seed, masked, out=32):
    g = _gen(dev, seed)
    e = rows * cols
    u, q, i_t1 = (torch.randn(e, d, device=dev, generator=g)
                  for _ in range(3))
    parts = ORDER_PARTS[order]
    w = torch.randn(parts * d, out, device=dev, generator=g) / (parts * d) ** .5
    b = torch.randn(out, device=dev, generator=g)
    c1, c2 = (torch.randn(e, out, device=dev, generator=g) for _ in range(2))
    mask = ((torch.rand(e, device=dev, generator=g) > 0.1).float()
            if masked else None)
    return u, q, i_t1, _perm_table(dev, rows, cols, seed), w, b, c1, c2, mask


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("rows,cols,d", [(16, 128, 32), (40, 256, 16)])
def test_interact_absorb(dev, order, masked, rows, cols, d):
    """K5 against its twin: o1 and o2 within 1e-5, du/dq/di_t1/dW/db within
    1e-4 of their largest values; masked σ pads reach no gradient."""
    u, q, i_t1, pi, w, b, c1, c2, mask = _absorb_inputs(
        dev, rows, cols, d, order, 10 * order + rows + masked, masked)
    before = (interact_fwd_absorb.launches, interact_bwd_absorb.launches)
    got = interact_fwd_absorb(u, q, i_t1, pi, w, b, order)
    got_b = interact_bwd_absorb(u, q, i_t1, pi, w, c1, c2, mask, order)
    torch.cuda.synchronize()
    assert (interact_fwd_absorb.launches - before[0],
            interact_bwd_absorb.launches - before[1]) == (1, 1)
    for a, c in zip(got, interact_fwd_absorb_plain(u, q, i_t1, pi, w, b,
                                                   order)):
        torch.testing.assert_close(a, c, rtol=0,
                                   atol=1e-5 * c.abs().max().item())
    want_b = interact_bwd_absorb_plain(u, q, i_t1, pi, w, c1, c2, mask, order)
    _assert_bwd_close(got_b, want_b)
    if masked:
        pads = mask == 0
        assert (got_b[0][0][pads] == 0).all() and (got_b[0][1][pads] == 0).all()


def test_interact_absorb_is_bitwise_repeatable(dev):
    u, q, i_t1, pi, w, b, c1, c2, mask = _absorb_inputs(
        dev, 256, 1024, 32, 3, 5, True)
    a = interact_bwd_absorb(u, q, i_t1, pi, w, c1, c2, mask, 3)
    c = interact_bwd_absorb(u, q, i_t1, pi, w, c1, c2, mask, 3)
    for x, y in zip(a, c):
        assert torch.equal(x, y)


def _assert_identity(got, want):
    for name, a, c in zip(("du", "dq", "di", "dw", "db"), _five(got),
                          _five(want)):
        assert torch.equal(a, c), name


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("out", KERNEL_OUT_DIMS)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("rows,cols", [(300, 8), (3, 1024), (2, 2048)])
def test_interact_bwd_absorb_equals_direct(dev, order, out, masked, rows,
                                           cols):
    """K5's backward bit for bit equal to ``interact_bwd`` on the
    pre-permuted inputs (i_t1[e_π], (c1 + c2[e_π])·mask), di scattered
    back to t1 order; cols below, at and above CHUNK_EDGES (2400 edges at
    cols = 8: a ragged last chunk); and within 1e-4 of its twin."""
    u, q, i_t1, pi, w, _, c1, c2, mask = _absorb_inputs(
        dev, rows, cols, 32, order, order + out + rows + masked, masked, out)
    before = interact_bwd_absorb.launches
    got = interact_bwd_absorb(u, q, i_t1, pi, w, c1, c2, mask, order)
    want = interact_bwd_absorb_via_direct(u, q, i_t1, pi, w, c1, c2, mask,
                                          order)
    torch.cuda.synchronize()
    assert interact_bwd_absorb.launches == before + 1
    _assert_identity(got, want)
    _assert_bwd_close(got, interact_bwd_absorb_plain(u, q, i_t1, pi, w, c1,
                                                     c2, mask, order))


@pytest.mark.parametrize("order", [1, 3])
@pytest.mark.parametrize("rows,cols,d", [(143, 7, 32), (31, 100, 32),
                                         (5, 1000, 16), (40, 77, 12)])
def test_interact_bwd_absorb_ragged(dev, order, rows, cols, d):
    """E a multiple of neither the 32-edge tile nor CHUNK_EDGES, grid rows
    that cross chunks, and feature widths d % 8 != 0: still bit for bit
    the direct kernel's, and within 1e-4 of the twin."""
    u, q, i_t1, pi, w, _, c1, c2, mask = _absorb_inputs(
        dev, rows, cols, d, order, rows + cols + d, True)
    got = interact_bwd_absorb(u, q, i_t1, pi, w, c1, c2, mask, order)
    _assert_identity(got, interact_bwd_absorb_via_direct(
        u, q, i_t1, pi, w, c1, c2, mask, order))
    _assert_bwd_close(got, interact_bwd_absorb_plain(u, q, i_t1, pi, w, c1,
                                                     c2, mask, order))


@pytest.mark.parametrize("order,d,out", [(3, 160, 32), (1, 200, 64),
                                         (2, 148, 8)])
def test_interact_bwd_w_from_device_memory(dev, order, d, out):
    """Widths at which W does not fit in shared memory beside the two edge
    stages, so the data product reads W from device memory: ``interact_bwd``
    and K5's backward within 1e-4 of their twins, and equal to each other
    bit for bit on the pre-permuted inputs."""
    u, q, i_t1, pi, w, _, c1, c2, mask = _absorb_inputs(
        dev, 6, 512, d, order, d + out, True, out)
    cot = torch.randn(u.shape[0], out, device=dev, generator=_gen(dev, d))
    _assert_bwd_close(interact_bwd(u, q, i_t1, w, cot, order),
                      interact_bwd_plain(u, q, i_t1, w, cot, order))
    got = interact_bwd_absorb(u, q, i_t1, pi, w, c1, c2, mask, order)
    _assert_identity(got, interact_bwd_absorb_via_direct(
        u, q, i_t1, pi, w, c1, c2, mask, order))
    _assert_bwd_close(got, interact_bwd_absorb_plain(u, q, i_t1, pi, w, c1,
                                                     c2, mask, order))


def test_interact_bwd_absorb_sigma_pads_reach_no_gradient(dev):
    """Masked σ pads: du and dq are 0 on them, di_t1 is 0 at their e_π,
    and changing the pads' u, q and i rows changes no output bit (dW and
    db included)."""
    rows, cols = 16, 1024
    u, q, i_t1, pi, w, _, c1, c2, mask = _absorb_inputs(
        dev, rows, cols, 32, 3, 21, True)
    got = interact_bwd_absorb(u, q, i_t1, pi, w, c1, c2, mask, 3)
    pads = mask == 0
    e_pi = (torch.arange(rows, device=dev)[:, None] * cols
            + pi.long()).view(-1)
    du, dq, di_t1 = got[0]
    assert (du[pads] == 0).all() and (dq[pads] == 0).all()
    assert (di_t1[e_pi[pads]] == 0).all()
    g = _gen(dev, 22)
    u2, q2, i2 = u.clone(), q.clone(), i_t1.clone()
    n = int(pads.sum())
    u2[pads] = 1e3 * torch.randn(n, 32, device=dev, generator=g)
    q2[pads] = 1e3 * torch.randn(n, 32, device=dev, generator=g)
    i2[e_pi[pads]] = 1e3 * torch.randn(n, 32, device=dev, generator=g)
    _assert_identity(got, interact_bwd_absorb(u2, q2, i2, pi, w, c1, c2,
                                              mask, 3))


def _scan_ids(seed, k, n, shuffle=True):
    """``tests/test_segscan.py``'s id streams: k sorted ids in [0, n),
    shuffled within each 1024-entry block, int32-max padded."""
    rng = np.random.default_rng(seed)
    k_pad = -(-k // SCAN_BLOCK) * SCAN_BLOCK
    ids = np.sort(rng.integers(0, n, size=k))
    if shuffle:
        for b in range(0, k - SCAN_BLOCK + 1, SCAN_BLOCK):
            rng.shuffle(ids[b:b + SCAN_BLOCK])
    return np.concatenate([ids, np.full(k_pad - k, 2**31 - 1, np.int64)])


def _k1_over(ids, vals, n):
    """K1 over the stream's entries in stream order (a stable sort by id)."""
    dev = vals.device
    order = np.argsort(ids, kind="stable")[:int((ids != 2**31 - 1).sum())]
    rowptr = np.searchsorted(ids[order], np.arange(n + 1))
    return csr_gather_sum(vals, torch.from_numpy(order).int().to(dev),
                          torch.from_numpy(rowptr).int().to(dev))


@pytest.mark.parametrize("seed,k,n,shuffle", [(0, 5000, 700, False),
                                              (1, 5000, 700, True),
                                              (2, 4096, 10, True),
                                              (3, 2000, 3000, True),
                                              (4, 300_000, 7000, True),
                                              (5, 200_000, 20, True)])
def test_csr_segment_scan(dev, seed, k, n, shuffle):
    """K8 against its twin (1e-5), bitwise what K1 gives over the same
    entries in stream order, and repeatable."""
    ids = _scan_ids(seed, k, n, shuffle)
    pack = pack_scan_inputs(ids, n).to(dev)
    vals = torch.randn(len(ids), 32, device=dev, generator=_gen(dev, seed))
    before = csr_segment_scan.launches
    got = csr_segment_scan(vals, pack)
    torch.cuda.synchronize()
    assert csr_segment_scan.launches == before + 1
    torch.testing.assert_close(got, csr_segment_scan_plain(vals, pack),
                               rtol=0, atol=1e-5 * max(1.0, k / n))
    assert torch.equal(got, _k1_over(ids, vals, n))
    assert torch.equal(got, csr_segment_scan(vals, pack))


def _scan_shaped_ids(case):
    """Streams whose runs cross one, two and many blocks, with blocks of
    sentinels only and a block that is one run; shuffled within blocks."""
    rng = np.random.default_rng(8)
    b = SCAN_BLOCK
    if case == "cross_one":
        ids = np.repeat(np.arange(20), b + b // 2)
    elif case == "cross_two":
        ids = np.concatenate([np.arange(300), np.full(2 * b + b // 2, 300),
                              np.arange(301, 301 + b + 212)])
    elif case == "cross_many":
        ids = np.concatenate([np.arange(100), np.full(20 * b, 100),
                              np.arange(101, 101 + b - 100)])
    elif case == "sentinel_blocks":
        ids = np.concatenate([np.sort(rng.integers(0, 50, b)),
                              np.full(2 * b, 2**31 - 1),
                              np.sort(rng.integers(50, 90, b - 10)),
                              np.full(10, 2**31 - 1)])
    else:   # one_run
        ids = np.concatenate([np.sort(rng.integers(0, 30, b)),
                              np.full(b, 30),
                              np.sort(rng.integers(31, 60, b))])
    ids = ids.astype(np.int64)
    for s0 in range(0, len(ids), b):
        rng.shuffle(ids[s0:s0 + b])
    return ids


@pytest.mark.parametrize("d", [4, 8, 32, 64, 100, 5, 30])
@pytest.mark.parametrize("case", ["cross_one", "cross_two", "cross_many",
                                  "sentinel_blocks", "one_run",
                                  "shuffled"])
def test_csr_segment_scan_shapes(dev, d, case):
    """K8 at every slice form (float4 groups of 1-4 lanes, several slices
    at d = 64 and 100, the 4-byte form at d = 5 and 30) on runs crossing
    one, two and many blocks, blocks that hold only sentinels and a block
    that is one run: bitwise K1 over the same entries, and repeatable."""
    if case == "shuffled":
        ids, n = _scan_ids(6, 50_000, 3000, True), 3003
    else:
        ids = _scan_shaped_ids(case)
        n = int(ids[ids != 2**31 - 1].max()) + 3   # trailing empty segments
    pack = pack_scan_inputs(ids, n).to(dev)
    vals = torch.randn(len(ids), d, device=dev, generator=_gen(dev, d))
    got = csr_segment_scan(vals, pack)
    assert torch.equal(got, _k1_over(ids, vals, n))
    assert torch.equal(got, csr_segment_scan(vals, pack))
    longest = int((pack.rowptr[1:] - pack.rowptr[:-1]).max())
    torch.testing.assert_close(got, csr_segment_scan_plain(vals, pack),
                               rtol=0, atol=1e-5 * max(1, longest))


def test_csr_segment_scan_large_stream(dev):
    """A stream of 2.1M entries (2,050 blocks) into 300k segments, with
    sentinels scattered through it: bitwise K1, repeatable."""
    rng = np.random.default_rng(9)
    k = 2050 * SCAN_BLOCK
    ids = np.sort(rng.integers(0, 300_000, k))
    ids[rng.random(k) < 0.05] = 2**31 - 1
    ids = ids.reshape(-1, SCAN_BLOCK)
    rng.permuted(ids, axis=1, out=ids)
    ids = ids.reshape(-1)
    pack = pack_scan_inputs(ids, 300_000).to(dev)
    vals = torch.randn(k, 32, device=dev, generator=_gen(dev, 9))
    got = csr_segment_scan(vals, pack)
    assert torch.equal(got, _k1_over(ids, vals, 300_000))
    assert torch.equal(got, csr_segment_scan(vals, pack))


def _routed_graph():
    rng = np.random.default_rng(0)
    users, queries, items, edges = 30, 20, 50, 400
    uqi = np.stack([rng.integers(0, users, edges),
                    rng.integers(0, queries, edges),
                    rng.integers(0, items, edges)], axis=1)
    return build_hypergraph(uqi, users + queries + items, users, queries,
                            pack_kernels=True)


_ROUTED_WRAPPERS = ("gather_rows", "gather_rows_t", "row_local_permute",
                    "transposed_local_permute", "csr_segment_sum3",
                    "interact_fwd", "interact_bwd", "interact_fwd_absorb",
                    "interact_bwd_absorb")


def _routed_launches():
    return {name: globals()[name].launches for name in _ROUTED_WRAPPERS}


@pytest.mark.parametrize("absorb", [False, True])
def test_routed_functions_grads_on_card_match_cpu(dev, absorb):
    """One routed IHGNN layer (gather, interaction, scatter; absorbed or
    not) on the card against the CPU: values and the gradients of x, W and
    b within 1e-5 of their largest values; the exact launches of one
    forward and backward."""
    graph = _routed_graph()
    assert graph.kp.sig_mask is not None      # 400 edges, e_pad 16384
    ops = {}

    def layer(device, x, w, b):
        if device not in ops:
            g = graph.to(device)
            ops[device] = (make_hyper_ops(g, absorb=absorb), g.kp)
        (gather, scatter), kp = ops[device]
        if absorb:
            return scatter(InteractAbsorbFn.apply(gather(x), w, b, kp.i.p2,
                                                  kp.sig_mask, 3))
        return scatter(InteractFn.apply(gather(x), w, b, 3))

    g = torch.Generator().manual_seed(2)
    x = torch.randn(graph.node_count, 32, generator=g)
    w = torch.randn(7 * 32, 32, generator=g) / 15
    b = torch.randn(32, generator=g)
    before = _routed_launches()
    cuda = _grads(dev, layer, x, w, b)
    launched = {k: v - before[k] for k, v in _routed_launches().items()}
    if absorb:
        want = dict(gather_rows=2, gather_rows_t=4, row_local_permute=0,
                    transposed_local_permute=8, csr_segment_sum3=2,
                    interact_fwd=0, interact_bwd=0, interact_fwd_absorb=1,
                    interact_bwd_absorb=1)
    else:
        want = dict(gather_rows=2, gather_rows_t=4, row_local_permute=2,
                    transposed_local_permute=10, csr_segment_sum3=2,
                    interact_fwd=1, interact_bwd=1, interact_fwd_absorb=0,
                    interact_bwd_absorb=0)
    assert launched == want
    _assert_grads_close(cuda, _grads(torch.device("cpu"), layer, x, w, b))


def test_sigma_to_edge_order_grads_on_card_match_cpu(dev):
    graph = _routed_graph()
    kps = {}

    def relabel(device, edge):
        if device not in kps:
            kps[device] = graph.kp.to(device)
        return sigma_to_edge_order(edge, kps[device])

    edge = torch.randn(graph.kp.e_pad, 32,
                       generator=torch.Generator().manual_seed(5))
    cuda = _grads(dev, relabel, edge)
    cpu = _grads(torch.device("cpu"), relabel, edge)
    for a, c in zip(cuda[0] + cuda[1], cpu[0] + cpu[1]):
        assert torch.equal(a, c)


def test_routed_backward_is_bitwise_repeatable(dev):
    """The absorbed layer's backward: no atomics, so two runs agree."""
    graph = _routed_graph().to(dev)
    kp = graph.kp
    gather, scatter = make_hyper_ops(graph, absorb=True)
    g = _gen(dev, 6)
    x = torch.randn(graph.node_count, 32, device=dev, generator=g)
    w = torch.randn(7 * 32, 32, device=dev, generator=g) / 15
    b = torch.randn(32, device=dev, generator=g)
    cot = torch.randn(graph.node_count, 32, device=dev, generator=g)
    grads = []
    for _ in range(2):
        xs = [t.clone().requires_grad_() for t in (x, w, b)]
        scatter(InteractAbsorbFn.apply(gather(xs[0]), xs[1], xs[2], kp.i.p2,
                                       kp.sig_mask, 3)).backward(cot)
        grads.append([t.grad for t in xs])
    for a, c in zip(*grads):
        assert torch.equal(a, c)


def test_routed_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.randn(128, 128, 32, device=dev)
    p = _perm_table(dev, 128, 128, 3)
    with pytest.raises(ValueError):                  # int64 table
        row_local_permute(x, p.long())
    with pytest.raises(ValueError):                  # table of another grid
        transposed_local_permute(x, p[:64])
    with pytest.raises(ValueError):                  # 12-byte rows
        row_local_permute(torch.randn(128, 128, 3, device=dev), p)
    with pytest.raises(ValueError):                  # f64 rows
        row_local_permute(x.double(), p)
    with pytest.raises(ValueError):                  # int64 index
        gather_rows(x[0], p.long())
    u = torch.randn(1000, 32, device=dev)
    w = torch.randn(96, 32, device=dev)
    with pytest.raises(ValueError):                  # pi not a grid of E
        interact_fwd_absorb(u, u, u, p, w, torch.randn(32, device=dev), 1)
    with pytest.raises(RuntimeError):                # needs a gradient
        row_local_permute(x.requires_grad_(), p)


# ---------------------------------------------------------------------------
# the bf16 forms (ModelConfig.bf16_stream): K2, K1, K3 and interact_bwd
# ---------------------------------------------------------------------------
#
# Tolerances: K2's bf16 form is a copy of x rounded to bf16, bitwise the
# twin's. K1's bf16 forms sum the widened rows in f32 in another order than
# the twin: 1e-5 absolute in f32; rounded to bf16, within 1 bf16 ulp of the
# larger of the two values. K3's and interact_bwd's bf16 outputs: within 1
# bf16 ulp of the larger of the two values plus 1e-5 of the tensor's
# largest value (f32 sums in another order round a value near a rounding
# boundary the other way; a cancelling sum near 0 adds the floor); dW and
# db in f32, 1e-4 of their largest value, as the f32 form's.

BF16 = torch.bfloat16


def _bf16_ulp(t):
    """One bf16 ulp at |t|, elementwise (f32)."""
    _, e = torch.frexp(t.float().abs())
    return torch.where(t == 0, torch.zeros_like(t, dtype=torch.float32),
                       torch.ldexp(torch.ones_like(t, dtype=torch.float32),
                                   e - 8))


def _assert_bf16_ulp(got, want, name=""):
    assert got.dtype == want.dtype == BF16, name
    a, b = got.float(), want.float()
    tol = _bf16_ulp(torch.maximum(a.abs(), b.abs())) \
        + 1e-5 * b.abs().max().item()
    bad = (a - b).abs() > tol
    assert not bad.any().item(), (name, int(bad.sum().item()),
                                  (a - b).abs().max().item())


@pytest.mark.parametrize("x_bf16", [False, True])
@pytest.mark.parametrize("d,edges", [(4, 1), (8, 999), (32, 4097),
                                     (64, 300), (32, 0)])
def test_gather_roles_bf16(dev, d, edges, x_bf16):
    g = _gen(dev, d + edges)
    x = torch.randn(777, d, device=dev, generator=g)
    if x_bf16:
        x = x.to(BF16)
    i3 = torch.randint(0, 777, (edges, 3), device=dev, generator=g).int()
    before = (gather_roles.launches, gather_roles.launches_bf16)
    got = gather_roles(x, i3, BF16)
    torch.cuda.synchronize()
    assert got.dtype == BF16 and got.shape == (3, edges, d)
    assert (gather_roles.launches, gather_roles.launches_bf16) == \
        (before[0], before[1] + (edges > 0))
    assert torch.equal(got, gather_roles_plain(x, i3, BF16))


@pytest.mark.parametrize("d", [4, 16, 32, 48, 96])
def test_csr_gather_sum_bf16(dev, d):
    col, rowptr = _csr(dev, 900, 500, 6000, d)
    x = torch.randn(500, d, device=dev, generator=_gen(dev, d)).to(BF16)
    before = (csr_gather_sum.launches, csr_gather_sum.launches_bf16)
    got = csr_gather_sum(x, col, rowptr)
    got16 = csr_gather_sum(x, col, rowptr, out_dtype=BF16)
    torch.cuda.synchronize()
    assert (csr_gather_sum.launches, csr_gather_sum.launches_bf16) == \
        (before[0], before[1] + 2)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, csr_gather_sum_plain(x, col, rowptr),
                               rtol=0, atol=1e-5)
    assert torch.equal(got, csr_gather_sum(x, col, rowptr))
    _assert_bf16_ulp(got16, csr_gather_sum_plain(x, col, rowptr,
                                                 out_dtype=BF16))
    assert torch.equal(got16, got.to(BF16))


def test_csr_gather_sum_bf16_mixed_segment_lengths(dev):
    col, rowptr, _ = _mixed_csr(dev, 3000, 5)
    x = torch.randn(3000, 32, device=dev, generator=_gen(dev, 6)).to(BF16)
    got = csr_gather_sum(x, col, rowptr)
    torch.testing.assert_close(got, csr_gather_sum_plain(x, col, rowptr),
                               rtol=1e-5, atol=1e-5)


def test_csr_gather_sum_bf16_fixed_width(dev):
    """The scatter's backward on bf16 streams: 3 bf16 rows an edge summed
    in f32 and rounded once, bitwise the CSR form's result rounded."""
    g = _gen(dev, 19)
    cot = torch.randn(777, 32, device=dev, generator=g).to(BF16)
    col = torch.randint(0, 777, (3 * 5001,), device=dev, generator=g).int()
    rowptr = torch.arange(0, 3 * 5001 + 1, 3, device=dev).int()
    got = csr_gather_sum(cot, col, rowptr, width=3, out_dtype=BF16)
    assert got.dtype == BF16
    assert torch.equal(got, csr_gather_sum(cot, col, rowptr).to(BF16))
    _assert_bf16_ulp(got, csr_gather_sum_plain(cot, col, rowptr,
                                               out_dtype=BF16))
    empty = csr_gather_sum(cot, col[:0], rowptr[:1], width=3,
                           out_dtype=BF16)
    assert empty.shape == (0, 32)


def _hub_csr(dev, segments, rows, seed):
    """_csr with one segment of 6000 entries among empty and short ones."""
    col, rowptr = _csr(dev, segments, rows, 8 * segments, seed)
    counts = (rowptr[1:] - rowptr[:-1]).long()
    counts[segments // 2] = 6000
    ptr = torch.zeros(segments + 1, dtype=torch.int64, device=dev)
    ptr[1:] = counts.cumsum(0)
    col = torch.randint(0, rows, (int(ptr[-1].item()),), device=dev,
                        generator=_gen(dev, seed + 1))
    return col.int(), ptr.int()


def _assert_sums_f64(got, x, col, rowptr):
    """Each f32 segment sum within 2e-6 a term of its length (plus 1e-6)
    of the float64 sum of the same rows."""
    counts = (rowptr[1:] - rowptr[:-1]).long()
    seg = torch.repeat_interleave(
        torch.arange(counts.numel(), device=got.device), counts)
    exact = torch.zeros(counts.numel(), x.shape[1], dtype=torch.float64,
                        device=got.device).index_add_(
        0, seg, x.double()[col.long()])
    tol = (2e-6 * counts + 1e-6).double()[:, None]
    assert ((got.double() - exact).abs() <= tol).all()


BF16_LANE_WIDTHS = [8, 16, 24, 32, 40, 64, 128, 136]


@pytest.mark.parametrize("d", BF16_LANE_WIDTHS + [12])
def test_csr_gather_sum_bf16_lane_forms(dev, d):
    """K1's bf16 forms in both lane widths, on empty segments and a hub of
    6000 entries: each f32 sum within 2e-6 a term of the float64 sum,
    rounded once into bf16, and the 16-byte lanes (d % 8 == 0, 16-byte
    aligned rows) bit for bit the 8-byte lanes (the same rows 8 bytes off
    a 16-byte boundary)."""
    col, rowptr = _hub_csr(dev, 700, 900, seed=d)
    x = torch.randn(900, d, device=dev, generator=_gen(dev, d)).to(BF16)
    x8 = rows_at(x, 8)
    assert bf16_form(d, x) == (16 if d % 8 == 0 else 8)
    assert bf16_form(d, x8) == 8
    before = csr_gather_sum.launches_bf16
    got = csr_gather_sum(x, col, rowptr)
    got16 = csr_gather_sum(x, col, rowptr, out_dtype=BF16)
    torch.cuda.synchronize()
    assert csr_gather_sum.launches_bf16 == before + 2
    _assert_sums_f64(got, x, col, rowptr)
    assert torch.equal(got16, got.to(BF16))
    assert torch.equal(got, csr_gather_sum(x8, col, rowptr))
    assert torch.equal(got16, csr_gather_sum(x8, col, rowptr,
                                             out_dtype=BF16))
    assert (got[(rowptr[1:] == rowptr[:-1])] == 0).all()


@pytest.mark.parametrize("d", BF16_LANE_WIDTHS + [12])
def test_csr_gather_sum_bf16_fixed_width_lane_forms(dev, d):
    """The scatter's backward (3 entries a segment, into bf16) in both lane
    widths: bit for bit the CSR form rounded, and each other."""
    g = _gen(dev, 40 + d)
    cot = torch.randn(777, d, device=dev, generator=g).to(BF16)
    col = torch.randint(0, 777, (3 * 4001,), device=dev, generator=g).int()
    rowptr = torch.arange(0, 3 * 4001 + 1, 3, device=dev).int()
    got = csr_gather_sum(cot, col, rowptr, width=3, out_dtype=BF16)
    assert torch.equal(got, csr_gather_sum(cot, col, rowptr).to(BF16))
    assert torch.equal(got, csr_gather_sum(rows_at(cot, 8), col, rowptr,
                                           width=3, out_dtype=BF16))
    _assert_bf16_ulp(got, csr_gather_sum_plain(cot, col, rowptr,
                                               out_dtype=BF16))


@pytest.mark.parametrize("out_dtype", [None, BF16])
@pytest.mark.parametrize("d", BF16_LANE_WIDTHS + [12])
def test_csr_segment_sum3_bf16_lane_forms(dev, out_dtype, d):
    """The three-region bf16 form over regions of 1021 rows (not a power
    of two), entries in all three regions, empty segments and a hub: bit
    for bit K1's single-table bf16 form on the concatenation, in both lane
    widths; f32 sums within 2e-6 a term of float64, bf16 sums 1 ulp from
    the twin."""
    m = 1021
    col, rowptr = _hub_csr(dev, 600, 3 * m, seed=60 + d)
    for r in range(3):
        assert ((col >= r * m) & (col < (r + 1) * m)).any()
    g = _gen(dev, 61 + d)
    u, q, i = (torch.randn(m, d, device=dev, generator=g).to(BF16)
               for _ in range(3))
    before = csr_segment_sum3.launches_bf16
    got = csr_segment_sum3(u, q, i, col, rowptr, out_dtype)
    torch.cuda.synchronize()
    assert csr_segment_sum3.launches_bf16 == before + 1
    assert torch.equal(got, csr_gather_sum(torch.cat([u, q, i]), col, rowptr,
                                           out_dtype=out_dtype))
    shifted = [rows_at(t, 8) for t in (u, q, i)]
    assert bf16_form(d, *shifted) == 8
    assert torch.equal(got, csr_segment_sum3(*shifted, col, rowptr,
                                             out_dtype))
    if out_dtype is None:
        _assert_sums_f64(got, torch.cat([u, q, i]), col, rowptr)
    else:
        _assert_bf16_ulp(got, csr_segment_sum3_plain(u, q, i, col, rowptr,
                                                     out_dtype))


def test_bf16_lane_forms_refuse_misaligned_rows(dev):
    """Rows aligned to less than 8 bytes take no bf16 form."""
    col = torch.zeros(3, dtype=torch.int32, device=dev)
    rowptr = torch.tensor([0, 3], dtype=torch.int32, device=dev)
    x = rows_at(torch.randn(4, 32, device=dev).to(BF16), 2)
    assert bf16_form(32, x) == 0
    with pytest.raises(ValueError, match="bf16 forms are vector forms"):
        csr_gather_sum(x, col, rowptr)
    with pytest.raises(ValueError, match="vector form"):
        csr_segment_sum3(x, x, x, col, rowptr)


def _bf16_inputs(dev, edges, d, out, order, seed):
    u, q, i, w, cot = _bwd_inputs(dev, edges, d, out, order, seed)
    b = torch.randn(out, device=dev, generator=_gen(dev, seed + 1))
    return u.to(BF16), q.to(BF16), i.to(BF16), w, b, cot.to(BF16)


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("d,out", [(d, o) for d in (32, 16, 8, 24, 64)
                                   for o in KERNEL_OUT_DIMS])
def test_interact_fwd_bf16(dev, order, d, out):
    u, q, i, w, b, _ = _bf16_inputs(dev, 3 * 128 + 5, d, out, order,
                                    10 * order + d + out)
    before = (interact_fwd.launches, interact_fwd.launches_bf16)
    got = interact_fwd(u, q, i, w, b, order)
    torch.cuda.synchronize()
    assert (interact_fwd.launches, interact_fwd.launches_bf16) == \
        (before[0], before[1] + 1)
    _assert_bf16_ulp(got, interact_fwd_plain(u, q, i, w, b, order))
    assert torch.equal(got, interact_fwd(u, q, i, w, b, order))


@pytest.mark.parametrize("edges", [0, 1, 15, 17, 100, 4099, 100_003])
def test_interact_fwd_bf16_ragged_tails(dev, edges):
    u, q, i, w, b, _ = _bf16_inputs(dev, edges, 32, 32, 3, edges)
    got = interact_fwd(u, q, i, w, b, 3)
    assert got.shape == (edges, 32) and got.dtype == BF16
    if edges:
        _assert_bf16_ulp(got, interact_fwd_plain(u, q, i, w, b, 3))


def _assert_bwd_bf16_close(got, want):
    (gr, gw, gb), (wr, ww, wb) = got, want
    for r, name in enumerate(("du", "dq", "di")):
        _assert_bf16_ulp(gr[r], wr[r], name)
    for name, a, c in (("dw", gw, ww), ("db", gb, wb)):
        assert a.dtype == torch.float32, name
        torch.testing.assert_close(a, c, rtol=0,
                                   atol=1e-4 * c.abs().max().item(),
                                   msg=name)


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("out", KERNEL_OUT_DIMS)
@pytest.mark.parametrize("edges", [1, 999, 4097])
def test_interact_bwd_bf16(dev, order, out, edges):
    u, q, i, w, _, cot = _bf16_inputs(dev, edges, 32, out, order,
                                      order + out + edges)
    before = (interact_bwd.launches, interact_bwd.launches_bf16)
    got = interact_bwd(u, q, i, w, cot, order)
    torch.cuda.synchronize()
    assert (interact_bwd.launches, interact_bwd.launches_bf16) == \
        (before[0], before[1] + 1)
    _assert_bwd_bf16_close(got, interact_bwd_plain(u, q, i, w, cot, order))


@pytest.mark.parametrize("order", [1, 3])
@pytest.mark.parametrize("d,out", [(8, 32), (16, 16), (24, 8), (48, 64),
                                   (96, 32)])
def test_interact_bwd_bf16_widths(dev, order, d, out):
    u, q, i, w, _, cot = _bf16_inputs(dev, 2 * CHUNK_EDGES + 77, d, out,
                                      order, d + out)
    _assert_bwd_bf16_close(interact_bwd(u, q, i, w, cot, order),
                           interact_bwd_plain(u, q, i, w, cot, order))


def test_interact_bf16_empty_and_repeatable(dev):
    u, q, i, w, b, cot = _bf16_inputs(dev, 0, 32, 32, 3, 5)
    droles, dw, db = interact_bwd(u, q, i, w, cot, 3)
    assert droles.shape == (3, 0, 32) and droles.dtype == BF16
    assert not dw.any() and not db.any()
    u, q, i, w, b, cot = _bf16_inputs(dev, 50_001, 32, 32, 3, 6)
    first = interact_bwd(u, q, i, w, cot, 3)
    second = interact_bwd(u, q, i, w, cot, 3)
    for a, c in zip(first, second):
        assert torch.equal(a, c)


def test_bf16_wrappers_refuse_what_no_form_takes(dev):
    u = torch.randn(40, 12, device=dev).to(BF16)        # d % 8 != 0
    with pytest.raises(ValueError, match="multiple of 8"):
        interact_fwd(u, u, u, torch.randn(36, 8, device=dev),
                     torch.randn(8, device=dev), 1)
    with pytest.raises(ValueError, match="multiple of 8"):
        interact_bwd(u, u, u, torch.randn(36, 8, device=dev),
                     torch.randn(40, 8, device=dev).to(BF16), 1)
    v = torch.randn(40, 16, device=dev).to(BF16)
    w, b = torch.randn(48, 8, device=dev), torch.randn(8, device=dev)
    with pytest.raises(ValueError, match="no bf16 form"):
        interact_fwd_cores(v, v, v, w, b, 1)
    with pytest.raises(ValueError, match="one dtype"):   # f32 cot
        interact_bwd(v, v, v, w, torch.randn(40, 8, device=dev), 1)
    with pytest.raises(ValueError, match="w and b"):     # bf16 W
        interact_fwd(v, v, v, w.to(BF16), b, 1)
    pi = torch.zeros(4, 10, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="no bf16 form"):
        interact_fwd_absorb_cores(v, v, v, pi, w, b, 1)
    col = torch.zeros(3, dtype=torch.int32, device=dev)
    rowptr = torch.tensor([0, 3], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="no weight"):
        csr_gather_sum(v, col, rowptr, torch.ones(3, device=dev))
    with pytest.raises(ValueError, match="bf16 forms are vector forms"):
        csr_gather_sum(torch.randn(4, 6, device=dev).to(BF16), col, rowptr)
    with pytest.raises(ValueError, match="no form rounds"):
        csr_gather_sum(torch.randn(4, 8, device=dev), col, rowptr,
                       out_dtype=BF16)
    x6 = torch.randn(4, 6, device=dev).to(BF16)         # d % 4 != 0
    with pytest.raises(ValueError, match="vector form"):
        csr_segment_sum3(x6, x6, x6, col, rowptr)
    with pytest.raises(ValueError):                      # bf16 x, f32 roles
        gather_roles(v, torch.zeros(4, 3, dtype=torch.int32, device=dev),
                     torch.float32)


def test_bf16_functions_grads_on_card_match_cpu(dev):
    """GatherRolesFn, InteractFn and SpmmFn on bf16 streams, as the IHGNN
    layer composes them: values and gradients on the card against the
    plain twins on the CPU; the bf16 forms launch, the f32 forms do not."""
    graph = _small_graph()
    ops = {}

    def layer(device, x, w, b):
        if device not in ops:
            ops[device] = make_hyper_ops(graph.to(device), bf16_stream=True)
        gather, scatter = ops[device]
        edge = InteractFn.apply(gather(x), w, b, 3)
        assert edge.dtype == BF16
        return scatter(edge)

    g = torch.Generator().manual_seed(4)
    x = torch.randn(graph.node_count, 32, generator=g)
    w = torch.randn(7 * 32, 32, generator=g) / 15
    b = torch.randn(32, generator=g)
    counts = lambda: (csr_gather_sum.launches,  # noqa: E731
                      csr_gather_sum.launches_bf16, gather_roles.launches,
                      gather_roles.launches_bf16, interact_fwd.launches,
                      interact_fwd.launches_bf16, interact_bwd.launches,
                      interact_bwd.launches_bf16)
    before = counts()
    cuda = _grads(dev, layer, x, w, b)
    assert tuple(a - c for a, c in zip(counts(), before)) == \
        (0, 3, 0, 1, 0, 1, 0, 1)
    cpu = _grads(torch.device("cpu"), layer, x, w, b)
    # the node sums of bf16 edge rows: f32 sums in another order, with the
    # bf16 edge rows themselves within an ulp (1e-2 of scale holds a few
    # flipped roundings of rows that then sum)
    for a, c in zip(cuda[0] + cuda[1], cpu[0] + cpu[1]):
        torch.testing.assert_close(a, c, rtol=0,
                                   atol=1e-2 * c.abs().max().item())


# ---------------------------------------------------------------------------
# the routed pack's bf16 forms: gather_rows[_t], the three-region K1, K5, K8
# ---------------------------------------------------------------------------
#
# Tolerances as for the direct path's bf16 forms above. K5's bf16 backward
# runs interact_bwd's bf16 arithmetic on the merged cotangent, so it is also
# held bit for bit to interact_bwd's bf16 form on the pre-permuted inputs;
# K8's bf16 form sums in K1's order, bit for bit K1's bf16 forms over the
# same entries; o2 is a copy of o1.


@pytest.mark.parametrize("x_bf16", [False, True])
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("d", [4, 8, 32])
def test_gather_rows_bf16(dev, transposed, x_bf16, d):
    g = _gen(dev, 11 + d)
    x = torch.randn(999, d, device=dev, generator=g)
    if x_bf16:
        x = x.to(BF16)
    idx = torch.randint(0, 999, (128, 256), device=dev, generator=g).int()
    fn = gather_rows_t if transposed else gather_rows
    before = (fn.launches, fn.launches_bf16)
    got = fn(x, idx, dtype=BF16)
    torch.cuda.synchronize()
    assert (fn.launches, fn.launches_bf16) == (before[0], before[1] + 1)
    assert got.dtype == BF16
    assert torch.equal(got, gather_rows_plain(x, idx, transposed, BF16))
    out = torch.empty_like(got)
    assert fn(x, idx, out=out) is out and torch.equal(out, got)


@pytest.mark.parametrize("out_dtype", [None, BF16])
@pytest.mark.parametrize("d", [4, 8, 32, 64])
def test_csr_segment_sum3_bf16(dev, out_dtype, d):
    """Three bf16 regions: the f32 sums bit for bit K1's bf16 form on the
    concatenation, within 1e-5 of the twin; rounded once with
    ``out_dtype``."""
    col, rowptr = _csr(dev, 1000, 3 * 700, 9000, seed=12 + d)
    g = _gen(dev, 13 + d)
    u, q, i = (torch.randn(700, d, device=dev, generator=g).to(BF16)
               for _ in range(3))
    before = (csr_segment_sum3.launches, csr_segment_sum3.launches_bf16)
    got = csr_segment_sum3(u, q, i, col, rowptr, out_dtype)
    torch.cuda.synchronize()
    assert (csr_segment_sum3.launches, csr_segment_sum3.launches_bf16) == \
        (before[0], before[1] + 1)
    want = csr_gather_sum(torch.cat([u, q, i]), col, rowptr,
                          out_dtype=out_dtype)
    assert got.dtype == want.dtype and torch.equal(got, want)
    plain = csr_segment_sum3_plain(u, q, i, col, rowptr, out_dtype)
    if out_dtype is None:
        torch.testing.assert_close(got, plain, rtol=0, atol=1e-5)
    else:
        _assert_bf16_ulp(got, plain)


def _absorb_bf16(dev, rows, cols, d, order, seed, masked, out=32):
    u, q, i_t1, pi, w, b, c1, c2, mask = _absorb_inputs(
        dev, rows, cols, d, order, seed, masked, out)
    return (u.to(BF16), q.to(BF16), i_t1.to(BF16), pi, w, b, c1.to(BF16),
            c2.to(BF16), mask)


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("rows,cols,d,out", [(16, 128, 32, 32),
                                             (40, 256, 16, 8),
                                             (300, 8, 8, 64),
                                             (3, 1024, 24, 16)])
def test_interact_absorb_bf16(dev, order, masked, rows, cols, d, out):
    """K5's bf16 forms against their twins (1 bf16 ulp; dW, db 1e-4), o2 a
    copy of o1 through ρ, the backward bit for bit ``interact_bwd``'s bf16
    form on the pre-permuted inputs; masked σ pads reach no gradient."""
    u, q, i_t1, pi, w, b, c1, c2, mask = _absorb_bf16(
        dev, rows, cols, d, order, 7 * order + rows + masked, masked, out)
    before = (interact_fwd_absorb.launches_bf16,
              interact_bwd_absorb.launches_bf16,
              interact_fwd_absorb.launches, interact_bwd_absorb.launches)
    o1, o2 = interact_fwd_absorb(u, q, i_t1, pi, w, b, order)
    got = interact_bwd_absorb(u, q, i_t1, pi, w, c1, c2, mask, order)
    torch.cuda.synchronize()
    assert (interact_fwd_absorb.launches_bf16 - before[0],
            interact_bwd_absorb.launches_bf16 - before[1],
            interact_fwd_absorb.launches - before[2],
            interact_bwd_absorb.launches - before[3]) == (1, 1, 0, 0)
    p1, p2 = interact_fwd_absorb_plain(u, q, i_t1, pi, w, b, order)
    _assert_bf16_ulp(o1, p1, "o1")
    _assert_bf16_ulp(o2, p2, "o2")
    e_pi = (torch.arange(rows, device=dev)[:, None] * cols
            + pi.long()).view(-1)
    assert torch.equal(o2[e_pi], o1)
    _assert_identity(got, interact_bwd_absorb_via_direct(
        u, q, i_t1, pi, w, c1, c2, mask, order))
    _assert_bwd_bf16_close(got, interact_bwd_absorb_plain(
        u, q, i_t1, pi, w, c1, c2, mask, order))
    if masked:
        pads = mask == 0
        assert (got[0][0][pads] == 0).all() and (got[0][1][pads] == 0).all()
    again = interact_bwd_absorb(u, q, i_t1, pi, w, c1, c2, mask, order)
    _assert_identity(got, again)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("out", KERNEL_OUT_DIMS)
@pytest.mark.parametrize("rows,cols", [(7, 256), (3, 1024), (2, 4096),
                                       (37, 9), (5, 100)])
def test_interact_bwd_absorb_bf16_chunks(dev, masked, out, rows, cols):
    """K5's bf16 backward where a tile's e_pi and mask are staged: a
    chunk across grid rows (cols 256, 9, 100), inside one (1024, 4096),
    E not a multiple of the 32-edge tile (333, 500), no mask: bit for bit
    ``interact_bwd``'s bf16 form on the pre-permuted inputs, 1 bf16 ulp
    (dW, db 1e-4) from the twin, at orders 3 and 1."""
    for order in (3, 1):
        u, q, i_t1, pi, w, _, c1, c2, mask = _absorb_bf16(
            dev, rows, cols, 16, order, rows + cols + out, masked, out)
        got = interact_bwd_absorb(u, q, i_t1, pi, w, c1, c2, mask, order)
        _assert_identity(got, interact_bwd_absorb_via_direct(
            u, q, i_t1, pi, w, c1, c2, mask, order))
        _assert_bwd_bf16_close(got, interact_bwd_absorb_plain(
            u, q, i_t1, pi, w, c1, c2, mask, order))


# The bf16 backward's design (persistent blocks that walk their chunks in
# turn through a ring of 64-edge stages) and K2's bf16 form (an f32 x
# rounded once into a bf16 table, then 16- or 8-byte row copies).


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("out", KERNEL_OUT_DIMS)
@pytest.mark.parametrize("edges", [1, 31, 1023, 1025, 33 * 1024 + 17])
def test_interact_bwd_bf16_edge_counts(dev, order, out, edges):
    """Part of a tile, a chunk less one edge, a chunk and one, and 34
    chunks with a ragged last (fewer chunks than the blocks the card
    holds): 1 bf16 ulp (dW, db 1e-4) from the twin, bit for bit a second
    run."""
    u, q, i, w, _, cot = _bf16_inputs(dev, edges, 32, out, order,
                                      edges + 7 * out + order)
    got = interact_bwd(u, q, i, w, cot, order)
    _assert_bwd_bf16_close(got, interact_bwd_plain(u, q, i, w, cot, order))
    again = interact_bwd(u, q, i, w, cot, order)
    for a, c in zip((*got[0], *got[1:]), (*again[0], *again[1:])):
        assert torch.equal(a, c)


@pytest.mark.parametrize("order", [1, 3])
def test_interact_bwd_bf16_several_chunks_a_block(dev, order):
    """1200 chunks and a ragged one, more than the card holds blocks at
    once, so each block walks several: as the twin (1 bf16 ulp, dW and db
    1e-4), and each chunk's du, dq, di bit for bit that chunk run alone
    (the first, one in the middle, the ragged last)."""
    edges = 1200 * CHUNK_EDGES + 77
    u, q, i, w, _, cot = _bf16_inputs(dev, edges, 32, 32, order, 90 + order)
    got = interact_bwd(u, q, i, w, cot, order)
    _assert_bwd_bf16_close(got, interact_bwd_plain(u, q, i, w, cot, order))
    for c in (0, 617, 1200):
        rows = slice(c * CHUNK_EDGES, min((c + 1) * CHUNK_EDGES, edges))
        alone = interact_bwd(u[rows].contiguous(), q[rows].contiguous(),
                             i[rows].contiguous(), w,
                             cot[rows].contiguous(), order)
        assert torch.equal(alone[0], got[0][:, rows]), c


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("out", KERNEL_OUT_DIMS)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("rows,cols", [(300, 9), (41, 100), (5, 1024),
                                       (3, 4096)])
def test_interact_bwd_absorb_bf16_cols(dev, order, out, masked, rows, cols):
    """K5's bf16 backward at d = 32 with grid rows of 9 and 100 edges (a
    64-edge tile across grid rows) and 1024, 4096 (inside one): bit for bit
    ``interact_bwd``'s bf16 form on the pre-permuted inputs, 1 bf16 ulp
    (dW, db 1e-4) from the twin; masked σ pads reach no gradient."""
    u, q, i_t1, pi, w, _, c1, c2, mask = _absorb_bf16(
        dev, rows, cols, 32, order, 3 * rows + cols + out + masked, masked,
        out)
    got = interact_bwd_absorb(u, q, i_t1, pi, w, c1, c2, mask, order)
    _assert_identity(got, interact_bwd_absorb_via_direct(
        u, q, i_t1, pi, w, c1, c2, mask, order))
    _assert_bwd_bf16_close(got, interact_bwd_absorb_plain(
        u, q, i_t1, pi, w, c1, c2, mask, order))
    if masked:
        pads = mask == 0
        assert (got[0][0][pads] == 0).all() and (got[0][1][pads] == 0).all()


@pytest.mark.parametrize("d,out,runs", [(120, 32, True), (128, 32, False),
                                        (88, 64, True), (96, 64, False)])
def test_interact_bwd_bf16_widest_rows(dev, d, out, runs):
    """At order 3 the bf16 backward takes d up to 120 at out = 32 and 88
    at out = 64 (W, the staged output rows and two stages in one block's
    shared memory); the entry point refuses a wider d and the wrapper
    raises."""
    u, q, i, w, _, cot = _bf16_inputs(dev, CHUNK_EDGES + 5, d, out, 3, d)
    if runs:
        _assert_bwd_bf16_close(interact_bwd(u, q, i, w, cot, 3),
                               interact_bwd_plain(u, q, i, w, cot, 3))
    else:
        with pytest.raises(RuntimeError, match="CUDA error"):
            interact_bwd(u, q, i, w, cot, 3)


@pytest.mark.parametrize("x_bf16", [False, True])
@pytest.mark.parametrize("d", [8, 12, 32, 64])
def test_gather_roles_bf16_forms(dev, d, x_bf16):
    """K2's bf16 form at both copy widths (16 bytes for d % 8 == 0, else
    8), from an f32 x (rounded into a table) and a bf16 x, on a ragged E
    whose ids reach the last row: bit for bit the twin and x rounded then
    gathered, one launch counted. A bf16 x 8 bytes off a 16-byte boundary
    takes the 8-byte copy with the same bits; 4 bytes off, it is refused;
    an f32 x 8 bytes off is refused (its rounding reads 16-byte vectors)."""
    g = _gen(dev, 40 + d)
    n, e = 5003, 3 * 1024 + 5
    x = torch.randn(n, d, device=dev, generator=g) * 3
    i3 = torch.randint(0, n, (e, 3), device=dev, generator=g).int()
    i3[0], i3[-1] = 0, n - 1
    rows = x.to(BF16) if x_bf16 else x
    before = (gather_roles.launches, gather_roles.launches_bf16)
    got = gather_roles(rows, i3, BF16)
    torch.cuda.synchronize()
    assert (gather_roles.launches, gather_roles.launches_bf16) == \
        (before[0], before[1] + 1)
    assert torch.equal(got, gather_roles_plain(rows, i3, BF16))
    assert torch.equal(got, x.to(BF16)[i3.t().long()])
    out = torch.empty(3, e, d, dtype=BF16, device=dev)
    assert bf16_form(d, x.to(BF16), *out) == (16 if d % 8 == 0 else 8)
    shifted = rows_at(rows, 8)
    if x_bf16:
        assert bf16_form(d, shifted, *out) == 8
        assert torch.equal(gather_roles(shifted, i3, BF16), got)
        with pytest.raises(ValueError, match="8-byte aligned"):
            gather_roles(rows_at(rows, 4), i3, BF16)
    else:
        with pytest.raises(ValueError, match="16-byte aligned"):
            gather_roles(shifted, i3, BF16)


def test_round_bf16_is_nearest_even(dev):
    """K2's rounding kernel gives PyTorch's cast bit for bit: ties either
    way, subnormals, ±inf, values that round up to inf, any bit pattern."""
    f = np.float32
    one, half_ulp = f(1.0), f(2.0 ** -8)
    tiny = np.finfo(np.float32).tiny
    hard = np.array([0.0, -0.0, one + half_ulp, one + 3 * half_ulp,
                     tiny, -tiny / 2, f(1e-45), np.inf, -np.inf,
                     np.finfo(np.float32).max, f(3.3895314e38), f(-65504)],
                    np.float32)
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    anything = bits.view(np.float32)
    vals = np.concatenate([hard, anything[~np.isnan(anything)]])
    vals = vals[:len(vals) // 8 * 8].reshape(-1, 8)
    x = torch.from_numpy(vals).to(dev)
    got = round_bf16(x)
    assert got.dtype == BF16 and got.shape == x.shape
    assert torch.equal(got.view(torch.int16), x.to(BF16).view(torch.int16))


@pytest.mark.parametrize("d", [4, 8, 32, 64, 96])
@pytest.mark.parametrize("case", ["cross_one", "cross_many",
                                  "sentinel_blocks", "shuffled"])
def test_csr_segment_scan_bf16(dev, d, case):
    """K8's bf16 form: bit for bit K1's bf16 form over the same entries,
    within 1e-5 a term of its twin, repeatable."""
    if case == "shuffled":
        ids, n = _scan_ids(6, 50_000, 3000, True), 3003
    else:
        ids = _scan_shaped_ids(case)
        n = int(ids[ids != 2**31 - 1].max()) + 3
    pack = pack_scan_inputs(ids, n).to(dev)
    vals = torch.randn(len(ids), d, device=dev,
                       generator=_gen(dev, d)).to(BF16)
    before = (csr_segment_scan.launches, csr_segment_scan.launches_bf16)
    got = csr_segment_scan(vals, pack)
    torch.cuda.synchronize()
    assert (csr_segment_scan.launches, csr_segment_scan.launches_bf16) == \
        (before[0], before[1] + 1)
    assert got.dtype == torch.float32
    assert torch.equal(got, _k1_over(ids, vals, n))
    assert torch.equal(got, csr_segment_scan(vals, pack))
    longest = int((pack.rowptr[1:] - pack.rowptr[:-1]).max())
    torch.testing.assert_close(got, csr_segment_scan_plain(vals, pack),
                               rtol=0, atol=1e-5 * max(1, longest))


def test_routed_bf16_node_sums_agree(dev):
    """On a routed pack: K8's bf16 form and the bf16 three-region K1 on the
    same node-update stream, bit for bit."""
    kp = _routed_graph().kp.to(dev)
    stream = torch.randn(3 * kp.e_pad, 32, device=dev,
                         generator=_gen(dev, 30)).to(BF16)
    assert torch.equal(csr_segment_scan(stream, kp.scan),
                       csr_segment_sum3(*stream.view(3, kp.e_pad, 32),
                                        kp.seg_col, kp.seg_rowptr))


def _bf16_routed_launches():
    return {name: (globals()[name].launches,
                   globals()[name].launches_bf16)
            for name in _ROUTED_WRAPPERS}


@pytest.mark.parametrize("absorb", [False, True])
def test_routed_functions_bf16_on_card_match_cpu(dev, absorb):
    """One routed IHGNN layer on bf16 streams (absorbed or not) on the
    card against the CPU: the node sums and the gradients of x, W and b
    within 1e-2 of their largest values (twins and kernels round at the
    same points, but an f32 sum in another order may round an edge row the
    other way); the exact launches of one forward and backward, all in the
    bf16 forms."""
    graph = _routed_graph()
    ops = {}

    def layer(device, x, w, b):
        if device not in ops:
            g = graph.to(device)
            ops[device] = (make_hyper_ops(g, bf16_stream=True,
                                          absorb=absorb), g.kp)
        (gather, scatter), kp = ops[device]
        if absorb:
            return scatter(InteractAbsorbFn.apply(gather(x), w, b, kp.i.p2,
                                                  kp.sig_mask, 3))
        return scatter(InteractFn.apply(gather(x), w, b, 3))

    g = torch.Generator().manual_seed(2)
    x = torch.randn(graph.node_count, 32, generator=g)
    w = torch.randn(7 * 32, 32, generator=g) / 15
    b = torch.randn(32, generator=g)
    before = _bf16_routed_launches()
    cuda = _grads(dev, layer, x, w, b)
    launched = {k: (v[0] - before[k][0], v[1] - before[k][1])
                for k, v in _bf16_routed_launches().items()}
    if absorb:
        want = dict(gather_rows=2, gather_rows_t=4, row_local_permute=0,
                    transposed_local_permute=8, csr_segment_sum3=2,
                    interact_fwd=0, interact_bwd=0, interact_fwd_absorb=1,
                    interact_bwd_absorb=1)
    else:
        want = dict(gather_rows=2, gather_rows_t=4, row_local_permute=2,
                    transposed_local_permute=10, csr_segment_sum3=2,
                    interact_fwd=1, interact_bwd=1, interact_fwd_absorb=0,
                    interact_bwd_absorb=0)
    assert launched == {k: (0, v) for k, v in want.items()}
    cpu = _grads(torch.device("cpu"), layer, x, w, b)
    for a, c in zip(cuda[0] + cuda[1], cpu[0] + cpu[1]):
        assert a.dtype == c.dtype == torch.float32
        torch.testing.assert_close(a, c, rtol=0,
                                   atol=1e-2 * c.abs().max().item())


def test_routed_bf16_wrappers_refuse_what_no_form_takes(dev):
    x = torch.randn(100, 6, device=dev)                  # d % 4 != 0
    idx = torch.zeros(4, 8, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="multiple of 4"):
        gather_rows(x, idx, dtype=BF16)
    with pytest.raises(ValueError, match="f32 or bf16"):
        gather_rows_t(x, idx, dtype=torch.float16)
    r = torch.randn(8, 8, device=dev)
    col = torch.zeros(3, dtype=torch.int32, device=dev)
    rowptr = torch.tensor([0, 3], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="no form rounds"):
        csr_segment_sum3(r, r, r, col, rowptr, BF16)
    with pytest.raises(ValueError, match="all f32 or all bf16"):
        csr_segment_sum3(r.to(BF16), r, r, col, rowptr)
    pack = pack_scan_inputs(np.zeros(SCAN_BLOCK, np.int64), 1).to(dev)
    with pytest.raises(ValueError, match="multiple of 4"):
        csr_segment_scan(torch.randn(SCAN_BLOCK, 6, device=dev).to(BF16),
                         pack)


# ---------------------------------------------------------------------------
# the chunked pack and the routed 2D graph
# ---------------------------------------------------------------------------


def _chunked_graph(edges=40000, seed=0):
    """A hypergraph whose routed pack has 3 chunks (cap 128 rows at 128
    columns), the last one padded."""
    import dataclasses

    from ihgnn_torch.ops.packing import build_hyper_kernel_pack
    rng = np.random.default_rng(seed)
    users, queries, items = 50, 40, 60
    uqi = np.stack([rng.integers(0, users, edges),
                    rng.integers(0, queries, edges),
                    rng.integers(0, items, edges)], axis=1)
    graph = build_hypergraph(uqi, users + queries + items, users, queries)
    kp = build_hyper_kernel_pack(graph.i3.numpy(), graph.node_count,
                                 cols=128, chunk_rows_cap=128)
    assert len(kp.packs) == 3 and kp.absorbs
    assert kp.packs[-1].sig_mask is not None
    return dataclasses.replace(graph, kp=kp)


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_segment_sum3_spanning_chunks(dev, dtype):
    """K1's three-region form over the CSR spanning 3 chunks (each node's
    entries of chunk 0, then 1, then 2) against its twin: f32 and bf16
    regions (bf16 into f32 and into bf16)."""
    kp = _chunked_graph().kp.to(dev)
    g = _gen(dev, 40)
    u, q, i = (torch.randn(kp.e_pad, 32, device=dev, generator=g).to(dtype)
               for _ in range(3))
    outs = [None] if dtype == torch.float32 else [None, BF16]
    for out_dtype in outs:
        got = csr_segment_sum3(u, q, i, kp.seg_col, kp.seg_rowptr, out_dtype)
        want = csr_segment_sum3_plain(u, q, i, kp.seg_col, kp.seg_rowptr,
                                      out_dtype)
        if out_dtype == BF16:
            diff = (got.float() - want.float()).abs()
            assert (diff <= want.float().abs() / 128 + 1e-6).all()
        else:
            torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * (
                want.abs().max().item()))


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_segment_sum3_regions_past_2_31_bytes(dev, dtype):
    """K1's three-region form on regions of M rows that pass 2^31 bytes
    (M · d · size > 2^31): segments that read the last rows of each region
    sum exactly what float64 sums of those rows give."""
    m, d = 34_000_000, 32
    assert m * d * torch.tensor([], dtype=dtype).element_size() > 2 ** 31
    regions = [torch.empty(m, d, dtype=dtype, device=dev) for _ in range(3)]
    g = _gen(dev, 41)
    rows = torch.cat([torch.arange(m - 4000, m, device=dev),
                      torch.arange(0, 1000, device=dev)])
    for r in regions:
        r[rows] = torch.randn(rows.numel(), d, device=dev,
                              generator=g).to(dtype)
    segments = 500
    region = torch.randint(0, 3, (segments * 10,), device=dev, generator=g)
    pick = rows[torch.randint(0, rows.numel(), (segments * 10,), device=dev,
                              generator=g)]
    col = (region * m + pick).int()
    rowptr = torch.arange(0, segments * 10 + 1, 10, device=dev).int()
    got = csr_segment_sum3(*regions, col, rowptr)
    vals = torch.stack([regions[k][pick].double() for k in range(3)])
    want = vals[region, torch.arange(region.numel(), device=dev)]
    want = want.view(segments, 10, d).sum(1)
    torch.testing.assert_close(got.double(), want, rtol=0, atol=1e-4)
    assert (pick * d * regions[0].element_size() > 2 ** 31).any()


@pytest.mark.parametrize("count", [1, 3, 1000, 4096, 12_345_678])
@pytest.mark.parametrize("offset", [0, 1])
def test_gather_scalars(dev, count, offset):
    """K2's d = 1 form against its twin, bit for bit: counts that are and
    are not multiples of 4, ids that start on and off a 16-byte boundary
    (the four-a-thread and one-a-thread forms)."""
    from ihgnn_torch.ops.gather import gather_scalars, gather_scalars_plain
    g = _gen(dev, 42)
    x = torch.randn(700_000, device=dev, generator=g)
    idx = torch.randint(0, x.numel(), (count + offset,), device=dev,
                        generator=g).int()[offset:]
    before = gather_scalars.launches
    got = gather_scalars(x, idx)
    assert gather_scalars.launches == before + 1
    assert torch.equal(got, gather_scalars_plain(x, idx))
    with pytest.raises(ValueError, match="int32"):
        gather_scalars(x, idx.long())


def test_chunked_functions_grads_on_card_match_cpu(dev):
    """One IHGNN layer on the chunked pack (the absorbed interaction over
    the stacked tables), and the σ → edge relabelling, on the card against
    the CPU: values and gradients within 1e-5 of their largest values; the
    launches of one forward and backward (3 chunks)."""
    graph = _chunked_graph(seed=1)
    kp_cpu = graph.kp
    ops = {}

    def layer(device, x, w, b):
        if device not in ops:
            g = graph.to(device)
            ops[device] = (make_hyper_ops(g, absorb=True), g.kp)
        (gather, scatter), kp = ops[device]
        pi, mask = kp.absorb_tables()
        pair = InteractAbsorbFn.apply(gather(x), w, b, pi, mask, 3)
        return scatter(pair), sigma_to_edge_order(pair[0], kp)

    g = torch.Generator().manual_seed(3)
    x = torch.randn(kp_cpu.node_count, 32, generator=g)
    w = torch.randn(7 * 32, 32, generator=g) / 15
    b = torch.randn(32, generator=g)
    before = _routed_launches()
    cuda = _grads(dev, layer, x, w, b)
    launched = {k: v - before[k] for k, v in _routed_launches().items()}
    c = len(kp_cpu.packs)
    assert launched == dict(
        gather_rows=2 * c, gather_rows_t=4 * c, row_local_permute=2 * c,
        transposed_local_permute=8 * c, csr_segment_sum3=2, interact_fwd=0,
        interact_bwd=0, interact_fwd_absorb=1, interact_bwd_absorb=1)
    _assert_grads_close(cuda, _grads(torch.device("cpu"), layer, x, w, b))


def _packed_graph2d():
    rng = np.random.default_rng(3)
    users, queries, items, p = 40, 25, 60, 700
    uqif = np.stack([rng.integers(0, users, p), rng.integers(0, queries, p),
                     rng.integers(0, items, p),
                     (rng.random(p) > 0.1).astype(np.int64)], axis=1)
    return build_graph2d(uqif, users + queries + items, users, queries,
                         pack_kernels=True)


def test_routed_spmm_grads_on_card_match_cpu(dev):
    """``RoutedSpmmFn`` on the card against the CPU, value and gradient,
    with its launches: K2 ``gather_rows_t``, K7, K6 and K1 a call."""
    from ihgnn_torch.ops.hyperagg import RoutedSpmmFn
    graph = _packed_graph2d()
    graphs = {}

    def spmm(device, x):
        if device not in graphs:
            graphs[device] = graph.to(device)
        gr = graphs[device]
        return RoutedSpmmFn.apply(x, gr.pk_role, gr.pk_entry, gr.rowptr,
                                  gr.val)

    x = torch.randn(graph.node_count, 32,
                    generator=torch.Generator().manual_seed(4))
    names = ("gather_rows_t", "transposed_local_permute",
             "row_local_permute", "csr_gather_sum")
    before = [globals()[k].launches for k in names]
    cuda = _grads(dev, spmm, x)
    assert [globals()[k].launches - v for k, v in zip(names, before)] \
        == [2, 2, 2, 2]
    _assert_grads_close(cuda, _grads(torch.device("cpu"), spmm, x))


@pytest.mark.parametrize("pack", ["single", "chunked"])
@pytest.mark.parametrize("head", [V.CONCAT, V.PRODUCT])
def test_routed_gat_grads_on_card_match_cpu(dev, head, pack):
    """``RoutedGatConvFn`` on the card against the CPU (both heads; the
    graph's one pack, and a ``ChunkedGatPack`` of the same entries split
    by source region): the output and the gradients of x, the head's
    kernel and bias (those within 1e-5 of the largest gradient of x)."""
    from ihgnn_torch.ops.gatconv import RoutedGatConvFn
    from ihgnn_torch.ops.gatpack import ChunkedGatPack, build_gat_pack
    graph = _packed_graph2d()
    pk = graph.gat_pk
    if pack == "chunked":
        att = graph.attention
        pk = build_gat_pack(att.src.numpy(), att.dst.numpy(),
                            graph.node_count,
                            live=graph.val[graph.dst_order.long()].numpy(),
                            cols=128, chunk_rows_cap=4, src_cuts=(40, 65))
        assert isinstance(pk, ChunkedGatPack)
    packs = {}

    def conv(device, x, k, b):
        if device not in packs:
            packs[device] = pk.to(device)
        return RoutedGatConvFn.apply(x, k, b, packs[device], head)

    g = torch.Generator().manual_seed(5)
    x = torch.randn(graph.node_count, 32, generator=g)
    k = torch.randn(64 if head == V.CONCAT else 32, generator=g) / 8
    b = torch.randn(1, generator=g)
    cuda = _grads(dev, conv, x, k, b)
    _assert_grads_close(cuda, _grads(torch.device("cpu"), conv, x, k, b),
                        head_grads=(1, 2))
