"""The host-side orders of ``csr_edge_dot`` and K8 ``csr_segment_scan``,
and each kernel's order of adds, on the CPU.

* ``edge_dot_order`` cuts a CSR's entries into chunks (at most ``CHUNK``
  entries over at most ``SPAN`` segments) and sorts each chunk by column:
  it is a permutation that keeps every entry in its chunk, and decoding its
  slots gives each entry's segment and position back. An emulation of
  ``csrc/edgedot.cu`` that reads its operands through the order (a group
  of G lanes an entry, one float4 of a slice a lane, a fixed butterfly of
  adds, slices added in turn) is held against the plain twin and against
  the JAX gatconv's per-entry dot (``ihgnn_tpu/ops/gatconv.py:299-300``,
  ``sum(xs * c, axis=0)``) at every group width.
* ``pack_scan_inputs`` gives the sorted order of a block-sorted id stream,
  the segments' ranges of it and the segments each block owns. On
  ``tests/test_segscan.py``'s streams it agrees with the JAX
  ``pack_scan_inputs`` (the same per-tile entry offsets). An emulation of
  ``csrc/segscan.cu`` (each block sums the segments it owns, from its
  window and past it, one f32 accumulator added in stream order) writes
  every segment once and equals K1's order of adds over the same entries
  bit for bit.

Tolerances: the emulated dot sums 4 to 136 products in another order than
the twin and XLA: 1e-5 of the largest output (the card tests' limit).
K8 against K1: bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ihgnn_torch.graph import build_attention_csr
from ihgnn_torch.ops.edgedot import (CHUNK, SLOT_BITS, SPAN, chunk_bounds,
                                     csr_edge_dot, csr_edge_dot_plain,
                                     edge_dot_order)
from ihgnn_torch.ops.segscan import BLOCK, SENTINEL, pack_scan_inputs
from ihgnn_tpu.ops.pallas.segscan import pack_scan_inputs as jax_scan_pack
from ihgnn_tpu.ops.pallas.segsum import TILE_N


# ---------------------------------------------------------------------------
# csr_edge_dot: the chunked column order
# ---------------------------------------------------------------------------


def _edge_csr(case: str):
    """(col, rowptr, rows of b) of one CSR shape."""
    rng = np.random.default_rng({"random": 0, "long": 1, "singles": 2,
                                 "empty": 3, "sparse": 4, "band": 5}[case])
    if case == "empty":
        counts = np.zeros(50, np.int64)
    elif case == "singles":          # span-bound chunks
        counts = np.ones(3000, np.int64)
    elif case == "sparse":           # most segments empty
        counts = rng.integers(0, 6, 4000) * (rng.random(4000) < 0.1)
    else:
        counts = rng.integers(0, 40, 1500)
        counts[rng.random(1500) < 0.2] = 0
        if case == "long":           # one segment over several chunks
            counts[700] = 3 * CHUNK + 77
    rowptr = np.concatenate([[0], np.cumsum(counts)])
    rows = 900
    k = int(rowptr[-1])
    col = (rng.integers(400, 460, k) if case == "band"
           else rng.integers(0, rows, k))
    return col, rowptr, rows


def _decoded(order, rowptr):
    """(segment, position) of each sorted entry, from the order's slots."""
    bounds = order.chunk_ptr.numpy().astype(np.int64)
    chunk_of = np.repeat(np.arange(len(bounds) - 1), np.diff(bounds))
    slot = order.slot.numpy().astype(np.int64)
    seg = order.chunk_segs.numpy()[chunk_of, 0] + (slot >> SLOT_BITS)
    pos = bounds[chunk_of] + (slot & ((1 << SLOT_BITS) - 1))
    return seg, pos, chunk_of


@pytest.mark.parametrize("case", ["random", "long", "singles", "empty",
                                  "sparse", "band"])
def test_edge_dot_order_is_a_permutation_within_chunks(case):
    col, rowptr, _ = _edge_csr(case)
    order = edge_dot_order(col, rowptr)
    bounds = order.chunk_ptr.numpy().astype(np.int64)
    k, s = len(col), len(rowptr) - 1
    assert bounds[0] == 0 and bounds[-1] == k
    np.testing.assert_array_equal(order.col.numpy(), col)
    np.testing.assert_array_equal(order.rowptr.numpy(), rowptr)
    assert np.all(np.diff(bounds) >= 1) and np.all(np.diff(bounds) <= CHUNK)
    np.testing.assert_array_equal(bounds, chunk_bounds(rowptr))
    seg_of = np.repeat(np.arange(s), np.diff(rowptr))
    segs = order.chunk_segs.numpy()
    if k:
        np.testing.assert_array_equal(segs[:, 0], seg_of[bounds[:-1]])
        np.testing.assert_array_equal(segs[:, 1], seg_of[bounds[1:] - 1])
        assert np.all(segs[:, 1] - segs[:, 0] < SPAN)
    # each chunk is as long as both limits allow
    for k0, k1 in zip(bounds[:-1], bounds[1:]):
        s0 = seg_of[k0]
        assert k1 == min(k0 + CHUNK, rowptr[min(s0 + SPAN, s)])
    seg, pos, chunk_of = _decoded(order, rowptr)
    np.testing.assert_array_equal(np.sort(pos), np.arange(k))
    assert np.all(pos >= bounds[chunk_of]) and np.all(pos < bounds[chunk_of
                                                                     + 1])
    np.testing.assert_array_equal(seg, seg_of[pos])
    sorted_col = order.sorted_col.numpy()
    np.testing.assert_array_equal(sorted_col, col[pos])
    # sorted by column within each chunk, ties in entry order
    key = chunk_of * (col.max(initial=0) + 1) + sorted_col
    assert np.all((np.diff(key) > 0)
                  | ((np.diff(key) == 0) & (np.diff(pos) > 0)))


def test_edge_dot_order_refuses_a_broken_rowptr():
    with pytest.raises(ValueError):
        edge_dot_order(np.zeros(5, np.int32), np.array([0, 3, 2, 5]))
    with pytest.raises(ValueError):
        edge_dot_order(np.zeros(5, np.int32), np.array([0, 3, 4]))


def test_edge_dot_order_holds_its_csr():
    """The order keeps the very col and rowptr tensors it was made from,
    the one CSR its twin and its kernel read; ``AttentionCSR`` builds it at
    first use only, keeps it, and a moved copy starts without it."""
    col, rowptr, rows = _edge_csr("random")
    tcol = torch.from_numpy(col.astype(np.int32))
    trow = torch.from_numpy(rowptr.astype(np.int32))
    order = edge_dot_order(tcol, trow)
    assert order.col is tcol and order.rowptr is trow
    s = len(rowptr) - 1
    csr = build_attention_csr(col, np.repeat(np.arange(s), np.diff(rowptr)),
                              rows, s)
    assert "dot_order" not in vars(csr)
    built = csr.dot_order
    assert csr.dot_order is built
    assert built.col is csr.src and built.rowptr is csr.dst_rowptr
    np.testing.assert_array_equal(built.sorted_col.numpy(),
                                  order.sorted_col.numpy())
    np.testing.assert_array_equal(built.slot.numpy(), order.slot.numpy())
    assert "dot_order" not in vars(csr.to("cpu"))


def _fma(a, b, c):
    """f32 fmaf: the exact product (float64 holds it) plus c, rounded once
    more to f32 (float64's own rounding of the sum is below f32's)."""
    return (a.double() * b.double() + c.double()).float()


def _emulated_edge_dot(a, b, order, d):
    """``csrc/edgedot.cu``'s arithmetic on the CPU, through ``order``."""
    d4 = d // 4
    g = 1 if d4 <= 1 else 2 if d4 <= 2 else 4 if d4 <= 4 else 8
    bounds = order.chunk_ptr.long()
    chunk_of = torch.repeat_interleave(torch.arange(len(bounds) - 1),
                                       bounds[1:] - bounds[:-1])
    slot = order.slot.long()
    seg = order.chunk_segs[:, 0].long()[chunk_of] + (slot >> SLOT_BITS)
    pos = bounds[chunk_of] + (slot & ((1 << SLOT_BITS) - 1))
    x = a[seg].view(-1, d4, 4)
    y = b[order.sorted_col.long()].view(-1, d4, 4)
    total = None
    for v0 in range(0, d4, g):
        xs = torch.zeros(len(seg), g, 4)
        ys = torch.zeros(len(seg), g, 4)
        w = min(g, d4 - v0)
        xs[:, :w], ys[:, :w] = x[:, v0:v0 + w], y[:, v0:v0 + w]
        lane = xs[..., 0] * ys[..., 0]
        for c in range(1, 4):
            lane = _fma(xs[..., c], ys[..., c], lane)
        idx = torch.arange(g)
        off = g // 2
        while off:
            lane = lane + lane[:, idx ^ off]
            off //= 2
        total = lane[:, 0] if total is None else total + lane[:, 0]
    out = torch.empty(len(seg))
    out[pos] = total
    return out


@pytest.mark.parametrize("d", [4, 8, 12, 32, 64, 136])
@pytest.mark.parametrize("case", ["random", "long", "band"])
def test_edge_dot_emulation_matches_twin_and_jax(d, case):
    """The kernel's order of adds within 1e-5 of the largest output from
    the twin and from the JAX gatconv's per-entry dot; ``a`` has more rows
    than segments."""
    col, rowptr, rows = _edge_csr(case)
    rng = np.random.default_rng(d)
    s = len(rowptr) - 1
    a = rng.standard_normal((s + 7, d)).astype(np.float32)
    b = rng.standard_normal((rows, d)).astype(np.float32)
    order = edge_dot_order(col, rowptr)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = _emulated_edge_dot(ta, tb, order, d)
    twin = csr_edge_dot(ta, tb, order)
    torch.testing.assert_close(twin, csr_edge_dot_plain(ta, tb, order.col,
                                                        order.rowptr),
                               rtol=0, atol=0)
    scale = twin.abs().max().item()
    torch.testing.assert_close(got, twin, rtol=0, atol=1e-5 * scale)
    # ihgnn_tpu/ops/gatconv.py:299-300: sum(xs * c, axis=0) over [d, K]
    seg = np.repeat(np.arange(s), np.diff(rowptr))
    xs = jnp.asarray(b.T)[:, col]
    c = jnp.asarray(a.T)[:, seg]
    want = np.asarray(jnp.sum(xs * c, axis=0))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * scale)


# ---------------------------------------------------------------------------
# K8: the scan pack and the kernel's order of adds
# ---------------------------------------------------------------------------


def _scan_ids(seed, k, n, shuffle=True):
    """``tests/test_segscan.py``'s id streams: k sorted ids in [0, n),
    shuffled within each block, int32-max padded to a whole block."""
    rng = np.random.default_rng(seed)
    k_pad = -(-max(k, 1) // BLOCK) * BLOCK
    ids = np.sort(rng.integers(0, n, size=k))
    if shuffle:
        for b in range(0, k - BLOCK + 1, BLOCK):
            rng.shuffle(ids[b:b + BLOCK])
    return np.concatenate([ids, np.full(k_pad - k, SENTINEL, np.int64)])


def _shaped_ids(case: str):
    """Streams of the shapes the kernel must get right: runs crossing one,
    two and many blocks, blocks of sentinels only, a block that is one
    run."""
    rng = np.random.default_rng(7)
    if case == "cross_one":       # runs of ~1.5 blocks: each crosses one
        ids = np.repeat(np.arange(20), 1536)
    elif case == "cross_two":     # a run of 2.5 blocks among short ones
        ids = np.concatenate([np.arange(300), np.full(2560, 300),
                              np.arange(301, 301 + 1236)])
    elif case == "cross_many":    # one run over 20 blocks
        ids = np.concatenate([np.arange(100), np.full(20 * BLOCK, 100),
                              np.arange(101, 101 + 924)])
    elif case == "sentinel_blocks":   # whole blocks of padding in between
        ids = np.concatenate([np.sort(rng.integers(0, 50, BLOCK)),
                              np.full(2 * BLOCK, SENTINEL),
                              np.sort(rng.integers(50, 90, BLOCK - 10)),
                              np.full(10, SENTINEL)])
    else:                         # "one_run": a block that is one run
        ids = np.concatenate([np.sort(rng.integers(0, 30, BLOCK)),
                              np.full(BLOCK, 30),
                              np.sort(rng.integers(31, 60, BLOCK))])
    ids = ids.astype(np.int64)
    for b in range(0, len(ids), BLOCK):
        rng.shuffle(ids[b:b + BLOCK])
    return ids


_SEGSCAN_STREAMS = [(0, 5000, 700, False), (1, 5000, 700, True),
                    (2, 4096, 10, True), (3, 2000, 3000, True)]


@pytest.mark.parametrize("seed,k,n,shuffle", _SEGSCAN_STREAMS)
def test_scan_pack_agrees_with_jax_pack(seed, k, n, shuffle):
    """On ``tests/test_segscan.py``'s four streams: the segments' ranges
    meet the JAX pack's per-tile entry offsets, and ``pos`` lists every
    real entry once, sorted by id, in stream order within an id."""
    ids = _scan_ids(seed, k, n, shuffle)
    pack = pack_scan_inputs(ids, n)
    jpack = jax_scan_pack(ids, n)
    tile_ptr = np.asarray(jpack.tile_ptr)
    rowptr = pack.rowptr.numpy()
    bounds = np.minimum(np.arange(len(tile_ptr)) * TILE_N, n)
    np.testing.assert_array_equal(rowptr[bounds], tile_ptr)
    real = ids != SENTINEL
    np.testing.assert_array_equal(
        pack.pos.numpy(), np.argsort(ids, kind="stable")[:real.sum()])
    assert pack.stream_len == len(ids) and pack.num_segments == n


def _k1_sums(ids, vals, n):
    """K1's order of adds over the same entries: each segment's stream
    positions in stream order (a stable sort by id), one f32 accumulator
    from 0 (a cumulative sum is sequential in f32)."""
    order = np.argsort(ids, kind="stable")[:int((ids != SENTINEL).sum())]
    rowptr = np.searchsorted(ids[order], np.arange(n + 1))
    out = np.zeros((n, vals.shape[1]), np.float32)
    for s in range(n):
        if rowptr[s + 1] > rowptr[s]:
            out[s] = np.cumsum(vals[order[rowptr[s]:rowptr[s + 1]]], axis=0,
                               dtype=np.float32)[-1]
    return out


def _emulated_scan(pack, vals):
    """``csrc/segscan.cu`` on the CPU: block b sums the segments it owns,
    each from its first entry (which lies in b's window) on, past the
    window where the run goes on; every segment is written once."""
    pos, rowptr = pack.pos.numpy(), pack.rowptr.numpy()
    block_seg = pack.block_seg.numpy()
    n = pack.num_segments
    out = np.full((n, vals.shape[1]), np.nan, np.float32)
    written = np.zeros(n, np.int64)
    for b in range(len(block_seg) - 1):
        for s in range(block_seg[b], block_seg[b + 1]):
            rows = pos[rowptr[s]:rowptr[s + 1]]
            assert np.all(rows >= b * BLOCK)
            assert len(rows) == 0 or rows[0] < (b + 1) * BLOCK
            assert np.all(np.diff(rows) > 0)
            out[s] = (np.cumsum(vals[rows], axis=0, dtype=np.float32)[-1]
                      if len(rows) else 0.0)
            written[s] += 1
    np.testing.assert_array_equal(written, 1)
    return out


@pytest.mark.parametrize("case", ["segscan0", "segscan1", "segscan2",
                                  "segscan3", "cross_one", "cross_two",
                                  "cross_many", "sentinel_blocks",
                                  "one_run"])
def test_scan_emulation_equals_k1_order(case):
    if case.startswith("segscan"):
        seed, k, n, shuffle = _SEGSCAN_STREAMS[int(case[-1])]
        ids = _scan_ids(seed, k, n, shuffle)
    else:
        ids = _shaped_ids(case)
        n = int(ids[ids != SENTINEL].max()) + 3    # trailing empty segments
    vals = np.random.default_rng(5).standard_normal(
        (len(ids), 8)).astype(np.float32)
    pack = pack_scan_inputs(ids, n)
    got = _emulated_scan(pack, vals)
    np.testing.assert_array_equal(got, _k1_sums(ids, vals, n))


def test_scan_pack_owner_ranges():
    """Each block owns a consecutive range of segments; together they cover
    every segment; a block whose rows all continue earlier runs, or are
    all sentinels, owns none."""
    ids = _shaped_ids("cross_many")
    n = 1030
    pack = pack_scan_inputs(ids, n)
    block_seg = pack.block_seg.numpy()
    assert block_seg[0] == 0 and block_seg[-1] == n
    assert np.all(np.diff(block_seg) >= 0)
    owned = np.diff(block_seg)
    assert (owned == 0).sum() >= 18    # the middle of the 20-block run
    ids = _shaped_ids("sentinel_blocks")
    pack = pack_scan_inputs(ids, 95)
    np.testing.assert_array_equal(np.diff(pack.block_seg.numpy())[1:3], 0)
