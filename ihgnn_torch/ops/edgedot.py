"""The per-entry dot of two gathered rows over a CSR, its column order and
its plain twin.

  csr_edge_dot(a, b, order)[k] = <a[s], b[order.col[k]]>,
      k ∈ [order.rowptr[s], order.rowptr[s+1])

Not a port of one TPU kernel: on the TPU the attention's per-entry dots
(``ihgnn_tpu/ops/gatconv.py:256-263,299-300``) are K2 ``windowed_gather``
plus the K6/K7 permute stages expanding both operands into ``[d, K]``
streams, then an XLA multiply-reduce. Here the two row gathers are folded
into the dot (``csrc/edgedot.cu``), as K1 folds its gather. It serves the
GAT backward's ``<x[src], cot[dst]>``, the product head's scores and that
head's backward.

The CSR comes as an ``EdgeDotOrder``, which ``edge_dot_order`` builds once
per CSR on the host: the CSR itself, which the plain twin reads, and the
order the kernel reads it in, made from it: the entries cut into chunks of
at most ``CHUNK`` entries spanning at most ``SPAN`` segments, each chunk
sorted by column, so that the blocks of the card sweep ``b`` together and
find its rows in L2. ``AttentionCSR.dot_order`` builds it at first use.

Layout: ``a`` ``[S', d]`` (S' ≥ S) and ``b`` ``[M, d]`` contiguous f32 with
d a multiple of 4 and 16-byte aligned data; the result is f32 ``[K]``.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ihgnn_torch.device import DeviceLike, moved
from ihgnn_torch.ops import _build
from ihgnn_torch.ops.segment import segment_ids

CHUNK = 3072        # entries a chunk (one block of the kernel) holds at most
SPAN = 256          # segments a chunk spans at most (its staged a rows)
SLOT_BITS = 16      # slot = (segment - chunk's first) << 16 | position
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p])


@dataclasses.dataclass(frozen=True)
class EdgeDotOrder:
    """A CSR and, made from it, its chunks with each chunk's entries sorted
    by column: the twin reads the first two fields, the kernel the rest."""

    col: torch.Tensor          # [K] int32 — column of each entry
    rowptr: torch.Tensor       # [S+1] int32
    chunk_ptr: torch.Tensor    # [C+1] int32 — first entry of each chunk
    chunk_segs: torch.Tensor   # [C, 2] int32 — its first and last segment
    sorted_col: torch.Tensor   # [K] int32 — column of each sorted entry
    slot: torch.Tensor         # [K] int32 — its segment and position

    @property
    def entry_count(self) -> int:
        return self.col.shape[0]

    def to(self, device: DeviceLike) -> "EdgeDotOrder":
        return moved(self, device)


def chunk_bounds(rowptr: np.ndarray) -> np.ndarray:
    """``[C+1]`` entry offsets cutting the CSR's entries, in order, into
    chunks of at most ``CHUNK`` entries whose entries lie in at most
    ``SPAN`` consecutive segments, each chunk as long as both allow."""
    rowptr = np.asarray(rowptr, np.int64)
    k, s = int(rowptr[-1]), len(rowptr) - 1
    bounds = [0]
    while bounds[-1] < k:
        k0 = bounds[-1]
        s0 = int(np.searchsorted(rowptr, k0, side="right")) - 1
        bounds.append(min(k0 + CHUNK, int(rowptr[min(s0 + SPAN, s)])))
    return np.asarray(bounds, np.int64)


def edge_dot_order(col, rowptr) -> EdgeDotOrder:
    """The ``EdgeDotOrder`` of the CSR (``col`` ``[K]``, ``rowptr``
    ``[S+1]``; tensors or arrays): ``chunk_bounds``, then each chunk's
    entries sorted by column, ties in entry order. Built on the host; the
    result lies on ``col``'s device and holds int32 ``col`` and ``rowptr``
    themselves, not copies."""
    col_t = torch.as_tensor(col).to(torch.int32)
    rowptr_t = torch.as_tensor(rowptr).to(col_t.device, torch.int32)
    col = col_t.cpu().numpy().astype(np.int64)
    rowptr = rowptr_t.cpu().numpy().astype(np.int64)
    k, s = len(col), len(rowptr) - 1
    if rowptr[0] != 0 or rowptr[-1] != k or np.any(np.diff(rowptr) < 0):
        raise ValueError("rowptr must rise from 0 to the entry count")
    bounds = chunk_bounds(rowptr)
    sizes = np.diff(bounds)
    chunk_of = np.repeat(np.arange(len(sizes)), sizes)
    seg = np.repeat(np.arange(s), np.diff(rowptr))
    first = seg[bounds[:-1]]
    last = seg[bounds[1:] - 1] if k else first
    # one sort of distinct keys (chunk, column, position in the chunk)
    m = int(col.max(initial=-1)) + 1
    if len(sizes) * m * CHUNK >= 2 ** 63:
        raise ValueError("the CSR is too large for edge_dot_order's keys")
    key = (chunk_of * m + col) * CHUNK + (np.arange(k) - bounds[chunk_of])
    key.sort()
    pos = key % CHUNK
    entry = bounds[chunk_of] + pos
    slot = ((seg[entry] - first[chunk_of]) << SLOT_BITS) | pos

    def made(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a.astype(np.int32)).to(col_t.device)

    return EdgeDotOrder(
        col=col_t, rowptr=rowptr_t, chunk_ptr=made(bounds),
        chunk_segs=made(np.stack([first, last], axis=1)),
        sorted_col=made(key // CHUNK % max(m, 1)), slot=made(slot))


def csr_edge_dot_plain(a: torch.Tensor, b: torch.Tensor, col: torch.Tensor,
                       rowptr: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of ``csr_edge_dot`` (any device)."""
    return (a[segment_ids(rowptr)] * b[col.long()]).sum(1)


def csr_edge_dot(a: torch.Tensor, b: torch.Tensor,
                 order: EdgeDotOrder) -> torch.Tensor:
    """``[K]`` dots of ``a``'s segment row with ``b``'s entry row over the
    CSR of ``order`` (see the module docstring). CPU tensors run the plain
    twin; CUDA tensors launch ``csrc/edgedot.cu`` and count one in
    ``csr_edge_dot.launches``."""
    what = "csr_edge_dot"
    col, rowptr = order.col, order.rowptr
    if not _build.use_kernel(what, a, b, col, rowptr, order.sorted_col):
        return csr_edge_dot_plain(a, b, col, rowptr)
    for name, t in (("a", a), ("b", b)):
        _build.require(t.dim() == 2 and t.dtype == torch.float32
                       and t.is_contiguous() and t.data_ptr() % 16 == 0,
                       what, f"{name} must be contiguous 16-byte aligned "
                       "[rows, d] f32")
    d = a.shape[1]
    _build.require(b.shape[1] == d and d % 4 == 0 and d > 0, what,
                   "a and b must have one width d, a multiple of 4")
    s = rowptr.shape[0] - 1
    _build.require(a.shape[0] >= s, what, f"a has fewer than {s} rows")
    out = torch.empty(col.shape[0], dtype=torch.float32, device=a.device)
    chunks = order.chunk_ptr.shape[0] - 1
    if chunks == 0:
        return out
    fn = _build.function("edgedot", "ihgnn_csr_edge_dot", _ARGTYPES)
    err = fn(a.data_ptr(), b.data_ptr(), order.chunk_ptr.data_ptr(),
             order.chunk_segs.data_ptr(), order.sorted_col.data_ptr(),
             order.slot.data_ptr(), out.data_ptr(), chunks, d, CHUNK, SPAN,
             _build.stream_ptr(a.device))
    _build.check("edgedot", what, err)
    csr_edge_dot.launches += 1
    return out


csr_edge_dot.launches = 0


def resident_blocks(d: int) -> int:
    """Blocks of the kernel for width ``d`` that one SM of the current
    card holds at once (a wave is this times the SM count)."""
    blocks = ctypes.c_int(0)
    fn = _build.function("edgedot", "ihgnn_csr_edge_dot_resident",
                         [ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
    _build.check("edgedot", "resident_blocks", fn(d, ctypes.byref(blocks)))
    return blocks.value
