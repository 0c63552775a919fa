"""K8: the segment-sum of a block-sorted entry stream, its host pack and
its plain twin.

Counterpart of ``ihgnn_tpu/ops/pallas/segscan.py`` ``csr_segment_scan_t``
(``:294``) and ``pack_scan_inputs`` (``:69``). The contract is that of
``csr_segment_sum_t(out_transposed=True)``: ``out[n] = Σ values[k]`` over
the entries with ``ids[k] == n``, accumulated in f32, for an id stream
that is sorted at ``BLOCK``-entry granularity, in any order within a block
(the Clos stage fusions of the routed pack shuffle entries only within
blocks), with int32-max sentinels dropped.

The TPU sorts each 128-lane sub-block with a routed butterfly, scans it
with masked rolls and places the run totals with a second butterfly, from
two packed words an entry. On the card the host packs the sorted order
instead (``pack_scan_inputs``): the stream position of each real entry,
sorted by id and in stream order within an id (``pos``), each segment's
range of it (``rowptr``), and the segments each 1024-entry block owns
(``block_seg``: those whose first entry lies in the block). One thread
block of the kernel stages its stream block's rows in shared memory and
sums its segments from there, side by side; a segment that runs on into
later blocks is finished from device memory by the block that owns its
head, so each segment is written once, with no atomics, in stream order:
bit for bit what K1 gives over the same entries.

Layout: ``values`` ``[K, d]`` f32 row-major (K a multiple of ``BLOCK``);
the result ``[num_segments, d]`` f32, 0 for a segment with no entry.
bf16 ``values`` (the routed pack's bf16 streams; ``csr_segment_scan_t``
stages the stream's dtype and widens it to f32, ``segscan.py:260``,
``:318``) run the kernel's bf16 form (d % 4 == 0): the same f32 sums, bit
for bit K1's bf16 three-region form over the same entries, counted in
``csr_segment_scan.launches_bf16``.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ihgnn_torch.device import DeviceLike, moved
from ihgnn_torch.ops import _build
from ihgnn_torch.ops.segment import segment_ids, segment_sum

BLOCK = 1024                 # entries a kernel block owns (ihgnn_tpu BLOCK)
SENTINEL = 2 ** 31 - 1
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


@dataclasses.dataclass(frozen=True)
class ScanPack:
    """The sorted order of a block-sorted id stream, for
    ``csr_segment_scan``."""

    pos: torch.Tensor        # [K_real] int32 — stream position, by id
    rowptr: torch.Tensor     # [N+1] int32 — segment n's range of pos
    block_seg: torch.Tensor  # [B+1] int32 — block b owns segments
                             # [block_seg[b], block_seg[b+1])
    num_segments: int
    stream_len: int          # K = B · BLOCK

    def to(self, device: DeviceLike) -> "ScanPack":
        return moved(self, device)


def pack_scan_inputs(ids: np.ndarray, num_segments: int) -> ScanPack:
    """A CPU ``ScanPack`` of the id stream ``ids`` ``[K]`` (K a multiple of
    BLOCK). Raises unless every non-sentinel id lies in ``[0,
    num_segments)`` and the non-sentinel ids, sorted within each block,
    never decrease from block to block.

    A segment's owner is the block of its first entry; a segment without
    entries goes with the next segment that has one (the last block when
    none has), so each block owns a consecutive range of segments."""
    ids = np.asarray(ids, np.int64)
    k = ids.shape[0]
    if k % BLOCK:
        raise ValueError(f"the stream length {k} is not a multiple of "
                         f"{BLOCK}")
    in_block = np.argsort(ids.reshape(-1, BLOCK), axis=1, kind="stable")
    order = (in_block + np.arange(0, k, BLOCK)[:, None]).reshape(-1)
    s = ids[order]
    real = s != SENTINEL
    r = s[real]
    if len(r) and (r.min() < 0 or r.max() >= num_segments):
        raise ValueError(f"ids must lie in [0, {num_segments}) or be the "
                         "int32-max sentinel")
    if np.any(np.diff(r) < 0):
        raise ValueError("the ids are not sorted at block granularity")
    pos = order[real]
    rowptr = np.searchsorted(r, np.arange(num_segments + 1))
    blocks = k // BLOCK
    # the block of each segment's first entry, an empty segment taking the
    # next one's: the first entry at or after rowptr[n]
    heads = np.append(pos, blocks * BLOCK - 1)[rowptr[:-1]] // BLOCK
    block_seg = np.searchsorted(heads, np.arange(blocks + 1))
    block_seg[-1] = num_segments
    return ScanPack(pos=torch.from_numpy(pos.astype(np.int32)),
                    rowptr=torch.from_numpy(rowptr.astype(np.int32)),
                    block_seg=torch.from_numpy(block_seg.astype(np.int32)),
                    num_segments=int(num_segments), stream_len=int(k))


def csr_segment_scan_plain(values: torch.Tensor, pack: ScanPack
                           ) -> torch.Tensor:
    """Plain twin of ``csr_segment_scan`` (any device)."""
    vals = values.index_select(0, pack.pos.long()).float()
    return segment_sum(vals, segment_ids(pack.rowptr), pack.num_segments)


def csr_segment_scan(values: torch.Tensor, pack: ScanPack) -> torch.Tensor:
    """``[num_segments, d]`` f32 segment-sum of the ``[K, d]`` stream
    ``values`` (f32 or bf16) whose ids ``pack`` holds. CPU tensors run the
    plain twin; CUDA tensors launch ``csrc/segscan.cu`` and count one in
    ``csr_segment_scan.launches`` (f32 values) or
    ``csr_segment_scan.launches_bf16`` (bf16 values)."""
    what = "csr_segment_scan"
    if values.dim() != 2 or values.shape[0] != pack.stream_len:
        raise ValueError(f"{what}: values {tuple(values.shape)} do not fit "
                         f"a stream of {pack.stream_len} entries")
    if not _build.use_kernel(what, values, pack.pos, pack.rowptr,
                             pack.block_seg):
        return csr_segment_scan_plain(values, pack)
    bf16 = values.dtype == torch.bfloat16
    if bf16:
        _build.require(values.is_contiguous() and values.shape[1] % 4 == 0
                       and values.data_ptr() % 16 == 0, what,
                       "bf16 values must be contiguous and 16-byte aligned, "
                       "d a multiple of 4")
    else:
        _build.require(values.dtype == torch.float32
                       and values.is_contiguous()
                       and (values.shape[1] % 4
                            or values.data_ptr() % 16 == 0), what,
                       "values must be contiguous f32, 16-byte aligned when "
                       "d is a multiple of 4")
    k, d = values.shape
    if k == 0 or d == 0:
        return torch.zeros(pack.num_segments, d, dtype=torch.float32,
                           device=values.device)
    out = torch.empty(pack.num_segments, d, dtype=torch.float32,
                      device=values.device)
    fn = _build.function("segscan", "ihgnn_csr_segment_scan_bf16" if bf16
                         else "ihgnn_csr_segment_scan", _ARGTYPES)
    err = fn(values.data_ptr(), pack.pos.data_ptr(), pack.rowptr.data_ptr(),
             pack.block_seg.data_ptr(), out.data_ptr(), k, d, BLOCK,
             _build.stream_ptr(values.device))
    _build.check("segscan", what, err)
    _build.count(csr_segment_scan, bf16)
    return out


csr_segment_scan.launches = 0
csr_segment_scan.launches_bf16 = 0
