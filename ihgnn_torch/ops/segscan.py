"""K8: the segment-sum of a block-sorted entry stream by a segmented scan,
its host pack and its plain twin.

Counterpart of ``ihgnn_tpu/ops/pallas/segscan.py`` ``csr_segment_scan_t``
(``:294``) and ``pack_scan_inputs`` (``:69``). The contract is that of
``csr_segment_sum_t(out_transposed=True)``: ``out[n] = Σ values[k]`` over
the entries with ``ids[k] == n``, accumulated in f32, for an id stream
that is sorted at ``BLOCK``-entry granularity, in any order within a block
(the Clos stage fusions of the routed pack shuffle entries only within
blocks), with int32-max sentinels dropped.

The TPU sorts each 128-lane sub-block with a routed butterfly, scans it
with masked rolls and places the run totals with a second butterfly, from
two packed words an entry. On the card the host packs the in-block order
instead (``pack_scan_inputs``): each block's entries sorted by id, and a
head and a tail flag on the first and last entry of each run of equal
ids. One warp owns the runs that start in its block and walks them in
sorted order, each lane carrying one feature's running sum, and writes
each run's total at its tail; a run that crosses into later blocks is
followed there by the warp that started it, so each segment is written
once, with no atomics.

Layout: ``values`` ``[K, d]`` f32 row-major (K a multiple of ``BLOCK``);
the result ``[num_segments, d]`` f32, 0 for a segment with no entry.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ihgnn_torch.device import DeviceLike, moved
from ihgnn_torch.ops import _build
from ihgnn_torch.ops.segment import segment_sum

BLOCK = 1024                 # entries a warp owns (ihgnn_tpu segsum BLOCK)
SENTINEL = 2 ** 31 - 1
HEAD, TAIL = 1, 2            # flag bits: first / last entry of a run
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


@dataclasses.dataclass(frozen=True)
class ScanPack:
    """The in-block order of an id stream, for ``csr_segment_scan``."""

    order: torch.Tensor   # [K] int32 — stream position of each sorted entry
    ids: torch.Tensor     # [K] int32 — its id (SENTINEL for a dropped one)
    flags: torch.Tensor   # [K] uint8 — HEAD | TAIL bits of its run
    num_segments: int

    def to(self, device: DeviceLike) -> "ScanPack":
        return moved(self, device)


def pack_scan_inputs(ids: np.ndarray, num_segments: int) -> ScanPack:
    """A CPU ``ScanPack`` of the id stream ``ids`` ``[K]`` (K a multiple of
    BLOCK). Raises unless every non-sentinel id lies in ``[0,
    num_segments)`` and the non-sentinel ids, sorted within each block,
    never decrease from block to block."""
    ids = np.asarray(ids, np.int64)
    k = ids.shape[0]
    if k % BLOCK:
        raise ValueError(f"the stream length {k} is not a multiple of "
                         f"{BLOCK}")
    in_block = np.argsort(ids.reshape(-1, BLOCK), axis=1, kind="stable")
    order = (in_block + np.arange(0, k, BLOCK)[:, None]).reshape(-1)
    s = ids[order]
    real = np.flatnonzero(s != SENTINEL)
    r = s[real]
    if len(r) and (r.min() < 0 or r.max() >= num_segments):
        raise ValueError(f"ids must lie in [0, {num_segments}) or be the "
                         "int32-max sentinel")
    if np.any(np.diff(r) < 0):
        raise ValueError("the ids are not sorted at block granularity")
    flags = np.zeros(k, np.uint8)
    if len(r):
        change = r[1:] != r[:-1]
        flags[real] = (np.concatenate([[True], change]) * HEAD
                       + np.concatenate([change, [True]]) * TAIL)
    return ScanPack(order=torch.from_numpy(order.astype(np.int32)),
                    ids=torch.from_numpy(s.astype(np.int32)),
                    flags=torch.from_numpy(flags),
                    num_segments=int(num_segments))


def csr_segment_scan_plain(values: torch.Tensor, pack: ScanPack
                           ) -> torch.Tensor:
    """Plain twin of ``csr_segment_scan`` (any device)."""
    real = pack.ids != SENTINEL
    vals = values.index_select(0, pack.order[real].long()).float()
    return segment_sum(vals, pack.ids[real], pack.num_segments)


def csr_segment_scan(values: torch.Tensor, pack: ScanPack) -> torch.Tensor:
    """``[num_segments, d]`` f32 segment-sum of the ``[K, d]`` stream
    ``values`` whose ids ``pack`` holds. CPU tensors run the plain twin;
    CUDA tensors launch ``csrc/segscan.cu`` and count one in
    ``csr_segment_scan.launches``."""
    what = "csr_segment_scan"
    if values.dim() != 2 or values.shape[0] != pack.order.shape[0]:
        raise ValueError(f"{what}: values {tuple(values.shape)} do not fit "
                         f"a stream of {pack.order.shape[0]} entries")
    if not _build.use_kernel(what, values, pack.order, pack.ids, pack.flags):
        return csr_segment_scan_plain(values, pack)
    _build.require(values.dtype == torch.float32 and values.is_contiguous(),
                   what, "values must be contiguous f32")
    k, d = values.shape
    out = torch.zeros(pack.num_segments, d, dtype=torch.float32,
                      device=values.device)
    if k == 0 or d == 0:
        return out
    fn = _build.function("segscan", "ihgnn_csr_segment_scan", _ARGTYPES)
    err = fn(values.data_ptr(), pack.order.data_ptr(), pack.ids.data_ptr(),
             pack.flags.data_ptr(), out.data_ptr(), k, d, BLOCK,
             _build.stream_ptr(values.device))
    _build.check("segscan", what, err)
    csr_segment_scan.launches += 1
    return out


csr_segment_scan.launches = 0
