"""The routed GAT's host pack: a destination-sorted edge list → the index
tables of ``RoutedGatConvFn`` (``ops/gatconv.py``), built once on the host.

Counterpart of ``ihgnn_tpu/ops/gatconv.py`` ``GatPack``, ``ChunkedGatPack``
and ``build_gat_pack`` (``gatconv.py:45-188``). The entries keep their
destination order; on the ``pick_grid(nnz, cols)`` grid a pack holds:

* ``src`` — the non-σ ``RolePack`` of the source ids (``ops/packing.py``):
  its forward chain gives ``x[src]`` in entry order, its backward chain
  (stages 0 and 1) the t1 order whose ids ``src.seg_ids`` are; the
  source sums are K1 over the CSR ``(src_col, src_rowptr)`` of those ids;
* ``dst_idx`` — each entry's destination, the pads repeating the last one:
  the index table of the expands by destination (K2, ``gather_rows`` and
  its d = 1 form ``gather_scalars``);
* ``dst_rowptr`` with ``entry`` (``0..nnz-1``) — the destination CSR over
  entry positions, for K4, the scalar sum and K1;
* ``mask`` — 1 at the live entries (``live > 0``), 0 at the masked ones
  and the pads.

Past ``chunk_rows_cap · cols`` entries, or whenever ``src_cuts`` is given,
the list splits into contiguous chunks, and a chunk whose source rows the
window test (``packing.windows_fit``) refuses splits again by source
region (``src_cuts``: the node-id boundaries of [users | queries | items]);
a stable split keeps each part destination-sorted. The chunks build in
parallel. A single pack comes back as itself, several as a
``ChunkedGatPack``; None where the JAX package gets None.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ihgnn_torch.device import DeviceLike, moved
from ihgnn_torch.ops.packing import (CHUNK_ROWS_CAP, EXPAND_COLS, RolePack,
                                     _i32, role_pack, windows_fit)
from ihgnn_torch.ops.permute import pick_grid


def _rowptr(sorted_ids: np.ndarray, segments: int) -> np.ndarray:
    rowptr = np.zeros(segments + 1, np.int64)
    np.cumsum(np.bincount(sorted_ids, minlength=segments), out=rowptr[1:])
    return rowptr


@dataclasses.dataclass(frozen=True)
class GatPack:
    """One routed GAT pack over ``nnz`` destination-sorted entries on the
    ``[rows, cols]`` grid (see the module docstring)."""

    src: RolePack
    src_col: torch.Tensor      # [nnz] int32, t1 positions by source
    src_rowptr: torch.Tensor   # [N+1] int32
    dst_idx: torch.Tensor      # [R, C] int32
    dst_rowptr: torch.Tensor   # [N+1] int32, over entry positions
    entry: torch.Tensor        # [nnz] int32, 0..nnz-1
    mask: torch.Tensor         # [R·C] f32
    node_count: int
    nnz: int
    rows: int
    cols: int

    @property
    def k_pad(self) -> int:
        return self.rows * self.cols

    @property
    def packs(self) -> Tuple["GatPack", ...]:
        return (self,)

    def to(self, device: DeviceLike) -> "GatPack":
        return moved(self, device)


@dataclasses.dataclass(frozen=True)
class ChunkedGatPack:
    """Several ``GatPack``s over parts of one destination-sorted list
    (``ihgnn_tpu`` ``ChunkedGatPack``): per-pack segment maxima and sums
    combine by elementwise max and add over ``[N]`` and ``[N, d]``."""

    packs: Tuple[GatPack, ...]
    node_count: int
    nnz: int

    def to(self, device: DeviceLike) -> "ChunkedGatPack":
        return moved(self, device)


AnyGatPack = Union[GatPack, ChunkedGatPack]


def _gat_pack(src: np.ndarray, dst: np.ndarray, node_count: int,
              live: Optional[np.ndarray], cols: int) -> Optional[GatPack]:
    """One ``GatPack``, or None where ``build_gat_pack``'s single branch
    (``gatconv.py:142-188``) gives None: no entry, or an expand the window
    test refuses."""
    nnz = src.shape[0]
    if nnz == 0:
        return None
    if np.any(np.diff(dst) < 0):
        raise ValueError("GAT entries must be sorted by destination")
    rows, cols = pick_grid(nnz, cols)
    k_pad = rows * cols
    dst_pad = np.concatenate([dst, np.full(k_pad - nnz, dst[-1])])
    if not windows_fit(dst_pad, max(EXPAND_COLS, cols)):
        return None
    try:
        rp = role_pack(src, rows, cols, with_bwd=True)
    except ValueError:
        return None
    ids = rp.seg_ids.numpy()
    src_col = np.argsort(ids, kind="stable")[:nnz]
    mask = np.zeros(k_pad, np.float32)
    mask[:nnz] = 1.0 if live is None else (np.asarray(live) > 0)
    return GatPack(
        src=rp, src_col=_i32(src_col),
        src_rowptr=_i32(_rowptr(ids[src_col], node_count)),
        dst_idx=_i32(dst_pad.reshape(rows, cols)),
        dst_rowptr=_i32(_rowptr(dst, node_count)),
        entry=_i32(np.arange(nnz)), mask=torch.from_numpy(mask),
        node_count=int(node_count), nnz=int(nnz), rows=rows, cols=cols)


def build_gat_pack(src: np.ndarray, dst: np.ndarray, node_count: int,
                   live: Optional[np.ndarray] = None, cols: int = 1024,
                   chunk_rows_cap: int = CHUNK_ROWS_CAP,
                   src_cuts: Sequence[int] = ()) -> Optional[AnyGatPack]:
    """The routed GAT pack of the destination-sorted entries ``src →
    dst`` (ids below ``node_count``), ``live`` (> 0 live) or None (all
    live); see the module docstring. Mirrors ``build_gat_pack``
    (``gatconv.py:103-188``) pack for pack."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    live = None if live is None else np.asarray(live)
    nnz = src.shape[0]
    size = chunk_rows_cap * cols
    if not (chunk_rows_cap and (nnz > size or src_cuts)):
        return _gat_pack(src, dst, node_count, live, cols)
    cuts = list(src_cuts) + [node_count + 1]

    def chunk(start):
        """The packs of entries ``[start, start + size)``: one, or one a
        source region when the window test refuses the chunk; None when
        a region is refused too."""
        s, d = src[start:start + size], dst[start:start + size]
        lv = None if live is None else live[start:start + size]
        pk = _gat_pack(s, d, node_count, lv, cols)
        if pk is not None:
            return [pk]
        parts, lo = [], 0
        for hi in cuts:
            m = (s >= lo) & (s < hi)
            lo = hi
            if not m.any():
                continue
            part = _gat_pack(s[m], d[m], node_count,
                             None if lv is None else lv[m], cols)
            if part is None:
                return None
            parts.append(part)
        return parts

    starts = range(0, max(nnz, 1), size)
    with ThreadPoolExecutor(max_workers=min(len(starts), 8)) as pool:
        chunks = list(pool.map(chunk, starts))
    if any(c is None for c in chunks):
        return None
    packs = [pk for c in chunks for pk in c]
    if not packs:
        return None
    if len(packs) == 1:
        return packs[0]
    return ChunkedGatPack(packs=tuple(packs), node_count=int(node_count),
                          nnz=int(nnz))
