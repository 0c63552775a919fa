"""The routed hypergraph pack: graph structure → the index tables of the
σ-ordered kernel pipeline, built once on the host.

Counterpart of ``ihgnn_tpu/ops/packing.py`` ``build_hyper_kernel_pack``,
its σ branch (``:389-521``) with ``_route`` (``:159``), ``_pad_perm``
(``:235``) and ``_row_inverse`` (``:307``): single pack (no chunks),
single device. The edge axis pads to the ``[R, C]`` grid of ``pick_grid``
(``e_pad = R·C``) and every role reaches edge order through a Clos route
(``ops/benes.py``, routed by ``ops/native.py``):

* u: edges are numbered user-sorted, so the u rows are one expand of the
  user ids;
* q, i: an expand of the role-sorted ids (composed with the route's stage
  0), a transpose, stage 1, a transpose, stage 2.

The pipeline runs in σ order, the q role's state before its last stage (a
row-local scramble of edge order): σ position ``(r, j)`` holds edge
``r·C + sig_inv[r, j]``. So q needs no stage 2 in either direction, the u
expand takes σ into its index table, and i's stage 2 is composed with the
σ relabelling. The inverse chains (σ → role-rank order, for the scatter
and the gather's backward) run the row-inverted forward tables and end
one row-local stage early: that stage is absorbed by storing each node
sum's ids in the scrambled order (all scrambles stay inside C-rows).

Where the TPU pack keeps windowed-relative expand tables and packed stage
words (dg, hier, bfly), the port keeps absolute int32 row ids and plain
int32 permutation tables. σ pads (``e_pad - E`` of them) interleave within
rows and hold copies of real rows: ``sig_mask`` marks the real σ
positions, and the node sums' ids drop the pads (int32-max sentinels).
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from ihgnn_torch.device import DeviceLike, moved
from ihgnn_torch.ops import native
from ihgnn_torch.ops.permute import pick_grid
from ihgnn_torch.ops.segscan import SENTINEL, ScanPack, pack_scan_inputs


def _i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


@dataclasses.dataclass(frozen=True)
class RoleTables:
    """One role's chain (``ihgnn_tpu`` ``RolePack``, σ layout), as int32
    tables: ``idx`` ``[R, C]`` the expand's absolute row ids (u: the σ
    relabelled user ids; q, i: the role-sorted ids through stage 0); ``p1``
    / ``p1_inv`` ``[C, R]`` stage 1 and its row inverse; ``p2`` / ``p2_inv``
    ``[R, C]`` the i role's stage 2 composed with σ and its row inverse
    (None for u and q)."""

    idx: torch.Tensor
    p1: Optional[torch.Tensor] = None
    p1_inv: Optional[torch.Tensor] = None
    p2: Optional[torch.Tensor] = None
    p2_inv: Optional[torch.Tensor] = None

    def to(self, device: DeviceLike) -> "RoleTables":
        return moved(self, device)


@dataclasses.dataclass(frozen=True)
class HyperKernelPack:
    """Every table of the routed pipeline over one graph (see the module
    docstring)."""

    u: RoleTables
    q: RoleTables
    i: RoleTables
    sig: torch.Tensor          # [R, C] q's stage 2: σ → edge order
    sig_inv: torch.Tensor      # [R, C] its row inverse
    sig_mask: Optional[torch.Tensor]   # [e_pad] f32, 1 at real σ positions;
                                       # None when E = e_pad
    seg_ids: torch.Tensor      # [3 e_pad] node of each [u | q | i] entry
    seg_col: torch.Tensor      # [3E] K1's CSR over seg_ids: stream position
    seg_rowptr: torch.Tensor   # [N+1]
    scan: ScanPack             # K8's in-block order of seg_ids
    edge_count: int
    node_count: int
    rows: int
    cols: int

    @property
    def e_pad(self) -> int:
        return self.rows * self.cols

    def to(self, device: DeviceLike) -> "HyperKernelPack":
        return moved(self, device)


def pad_perm(perm: np.ndarray, e_pad: int) -> np.ndarray:
    """``perm`` extended by the identity on ``[E, e_pad)``."""
    e = perm.shape[0]
    return np.concatenate([np.asarray(perm, np.int64),
                           np.arange(e, e_pad, dtype=np.int64)])


def row_inverse(p: np.ndarray) -> np.ndarray:
    """Per-row inverse of a ``[NR, L]`` table of row permutations."""
    nr, length = p.shape
    inv = np.empty_like(p)
    np.put_along_axis(inv, np.asarray(p, np.int64),
                      np.broadcast_to(np.arange(length, dtype=p.dtype),
                                      (nr, length)), axis=1)
    return inv


def build_hyper_kernel_pack(i3: np.ndarray, node_count: int,
                            cols: int = 1024) -> HyperKernelPack:
    """The CPU pack of a hypergraph whose edges ``i3`` ``[E, 3]`` (global
    node ids) are numbered user-sorted, on the ``pick_grid(E, cols)`` grid.
    The two Clos routes run in parallel threads through the native router,
    which raises when it cannot be built."""
    i3 = np.asarray(i3, np.int64)
    e = i3.shape[0]
    if e == 0:
        raise ValueError("a routed pack needs at least one edge")
    rows, cols = pick_grid(e, cols)
    e_pad = rows * cols

    # route rank → edge for q and i: x_edge[j] = x_sorted[rank[j]]
    sorted_role, futs = {}, {}
    with ThreadPoolExecutor(max_workers=2) as pool:
        for name, col in (("q", 1), ("i", 2)):
            ids = i3[:, col]
            order = np.argsort(ids, kind="stable")
            rank = np.empty(e, np.int64)
            rank[order] = np.arange(e)
            futs[name] = pool.submit(native.benes_route,
                                     pad_perm(rank, e_pad), rows, cols)
            sorted_role[name] = ids[order]
        routes = {name: tuple(np.asarray(t, np.int64) for t in f.result())
                  for name, f in futs.items()}
    f_q, f_i = routes["q"], routes["i"]

    # σ position (r, j) holds edge esig[r, j] = r·C + sig_inv[r, j]
    sig = f_q[2]
    sig_inv = row_inverse(sig)
    esig = (np.arange(rows, dtype=np.int64)[:, None] * cols
            + sig_inv).reshape(-1)
    u_ids = i3[:, 0]
    u_pad = np.concatenate([u_ids, np.full(e_pad - e, u_ids[-1])])
    # i's stage 2 composed with the σ relabelling
    p2i = np.take_along_axis(f_i[2], sig_inv, axis=1)

    def stage0_ids(name, f0, pad_value):
        """The role-sorted ids (tail filled with ``pad_value``) read
        through stage 0: the expand composed with it, or the node sum's
        ids in stage-0 order."""
        s = sorted_role[name]
        full = np.concatenate([s, np.full(e_pad - e, pad_value, np.int64)])
        return np.take_along_axis(full.reshape(rows, cols), f0, axis=1)

    seg_ids = np.concatenate([
        np.where(esig < e, u_pad[np.minimum(esig, e - 1)], SENTINEL),
        stage0_ids("q", f_q[0], SENTINEL).reshape(-1),
        stage0_ids("i", f_i[0], SENTINEL).reshape(-1)])
    # K1's CSR: each node's stream positions in stream order, pads dropped
    seg_order = np.argsort(seg_ids, kind="stable")[:3 * e]
    seg_rowptr = np.zeros(node_count + 1, np.int64)
    np.cumsum(np.bincount(seg_ids[seg_order], minlength=node_count),
              out=seg_rowptr[1:])

    return HyperKernelPack(
        u=RoleTables(idx=_i32(u_pad[esig].reshape(rows, cols))),
        q=RoleTables(idx=_i32(stage0_ids("q", f_q[0], sorted_role["q"][-1])),
                     p1=_i32(f_q[1]), p1_inv=_i32(row_inverse(f_q[1]))),
        i=RoleTables(idx=_i32(stage0_ids("i", f_i[0], sorted_role["i"][-1])),
                     p1=_i32(f_i[1]), p1_inv=_i32(row_inverse(f_i[1])),
                     p2=_i32(p2i), p2_inv=_i32(row_inverse(p2i))),
        sig=_i32(sig), sig_inv=_i32(sig_inv),
        sig_mask=(None if e == e_pad
                  else torch.from_numpy((esig < e).astype(np.float32))),
        seg_ids=_i32(seg_ids), seg_col=_i32(seg_order),
        seg_rowptr=_i32(seg_rowptr),
        scan=pack_scan_inputs(seg_ids, node_count),
        edge_count=int(e), node_count=int(node_count), rows=rows, cols=cols)
