"""The routed hypergraph pack: graph structure → the index tables of the
σ-ordered kernel pipeline, built once on the host.

Counterpart of ``ihgnn_tpu/ops/packing.py`` ``build_hyper_kernel_pack``,
its σ branch (``:389-521``) and chunk branch (``:364-389``) with
``_route`` (``:159``), ``_pad_perm`` (``:235``) and ``_row_inverse``
(``:307``), single device. The edge axis pads to the ``[R, C]`` grid of
``pick_grid`` (``e_pad = R·C``) and every role reaches edge order through
a Clos route (``ops/benes.py``, routed by ``ops/native.py``):

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

The port keeps no windows, but it keeps their span test
(``windows_fit``, ``ihgnn_tpu/ops/pallas/gather.py:55-69``): a pack whose
expand rows of ``EXPAND_COLS`` ids span more than ``W_CAP`` source rows is
refused (None), as the JAX package refuses it, so both pack exactly the
same graphs.

Long grids chunk (``ChunkedHyperPack``, ``packing.py:99-124,364-389``):
past ``chunk_rows_cap`` rows (2048 by default, 2,097,152 edges at C =
1024) the edges split into contiguous slices of ``chunk_rows_cap · C``
edges, each a σ pack of its own, and the streams of all chunks lie end to
end in one ``[e_pad_total, d]`` tensor. The chunks' node sums are one K1
three-region sum (``csr_segment_sum3_multi``'s counterpart) over a CSR
that spans them: a node's entries of chunk 0 first, then chunk 1's, ...

The non-σ role pack (``RolePack``, ``_role_pack`` ``packing.py:241-305``)
routes one role of an edge list in edge order: forward (role-sorted →
edge order) the expand composed with stage 0, then stages 1 and 2; back
(edge order → t1, the rank order before its last stage) a Clos route of
its own, stages 0 and 1, its stage 2 absorbed into the node sums' ids. The
routed 2D graph (``graph.py``) and the routed GAT (``ops/gatpack.py``)
use it.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ihgnn_torch.device import DeviceLike, moved
from ihgnn_torch.ops import native
from ihgnn_torch.ops.permute import pick_grid
from ihgnn_torch.ops.segscan import SENTINEL, ScanPack, pack_scan_inputs


# the TPU's windowed expand: a row of EXPAND_COLS ids may span at most
# W_CAP source rows (ihgnn_tpu/ops/packing.py:39,49), in 128-row windows
W_CAP = 16384
EXPAND_COLS = 1024
WINDOW = 128
# ChunkedHyperPack's grid cap (ihgnn_tpu/ops/packing.py:368)
CHUNK_ROWS_CAP = 2048


def _i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


def windows_fit(idx: np.ndarray, width: int = EXPAND_COLS,
                w_cap: int = W_CAP) -> bool:
    """``pack_windows``' span test on an absolute index table read as rows
    of ``width`` ids: False when a row's window (its least id rounded down
    to WINDOW, to its largest id, rounded up to WINDOW) is wider than
    ``w_cap``, where the JAX package refuses the pack."""
    rows = np.asarray(idx, np.int64).reshape(-1, width)
    win = rows.min(axis=1) // WINDOW * WINDOW
    span = int((rows.max(axis=1) - win).max()) + 1
    return -(-span // WINDOW) * WINDOW <= w_cap


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
    scan: Optional[ScanPack]   # K8's in-block order of seg_ids (None in
                               # a chunk of a ChunkedHyperPack)
    edge_count: int
    node_count: int
    rows: int
    cols: int

    @property
    def e_pad(self) -> int:
        return self.rows * self.cols

    @property
    def packs(self) -> Tuple["HyperKernelPack", ...]:
        """The chunks: this pack alone (``ChunkedHyperPack.packs``)."""
        return (self,)

    @property
    def absorbs(self) -> bool:
        """True: K5 takes the pack's tables (``absorb_tables``)."""
        return True

    def absorb_tables(self):
        """``(π [R, C], σ mask or None)`` of the absorbed interaction."""
        return self.i.p2, self.sig_mask

    def to(self, device: DeviceLike) -> "HyperKernelPack":
        return moved(self, device)


@dataclasses.dataclass(frozen=True)
class ChunkedHyperPack:
    """K σ packs over contiguous edge slices (``ihgnn_tpu``
    ``ChunkedHyperPack``): chunk k holds edges ``[k·S, (k+1)·S)``, S =
    ``chunk_rows_cap · cols``, and its streams rows ``[offset_k, offset_k +
    e_pad_k)`` of the ``[e_pad, d]`` streams. At a cap that is a multiple
    of 128 rows (the default) only the last chunk pads.

    ``seg_col``/``seg_rowptr``: K1's three-region CSR over ``[u | q | i]``
    regions of ``e_pad`` rows each (every chunk's u rows, q rank-order
    rows, i rank-order rows), a node's entries chunk by chunk.
    ``absorb_p2``: the chunks' i stage 2 stacked on the row axis, ``[Σ R,
    C]``, when every chunk's grid has C columns (the absorbed interaction's
    gate, as ``absorb_i_ok``'s; a small cap at a wide ``cols`` can give the
    last chunk a narrower grid), else None. ``sig_mask``: the chunks' masks
    end to end, ones where a chunk has no pads (None when no chunk pads).
    ``cols`` is the grid width asked of the chunks, as in JAX."""

    packs: Tuple[HyperKernelPack, ...]
    seg_col: torch.Tensor       # [3E] int32
    seg_rowptr: torch.Tensor    # [N+1] int32
    absorb_p2: Optional[torch.Tensor]  # [Σ R, C] int32
    sig_mask: Optional[torch.Tensor]   # [e_pad] f32
    edge_count: int
    node_count: int
    cols: int

    @property
    def e_pad(self) -> int:
        return sum(pk.e_pad for pk in self.packs)

    @property
    def absorbs(self) -> bool:
        return self.absorb_p2 is not None

    def absorb_tables(self):
        if self.absorb_p2 is None:
            raise ValueError("the chunks' grids differ in width; K5 cannot "
                             "stack their tables")
        return self.absorb_p2, self.sig_mask

    def to(self, device: DeviceLike) -> "ChunkedHyperPack":
        return moved(self, device)


AnyHyperPack = Union[HyperKernelPack, ChunkedHyperPack]


@dataclasses.dataclass(frozen=True)
class RolePack:
    """One role of an edge list routed in edge order (``ihgnn_tpu``
    ``RolePack``, non-σ layout), as int32 tables on the ``[R, C]`` grid:
    ``idx`` the expand of the role-sorted ids composed with stage 0
    (absolute row ids), ``p1`` ``[C, R]`` and ``p2`` ``[R, C]`` the forward
    stages 1 and 2 (``fwd_p1``, ``fwd_p2``), so that the σ chain
    ``hyperagg._role_forward`` runs it unchanged; ``bwd_p0`` ``[R, C]`` and
    ``bwd_p1`` ``[C, R]`` the first two stages of the route edge order →
    rank order; ``seg_ids`` ``[R·C]`` the role's ids in t1 order (that
    route's stage 2 absorbed), int32-max past E. The three backward fields
    are None for a pack built ``with_bwd=False``."""

    idx: torch.Tensor
    p1: torch.Tensor
    p2: torch.Tensor
    bwd_p0: Optional[torch.Tensor]
    bwd_p1: Optional[torch.Tensor]
    seg_ids: Optional[torch.Tensor]
    edge_count: int
    rows: int
    cols: int

    @property
    def e_pad(self) -> int:
        return self.rows * self.cols

    def to(self, device: DeviceLike) -> "RolePack":
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
                            cols: int = 1024,
                            chunk_rows_cap: int = CHUNK_ROWS_CAP,
                            with_scan: bool = True
                            ) -> Optional[AnyHyperPack]:
    """The CPU pack of a hypergraph whose edges ``i3`` ``[E, 3]`` (global
    node ids) are numbered user-sorted, on the ``pick_grid(E, cols)`` grid;
    None where the JAX package refuses it (``windows_fit``). A grid of more
    than ``chunk_rows_cap`` rows (0: no cap) chunks into a
    ``ChunkedHyperPack``. The two Clos routes of a pack run in parallel
    threads through the native router, which raises when it cannot be
    built; the chunks build in parallel too. ``with_scan``: build K8's
    scan pack (the chunks of a chunked pack have none)."""
    i3 = np.asarray(i3, np.int64)
    e = i3.shape[0]
    if e == 0:
        raise ValueError("a routed pack needs at least one edge")
    rows, cols = pick_grid(e, cols)
    if chunk_rows_cap and rows > chunk_rows_cap:
        return _build_chunked(i3, node_count, cols, chunk_rows_cap)
    e_pad = rows * cols
    u_ids = i3[:, 0]
    u_pad = np.concatenate([u_ids, np.full(e_pad - e, u_ids[-1])])
    if not windows_fit(u_pad, max(EXPAND_COLS, cols)):
        return None     # the σ relabelling keeps each row's id set

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
    # i's stage 2 composed with the σ relabelling
    p2i = np.take_along_axis(f_i[2], sig_inv, axis=1)

    def stage0_ids(name, f0, pad_value):
        """The role-sorted ids (tail filled with ``pad_value``) read
        through stage 0: the expand composed with it, or the node sum's
        ids in stage-0 order."""
        s = sorted_role[name]
        full = np.concatenate([s, np.full(e_pad - e, pad_value, np.int64)])
        return np.take_along_axis(full.reshape(rows, cols), f0, axis=1)

    q_idx = stage0_ids("q", f_q[0], sorted_role["q"][-1])
    i_idx = stage0_ids("i", f_i[0], sorted_role["i"][-1])
    if not (windows_fit(q_idx, max(EXPAND_COLS, cols))
            and windows_fit(i_idx, max(EXPAND_COLS, cols))):
        return None
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
        q=RoleTables(idx=_i32(q_idx), p1=_i32(f_q[1]),
                     p1_inv=_i32(row_inverse(f_q[1]))),
        i=RoleTables(idx=_i32(i_idx), p1=_i32(f_i[1]),
                     p1_inv=_i32(row_inverse(f_i[1])),
                     p2=_i32(p2i), p2_inv=_i32(row_inverse(p2i))),
        sig=_i32(sig), sig_inv=_i32(sig_inv),
        sig_mask=(None if e == e_pad
                  else torch.from_numpy((esig < e).astype(np.float32))),
        seg_ids=_i32(seg_ids), seg_col=_i32(seg_order),
        seg_rowptr=_i32(seg_rowptr),
        scan=pack_scan_inputs(seg_ids, node_count) if with_scan else None,
        edge_count=int(e), node_count=int(node_count), rows=rows, cols=cols)


def _build_chunked(i3: np.ndarray, node_count: int, cols: int,
                   chunk_rows_cap: int) -> Optional[ChunkedHyperPack]:
    """``build_hyper_kernel_pack``'s chunk branch (``packing.py:364-389``):
    one σ pack a slice of ``chunk_rows_cap · cols`` edges, built in
    parallel; None when any chunk is refused."""
    e = i3.shape[0]
    size = chunk_rows_cap * cols
    slices = [i3[k:k + size] for k in range(0, e, size)]
    with ThreadPoolExecutor(max_workers=min(len(slices), 8)) as pool:
        packs = list(pool.map(
            lambda sl: build_hyper_kernel_pack(sl, node_count, cols, 0,
                                               with_scan=False), slices))
    if any(pk is None for pk in packs):
        return None
    m = sum(pk.e_pad for pk in packs)
    if 3 * m >= 2 ** 31:
        raise ValueError(f"3 x {m} stream rows do not fit K1's int32 ids")

    # K1's CSR over [u | q | i] regions of m rows: chunk k's region entry
    # at position p of its own region r goes to r·m + offset_k + p, and a
    # node's entries of chunk k follow those of chunks 0..k-1
    counts = [np.diff(pk.seg_rowptr.numpy().astype(np.int64))
              for pk in packs]
    rowptr = np.zeros(node_count + 1, np.int64)
    np.cumsum(np.sum(counts, axis=0), out=rowptr[1:])
    col = np.empty(rowptr[-1], np.int64)
    before = np.zeros(node_count, np.int64)
    offset = 0
    for pk, cnt in zip(packs, counts):
        local = pk.seg_col.numpy().astype(np.int64)
        own = pk.seg_rowptr.numpy().astype(np.int64)
        start = np.repeat(rowptr[:-1] + before - own[:-1], cnt)
        region, pos = np.divmod(local, pk.e_pad)
        col[start + np.arange(local.size)] = region * m + offset + pos
        before += cnt
        offset += pk.e_pad
    masks = [pk.sig_mask for pk in packs]
    return ChunkedHyperPack(
        packs=tuple(packs), seg_col=_i32(col), seg_rowptr=_i32(rowptr),
        absorb_p2=(torch.cat([pk.i.p2 for pk in packs])
                   if len({pk.cols for pk in packs}) == 1 else None),
        sig_mask=(None if all(mk is None for mk in masks) else torch.cat([
            torch.ones(pk.e_pad) if mk is None else mk
            for pk, mk in zip(packs, masks)])),
        edge_count=int(e), node_count=int(node_count), cols=cols)


def role_pack(role_ids: np.ndarray, rows: int, cols: int,
              with_bwd: bool = True) -> RolePack:
    """The non-σ ``RolePack`` of one role whose ``[E]`` node ids
    ``role_ids`` are in edge order, on the ``[rows, cols]`` grid
    (``_role_pack``, ``packing.py:241-305``): the forward route rank → edge
    and, ``with_bwd``, the backward route edge → rank, each by the native
    router, in parallel threads. Raises ``ValueError`` where the JAX
    package's ``pack_windows`` refuses the expand (``windows_fit`` on rows
    of EXPAND_COLS ids)."""
    role_ids = np.asarray(role_ids, np.int64)
    e, e_pad = role_ids.shape[0], rows * cols
    if e == 0:
        raise ValueError("a role pack needs at least one entry")
    order = np.argsort(role_ids, kind="stable")
    rank = np.empty(e, np.int64)
    rank[order] = np.arange(e)
    sorted_ids = role_ids[order]
    sorted_pad = np.concatenate([sorted_ids,
                                 np.full(e_pad - e, sorted_ids[-1])])
    # stage 0 permutes within C-rows, which nest in EXPAND_COLS-rows for
    # C <= EXPAND_COLS: the span is the sorted rows' and needs no route
    if cols <= EXPAND_COLS and not windows_fit(sorted_pad):
        raise ValueError("role expand rows exceed the window cap")
    with ThreadPoolExecutor(max_workers=2) as pool:
        fwd = pool.submit(native.benes_route, pad_perm(rank, e_pad), rows,
                          cols)
        bwd = (pool.submit(native.benes_route, pad_perm(order, e_pad), rows,
                           cols) if with_bwd else None)
        f0, f1, f2 = (np.asarray(t, np.int64) for t in fwd.result())
        idx = np.take_along_axis(sorted_pad.reshape(rows, cols), f0, axis=1)
        if cols > EXPAND_COLS and not windows_fit(idx):
            raise ValueError("role expand rows exceed the window cap")
        if bwd is None:
            return RolePack(idx=_i32(idx), p1=_i32(f1), p2=_i32(f2),
                            bwd_p0=None, bwd_p1=None, seg_ids=None,
                            edge_count=int(e), rows=rows, cols=cols)
        b0, b1, b2 = (np.asarray(t, np.int64) for t in bwd.result())
    # the value at t1 position (r, b2[r, c]) belongs to rank r·C + c
    ids_t1 = np.empty((rows, cols), np.int64)
    np.put_along_axis(ids_t1, b2, np.concatenate([
        sorted_ids, np.full(e_pad - e, SENTINEL)]).reshape(rows, cols),
        axis=1)
    return RolePack(idx=_i32(idx), p1=_i32(f1), p2=_i32(f2), bwd_p0=_i32(b0),
                    bwd_p1=_i32(b1), seg_ids=_i32(ids_t1.reshape(-1)),
                    edge_count=int(e), rows=rows, cols=cols)
