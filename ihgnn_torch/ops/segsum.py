"""K1: CSR weighted gather-sum, and its plain twin.

  out[s, :] = Σ_{k ∈ [rowptr[s], rowptr[s+1])} w[k] · x[col[k], :]

Counterpart of the sorted CSR segment-sum kernels of
``ihgnn_tpu/ops/pallas/segsum.py`` (``csr_segment_sum3_t``,
``csr_segment_sum_t``, ``csr_segment_sum3_multi``). The TPU streams
pre-expanded entry values into node tiles; here the gather of the entry
rows is folded into the sum, so the [K, d] entry stream is never written.
It serves the node update H·E (``x`` = edge features, ``col`` =
``inc_edge``, ``rowptr`` over ``inc_node``) and the query word-bag mean
(``x`` = vocab table, ``col`` = word rows, ``w`` = 1/count).

Layout: ``x`` is row-major ``[M, d]`` f32, ``col`` int32 ``[K]``,
``rowptr`` int32 ``[S+1]``, ``w`` f32 ``[K]`` or None; the result is
``[S, d]`` f32. The CUDA kernel sums each segment in entry order, so it is
deterministic.

The kernel has two forms, chosen from d and the rows' alignment alone
(``vector_form``): the vector form, for d % 4 == 0 and 16-byte aligned
rows (every width the model uses), holds a row in float4s and sums
several segments a warp; the scalar form, one lane a feature, takes
anything else. Both give the same bits. ``width`` names a CSR whose segments all have that many entries
(the scatter's backward: 3 a hyperedge), so the vector form reads no
``rowptr``; the twin ignores it.

bf16 rows (``ModelConfig.bf16_stream``: the node update of bf16 edge rows,
the gather's backward of bf16 role cotangents, the scatter's backward) run
the bf16 forms, without weights: the rows widen to f32 exactly, the sums
run in f32 in the same order, and the result is f32, or with
``out_dtype=torch.bfloat16`` rounded once to bf16. ``bf16_form`` picks
their lane width from d and the rows' alignment alone: 16 bytes (eight
features a lane) for d % 8 == 0 and 16-byte aligned rows, else 8 bytes
(four) for d % 4 == 0 and 8-byte aligned rows; the C entry points apply
the same rule, and both widths give the same bits. They count in
``csr_gather_sum.launches_bf16``; the f32 forms in
``csr_gather_sum.launches``.

Long segments (hub nodes under skew). A CSR's ``LongSegments``, built once
with it (``long_segments``: every segment of more than ``LONG_ENTRIES``
entries, longest first), lets the f32 vector form sum each of them with a
whole block (``csrc/segsum.cu``), in the same order of adds, so the bits
do not change; the other segments run as without the list. Every other
form, and the twin, ignores the list.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from ihgnn_torch.device import DeviceLike, moved
from ihgnn_torch.ops import _build
from ihgnn_torch.ops.segment import segment_ids, segment_sum
from ihgnn_torch.utils import tracing

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_BF16_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
    ctypes.c_void_p]
_LONG_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]

# a segment of more than LONG_ENTRIES entries is long (csrc/segsum.cu
# kLongEntries)
LONG_ENTRIES = 256


@dataclasses.dataclass(frozen=True)
class LongSegments:
    """The long segments of one CSR: ``ids`` ``[H]`` int32, longest first,
    and ``entries``, their entry total."""

    ids: torch.Tensor
    entries: int

    def to(self, device: DeviceLike) -> "LongSegments":
        return moved(self, device)


def long_segments(rowptr) -> LongSegments:
    """The CPU ``LongSegments`` of the CSR offsets ``rowptr`` (a numpy
    array or CPU tensor): every segment of more than ``LONG_ENTRIES``
    entries, longest first (ties by id)."""
    lengths = np.diff(np.asarray(rowptr, np.int64))
    ids = np.flatnonzero(lengths > LONG_ENTRIES)
    ids = ids[np.argsort(-lengths[ids], kind="stable")]
    return LongSegments(torch.from_numpy(ids.astype(np.int32)),
                        int(lengths[ids].sum()))


def vector_form(d: int, *tensors: torch.Tensor) -> bool:
    """True when K1's vector form takes rows of width ``d`` from
    ``tensors``: d a multiple of 4 and every tensor 16-byte aligned."""
    return d % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


def bf16_form(d: int, *tensors: torch.Tensor) -> int:
    """The lane width in bytes of the bf16 form that takes bf16 rows of
    width ``d`` from ``tensors``: 16 for d a multiple of 8 and every tensor
    16-byte aligned, else 8 for d a multiple of 4 and every tensor 8-byte
    aligned, else 0 (no bf16 form takes them)."""
    if d % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors):
        return 16
    if d % 4 == 0 and all(t.data_ptr() % 8 == 0 for t in tensors):
        return 8
    return 0


def csr_gather_sum_plain(x: torch.Tensor, col: torch.Tensor,
                         rowptr: torch.Tensor,
                         weight: Optional[torch.Tensor] = None,
                         out_dtype: Optional[torch.dtype] = None
                         ) -> torch.Tensor:
    """Plain PyTorch twin of ``csr_gather_sum`` (any device): the rows
    widened to f32, summed in f32, the result in ``out_dtype`` (f32 when
    None)."""
    vals = x.index_select(0, col.long()).float()
    if weight is not None:
        vals = vals * weight[:, None]
    out = segment_sum(vals, segment_ids(rowptr), rowptr.shape[0] - 1)
    return out if out_dtype is None else out.to(out_dtype)


def csr_gather_sum(x: torch.Tensor, col: torch.Tensor, rowptr: torch.Tensor,
                   weight: Optional[torch.Tensor] = None,
                   width: Optional[int] = None,
                   out_dtype: Optional[torch.dtype] = None,
                   long_segments: Optional[LongSegments] = None
                   ) -> torch.Tensor:
    """``[S, d]`` CSR weighted gather-sum of the rows of ``x`` (see the
    module docstring), in ``out_dtype`` (f32 when None; bf16 only for bf16
    ``x``). With ``width``, ``rowptr`` must be ``0, width, 2 width, ...``:
    the caller vouches for it, the wrapper checks only that ``col`` has
    ``width`` entries a segment. ``long_segments``: the CSR's own (the
    caller vouches for it), or None. CPU tensors run the plain twin; CUDA
    tensors launch ``csrc/segsum.cu`` and count one in
    ``csr_gather_sum.launches`` (f32 ``x``) or
    ``csr_gather_sum.launches_bf16`` (bf16 ``x``); a launch whose list
    engages counts its segments in ``k1.long_segments`` and their entries
    in ``k1.long_entries`` (``utils/tracing.py``)."""
    what = "csr_gather_sum"
    if width is not None and not (
            width > 0 and col.shape == ((rowptr.shape[0] - 1) * width,)):
        raise ValueError(f"{what}: width {width} does not fit "
                         f"{rowptr.shape[0] - 1} segments of col "
                         f"{tuple(col.shape)}")
    if out_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: out_dtype {out_dtype} is not f32 or bf16")
    hubs = None if long_segments is None else long_segments.ids
    if not _build.use_kernel(what, x, col, rowptr, weight, hubs):
        return csr_gather_sum_plain(x, col, rowptr, weight, out_dtype)
    if x.dtype == torch.bfloat16:
        return _csr_gather_sum_bf16(x, col, rowptr, weight, width, out_dtype)
    _build.require(x.dim() == 2 and x.dtype == torch.float32
                   and x.is_contiguous(), what, "x must be contiguous [M, d] f32")
    _build.require(out_dtype in (None, torch.float32), what,
                   "f32 rows sum into f32; no form rounds them to bf16")
    for name, t in (("col", col), ("rowptr", rowptr)):
        _build.require(t.dim() == 1 and t.dtype == torch.int32
                       and t.is_contiguous(), what,
                       f"{name} must be contiguous 1-D int32")
    if weight is not None:
        _build.require(weight.shape == col.shape
                       and weight.dtype == torch.float32
                       and weight.is_contiguous(), what,
                       "weight must be contiguous f32 shaped like col")
    s, d = rowptr.shape[0] - 1, x.shape[1]
    out = torch.empty(s, d, dtype=torch.float32, device=x.device)
    if s == 0 or d == 0:
        return out
    vector = vector_form(d, x, out)
    w_ptr = None if weight is None else weight.data_ptr()
    if vector and not width and hubs is not None and hubs.numel():
        _build.require(hubs.dim() == 1 and hubs.dtype == torch.int32
                       and hubs.is_contiguous(), what,
                       "long_segments.ids must be contiguous 1-D int32")
        fn = _build.function("segsum", "ihgnn_csr_gather_sum_long",
                             _LONG_ARGTYPES)
        err = fn(x.data_ptr(), col.data_ptr(), rowptr.data_ptr(), w_ptr,
                 out.data_ptr(), s, d, hubs.data_ptr(), hubs.numel(),
                 _build.stream_ptr(x.device))
        tracing.count("k1.long_segments", hubs.numel())
        tracing.count("k1.long_entries", long_segments.entries)
    else:
        fn = _build.function("segsum", "ihgnn_csr_gather_sum", _ARGTYPES)
        err = fn(x.data_ptr(), col.data_ptr(), rowptr.data_ptr(), w_ptr,
                 out.data_ptr(), s, d, int(vector),
                 width if vector and width else 0,
                 _build.stream_ptr(x.device))
    _build.check("segsum", what, err)
    csr_gather_sum.launches += 1
    return out


csr_gather_sum.launches = 0
csr_gather_sum.launches_bf16 = 0


def _csr_gather_sum_bf16(x, col, rowptr, weight, width, out_dtype):
    """``csr_gather_sum``'s launch of a bf16 form (CUDA tensors)."""
    what = "csr_gather_sum"
    _build.require(x.dim() == 2 and x.is_contiguous(), what,
                   "x must be contiguous [M, d] bf16")
    _build.require(weight is None, what, "the bf16 forms take no weight")
    for name, t in (("col", col), ("rowptr", rowptr)):
        _build.require(t.dim() == 1 and t.dtype == torch.int32
                       and t.is_contiguous(), what,
                       f"{name} must be contiguous 1-D int32")
    s, d = rowptr.shape[0] - 1, x.shape[1]
    out = torch.empty(s, d, dtype=out_dtype or torch.float32,
                      device=x.device)
    if s == 0 or d == 0:
        return out
    _build.require(bf16_form(d, x) > 0, what,
                   "the bf16 forms are vector forms: d must be a multiple of "
                   "4 and x 8-byte aligned")
    fn = _build.function("segsum", "ihgnn_csr_gather_sum_bf16",
                         _BF16_ARGTYPES)
    err = fn(x.data_ptr(), col.data_ptr(), rowptr.data_ptr(), out.data_ptr(),
             s, d, width or 0, int(out.dtype == torch.bfloat16),
             _build.stream_ptr(x.device))
    _build.check("segsum", what, err)
    csr_gather_sum.launches_bf16 += 1
    return out

_SUM3_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] + [
    ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def csr_segment_sum3_plain(u: torch.Tensor, q: torch.Tensor, i: torch.Tensor,
                           col: torch.Tensor, rowptr: torch.Tensor,
                           out_dtype: Optional[torch.dtype] = None
                           ) -> torch.Tensor:
    """Plain twin of ``csr_segment_sum3`` (any device)."""
    return csr_gather_sum_plain(torch.cat([u, q, i]), col, rowptr,
                                out_dtype=out_dtype)


def csr_segment_sum3(u: torch.Tensor, q: torch.Tensor, i: torch.Tensor,
                     col: torch.Tensor, rowptr: torch.Tensor,
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``[S, d]`` CSR sum over the rows of three regions ``u``, ``q``,
    ``i`` (each ``[M, d]``): column ``c`` reads row ``c % M`` of region
    ``c // M``, as if from ``cat([u, q, i])``, which is never built.
    Counterpart of ``csr_segment_sum3_t`` (``segsum.py:403``). The sums run
    in f32; the result is f32, or with ``out_dtype=torch.bfloat16`` (bf16
    regions only) rounded once to bf16. CPU tensors run the plain twin;
    CUDA tensors launch ``csrc/segsum.cu`` and count one in
    ``csr_segment_sum3.launches`` (f32 regions) or
    ``csr_segment_sum3.launches_bf16`` (bf16 regions, the lane width of
    ``bf16_form``)."""
    what = "csr_segment_sum3"
    if not (u.shape == q.shape == i.shape and u.dim() == 2):
        raise ValueError(f"{what}: u, q and i must have one [M, d] shape")
    if out_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: out_dtype {out_dtype} is not f32 or bf16")
    if not _build.use_kernel(what, u, q, i, col, rowptr):
        return csr_segment_sum3_plain(u, q, i, col, rowptr, out_dtype)
    bf16 = u.dtype == torch.bfloat16
    for t in (u, q, i):
        _build.require(t.dtype == u.dtype and t.dtype in (
            torch.float32, torch.bfloat16) and t.is_contiguous(), what,
            "u, q and i must be contiguous, all f32 or all bf16")
    _build.require(bf16 or out_dtype in (None, torch.float32), what,
                   "f32 regions sum into f32; no form rounds them to bf16")
    for name, t in (("col", col), ("rowptr", rowptr)):
        _build.require(t.dim() == 1 and t.dtype == torch.int32
                       and t.is_contiguous(), what,
                       f"{name} must be contiguous 1-D int32")
    _build.require(3 * u.shape[0] < 2 ** 31, what,
                   "3 M must fit in int32")
    s, d = rowptr.shape[0] - 1, u.shape[1]
    out = torch.empty(s, d, dtype=out_dtype or torch.float32,
                      device=u.device)
    if s == 0 or d == 0:
        return out
    if bf16:
        _build.require(bf16_form(d, u, q, i) > 0, what, "the bf16 form is a "
                       "vector form: d must be a multiple of 4 and the "
                       "regions 8-byte aligned")
        fn = _build.function("segsum", "ihgnn_csr_segment_sum3_bf16",
                             _SUM3_ARGTYPES)
        err = fn(u.data_ptr(), q.data_ptr(), i.data_ptr(), u.shape[0],
                 col.data_ptr(), rowptr.data_ptr(), out.data_ptr(), s, d,
                 int(out.dtype == torch.bfloat16),
                 _build.stream_ptr(u.device))
    else:
        fn = _build.function("segsum", "ihgnn_csr_segment_sum3",
                             _SUM3_ARGTYPES)
        err = fn(u.data_ptr(), q.data_ptr(), i.data_ptr(), u.shape[0],
                 col.data_ptr(), rowptr.data_ptr(), out.data_ptr(), s, d,
                 int(vector_form(d, u, q, i, out)),
                 _build.stream_ptr(u.device))
    _build.check("segsum", what, err)
    _build.count(csr_segment_sum3, bf16)
    return out


csr_segment_sum3.launches = 0
csr_segment_sum3.launches_bf16 = 0
