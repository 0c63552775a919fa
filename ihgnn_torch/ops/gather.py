"""K2: the three endpoint rows of every hyperedge, and its plain twin.

  out[r][e, :] = x[i3[e, r], :]     for r in (u, q, i)

Counterpart of ``ihgnn_tpu/ops/pallas/gather.py`` ``windowed_gather`` and
``windowed_gather_t`` composed with the Clos permute stages of
``ops/pallas/permute.py``: on the TPU the gather is a banded one-hot
expand followed by routed permutations; on the card it is one indexed row
copy that reads ``i3`` directly.

Layout: ``x`` row-major ``[N, d]``, ``i3`` int32 ``[E, 3]``; the result is
one ``[3, E, d]`` tensor (planes u, q, i, each in edge order) with ``x``'s
dtype, so the gradient that comes back to it is one ``[3E, d]`` buffer.

With ``dtype=torch.bfloat16`` (``ModelConfig.bf16_stream``) the roles are
bf16: the kernel's bf16 form copies bf16 rows of ``x``; an f32 ``x`` is
first rounded to nearest even into a bf16 table of its shape (one more
kernel of ``csrc/gather.cu``, into a ``torch.empty`` buffer freed on
return: 44.8 MB at 700k × 32), the cast the JAX package makes before its
gather. The copy moves 16-byte vectors where ``segsum.bf16_form`` says so
for x and the three output planes (d % 8 == 0, 16-byte aligned), else
8-byte vectors (d % 4 == 0, 8-byte aligned): K1's lane rule, which
``csrc/gather.cu`` ``bf16_vec_bytes`` applies too. One call counts
one in ``gather_roles.launches_bf16``; the f32 form counts in
``gather_roles.launches``.

The routed path (``ops/hyperagg.py``) expands through the single-index
forms, the TPU's windowed expands themselves, over a pack's absolute
``[R, C]`` index tables:

* ``gather_rows(x, idx)``   — ``[R, C, d]``, ``out[r, c] = x[idx[r, c]]``
  (``windowed_gather``, ``gather.py:188``);
* ``gather_rows_t(x, idx)`` — ``[C, R, d]``, ``out[c, r] = x[idx[r, c]]``
  (``windowed_gather_t``, ``:374``: the expand and a block transpose).

Both take ``dtype=torch.bfloat16`` (the routed pack's bf16 streams) as
``gather_roles`` does: bf16 rows from an f32 x (rounded in the copy) or a
bf16 x, counted in ``launches_bf16``.

``gather_scalars(x, idx)`` is their d = 1 form, ``out[k] = x[idx[k]]``
over an f32 ``[N]`` stream: the routed GAT's ``[1, N]`` expands by
destination (``windowed_gather`` on the TPU, ``gatconv.py:300-330``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ihgnn_torch.ops import _build
from ihgnn_torch.ops.segsum import bf16_form

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p]
_BF16_ARGTYPES = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
STREAM_DTYPES = (torch.float32, torch.bfloat16)
_ROWS_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
    ctypes.c_void_p]
_ROWS_BF16_ARGTYPES = [ctypes.c_void_p, ctypes.c_int] + [
    ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_ROUND_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_longlong,
                                           ctypes.c_void_p]


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """A new bf16 tensor of ``x``'s shape, each value of the contiguous,
    16-byte aligned f32 CUDA tensor ``x`` (d % 4 == 0) rounded to nearest
    even by ``csrc/gather.cu``: the first kernel of K2's bf16 form from an
    f32 ``x`` (counted with its copy in ``gather_roles``)."""
    table = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    fn = _build.function("gather", "ihgnn_round_bf16", _ROUND_ARGTYPES)
    _build.check("gather", "round_bf16", fn(
        x.data_ptr(), table.data_ptr(), x.numel(),
        _build.stream_ptr(x.device)))
    return table


def gather_roles_plain(x: torch.Tensor, i3: torch.Tensor,
                       dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain PyTorch twin of ``gather_roles`` (any device)."""
    return x.to(dtype or x.dtype)[i3.t().long()]


def gather_roles(x: torch.Tensor, i3: torch.Tensor,
                 dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``[3, E, d]``: the (u, q, i) endpoint rows of every edge, in
    ``dtype`` (default ``x``'s). CPU tensors run the plain twin; CUDA
    tensors launch ``csrc/gather.cu``: the f32 form (f32 ``x`` and roles,
    counted in ``gather_roles.launches``) or the bf16 form (bf16 roles
    copied from a bf16 ``x``, or from an f32 ``x`` rounded first into a
    bf16 table; counted in ``gather_roles.launches_bf16``)."""
    what = "gather_roles"
    dtype = dtype or x.dtype
    if dtype not in STREAM_DTYPES:
        raise ValueError(f"{what}: roles in {dtype}; the forms write f32 or "
                         "bf16")
    if not _build.use_kernel(what, x, i3):
        return gather_roles_plain(x, i3, dtype)
    bf16 = dtype == torch.bfloat16
    _build.require(x.dim() == 2 and x.dtype in (
        STREAM_DTYPES if bf16 else (torch.float32,)) and x.is_contiguous(),
        what, "x must be contiguous [N, d], f32 (or bf16 for bf16 roles)")
    if x.dtype == torch.float32:
        _build.require(x.shape[1] % 4 == 0 and x.data_ptr() % 16 == 0, what,
                       "f32 rows are read four features a thread: d must "
                       "be a multiple of 4 and x 16-byte aligned")
    _build.require(i3.dim() == 2 and i3.shape[1] == 3
                   and i3.dtype == torch.int32 and i3.is_contiguous(), what,
                   "i3 must be contiguous [E, 3] int32")
    e, d = i3.shape[0], x.shape[1]
    _build.require(e * d // 4 < 2 ** 31, what, "E * d / 4 must fit in int32")
    out = torch.empty(3, e, d, dtype=dtype, device=x.device)
    if e == 0 or d == 0:
        return out
    if bf16:
        stream = _build.stream_ptr(x.device)
        if x.dtype == torch.float32:
            x = round_bf16(x)
        _build.require(bf16_form(d, x, *out) > 0, what,
                       "the bf16 copy moves 8 or 4 features a thread: d "
                       "must be a multiple of 4 and x 8-byte aligned")
        fn = _build.function("gather", "ihgnn_gather_roles_bf16",
                             _BF16_ARGTYPES)
        err = fn(x.data_ptr(), 1, i3.data_ptr(), out[0].data_ptr(),
                 out[1].data_ptr(), out[2].data_ptr(), e, d, stream)
    else:
        fn = _build.function("gather", "ihgnn_gather_roles", _ARGTYPES)
        err = fn(x.data_ptr(), i3.data_ptr(), out[0].data_ptr(),
                 out[1].data_ptr(), out[2].data_ptr(), e, d,
                 _build.stream_ptr(x.device))
    _build.check("gather", what, err)
    _build.count(gather_roles, bf16)
    return out


gather_roles.launches = 0
gather_roles.launches_bf16 = 0


def gather_rows_plain(x: torch.Tensor, idx: torch.Tensor,
                      transposed: bool = False,
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain twin of ``gather_rows`` / ``gather_rows_t`` (any device)."""
    out = x.to(dtype or x.dtype)[idx.long()]
    return out.transpose(0, 1).contiguous() if transposed else out


def _gather_rows(wrapper, name: str, x: torch.Tensor, idx: torch.Tensor,
                 out: Optional[torch.Tensor], transposed: bool,
                 dtype: Optional[torch.dtype]) -> torch.Tensor:
    """Checks, then the CPU twin or one launch of ``name`` (its bf16 form,
    ``name + "_bf16"``, for bf16 rows out), counted on ``wrapper``. The
    rows come out in ``out``'s dtype, else ``dtype``, else ``x``'s."""
    what = wrapper.__name__
    if idx.dim() != 2:
        raise ValueError(f"{what}: idx must be an [R, C] table")
    dtype = out.dtype if out is not None else (dtype or x.dtype)
    if dtype not in STREAM_DTYPES:
        raise ValueError(f"{what}: rows in {dtype}; the forms write f32 or "
                         "bf16")
    rows, cols = idx.shape
    shape = ((cols, rows) if transposed else (rows, cols)) + (x.shape[1],)
    if not _build.use_kernel(what, x, idx, out):
        y = gather_rows_plain(x, idx, transposed, dtype)
        return y if out is None else out.copy_(y)
    bf16 = dtype == torch.bfloat16
    _build.require(x.dim() == 2 and x.dtype in (
        STREAM_DTYPES if bf16 else (torch.float32,)) and x.is_contiguous()
        and x.shape[1] % 4 == 0 and x.data_ptr() % 16 == 0, what,
        "x must be contiguous, 16-byte aligned [N, d] f32 (or bf16 for bf16 "
        "rows) with d a multiple of 4")
    _build.require(idx.dtype == torch.int32 and idx.is_contiguous(), what,
                   "idx must be a contiguous int32 table")
    if out is None:
        out = torch.empty(shape, dtype=dtype, device=x.device)
    else:
        _build.require(tuple(out.shape) == shape and out.is_contiguous()
                       and out.data_ptr() % 16 == 0, what,
                       f"out must be a contiguous, aligned {shape} tensor")
    if bf16:
        fn = _build.function("gather", name + "_bf16", _ROWS_BF16_ARGTYPES)
        err = fn(x.data_ptr(), int(x.dtype == torch.bfloat16),
                 idx.data_ptr(), out.data_ptr(), rows, cols, x.shape[1],
                 _build.stream_ptr(x.device))
    else:
        fn = _build.function("gather", name, _ROWS_ARGTYPES)
        err = fn(x.data_ptr(), idx.data_ptr(), out.data_ptr(), rows, cols,
                 x.shape[1], _build.stream_ptr(x.device))
    _build.check("gather", what, err)
    _build.count(wrapper, bf16)
    return out


def gather_rows(x: torch.Tensor, idx: torch.Tensor,
                out: Optional[torch.Tensor] = None,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``[R, C, d]``: ``out[r, c] = x[idx[r, c]]`` for an int32 ``idx``
    ``[R, C]`` of row ids of ``x`` ``[N, d]``, in ``out``'s dtype, else
    ``dtype``, else ``x``'s. CPU tensors run the plain twin; CUDA tensors
    launch ``csrc/gather.cu`` (written into ``out`` when given) and count
    one in ``gather_rows.launches`` (f32 rows) or
    ``gather_rows.launches_bf16`` (bf16 rows)."""
    return _gather_rows(gather_rows, "ihgnn_gather_rows", x, idx, out, False,
                        dtype)


gather_rows.launches = 0
gather_rows.launches_bf16 = 0


def gather_rows_t(x: torch.Tensor, idx: torch.Tensor,
                  out: Optional[torch.Tensor] = None,
                  dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``[C, R, d]``: ``out[c, r] = x[idx[r, c]]``, ``gather_rows`` written
    transposed. CPU tensors run the plain twin; CUDA tensors launch
    ``csrc/gather.cu`` and count one in ``gather_rows_t.launches`` or
    ``gather_rows_t.launches_bf16``."""
    return _gather_rows(gather_rows_t, "ihgnn_gather_rows_t", x, idx, out,
                        True, dtype)


gather_rows_t.launches = 0
gather_rows_t.launches_bf16 = 0


_SCALARS_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                             ctypes.c_void_p]


def gather_scalars_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain twin of ``gather_scalars`` (any device)."""
    return x[idx.long()]


def gather_scalars(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[k] = x[idx[k]]``, ``idx``'s shape, for an f32 ``x`` ``[N]``
    and int32 row ids ``idx``: K2's d = 1 form. CPU tensors run the plain
    twin; CUDA tensors launch ``csrc/gather.cu`` and count one in
    ``gather_scalars.launches``."""
    what = "gather_scalars"
    if not _build.use_kernel(what, x, idx):
        return gather_scalars_plain(x, idx)
    _build.require(x.dim() == 1 and x.dtype == torch.float32
                   and x.is_contiguous(), what, "x must be contiguous [N] "
                   "f32")
    _build.require(idx.dtype == torch.int32 and idx.is_contiguous(), what,
                   "idx must be contiguous int32")
    out = torch.empty(idx.shape, dtype=torch.float32, device=x.device)
    if idx.numel() == 0:
        return out
    fn = _build.function("gather", "ihgnn_gather_scalars", _SCALARS_ARGTYPES)
    _build.check("gather", what, fn(x.data_ptr(), idx.data_ptr(),
                                    out.data_ptr(), idx.numel(),
                                    _build.stream_ptr(x.device)))
    gather_scalars.launches += 1
    return out


gather_scalars.launches = 0
