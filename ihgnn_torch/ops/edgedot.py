"""The per-entry dot of two gathered rows over a CSR, and its plain twin.

  csr_edge_dot(a, b, col, rowptr)[k] = <a[s], b[col[k]]>,
      k ∈ [rowptr[s], rowptr[s+1])

Not a port of one TPU kernel: on the TPU the attention's per-entry dots
(``ihgnn_tpu/ops/gatconv.py:256-263,299-300``) are K2 ``windowed_gather``
plus the K6/K7 permute stages expanding both operands into ``[d, K]``
streams, then an XLA multiply-reduce. Here the two row gathers are folded
into the dot (``csrc/edgedot.cu``), as K1 folds its gather. It serves the
GAT backward's ``<x[src], cot[dst]>``, the product head's scores and that
head's backward.

Layout: ``a`` ``[S, d]`` and ``b`` ``[M, d]`` contiguous f32 with d a
multiple of 4 and 16-byte aligned data; ``col`` int32 ``[K]``, ``rowptr``
int32 ``[S+1]``; the result is f32 ``[K]``.
"""

from __future__ import annotations

import ctypes

import torch

from ihgnn_torch.ops import _build
from ihgnn_torch.ops.segment import segment_ids

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p]


def csr_edge_dot_plain(a: torch.Tensor, b: torch.Tensor, col: torch.Tensor,
                       rowptr: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of ``csr_edge_dot`` (any device)."""
    return (a[segment_ids(rowptr)] * b[col.long()]).sum(1)


def csr_edge_dot(a: torch.Tensor, b: torch.Tensor, col: torch.Tensor,
                 rowptr: torch.Tensor) -> torch.Tensor:
    """``[K]`` dots of ``a``'s segment row with ``b``'s entry row (see the
    module docstring). CPU tensors run the plain twin; CUDA tensors launch
    ``csrc/edgedot.cu`` and count one in ``csr_edge_dot.launches``."""
    what = "csr_edge_dot"
    if not _build.use_kernel(what, a, b, col, rowptr):
        return csr_edge_dot_plain(a, b, col, rowptr)
    for name, t in (("a", a), ("b", b)):
        _build.require(t.dim() == 2 and t.dtype == torch.float32
                       and t.is_contiguous() and t.data_ptr() % 16 == 0,
                       what, f"{name} must be contiguous 16-byte aligned "
                       "[rows, d] f32")
    d = a.shape[1]
    _build.require(b.shape[1] == d and d % 4 == 0 and d > 0, what,
                   "a and b must have one width d, a multiple of 4")
    for name, t in (("col", col), ("rowptr", rowptr)):
        _build.require(t.dim() == 1 and t.dtype == torch.int32
                       and t.is_contiguous(), what,
                       f"{name} must be contiguous 1-D int32")
    s = rowptr.shape[0] - 1
    _build.require(a.shape[0] >= s, what, f"a has fewer than {s} rows")
    out = torch.empty(col.shape[0], dtype=torch.float32, device=a.device)
    if s == 0 or col.shape[0] == 0:
        return out
    fn = _build.function("edgedot", "ihgnn_csr_edge_dot", _ARGTYPES)
    err = fn(a.data_ptr(), b.data_ptr(), col.data_ptr(), rowptr.data_ptr(),
             out.data_ptr(), s, d, _build.stream_ptr(a.device))
    _build.check("edgedot", what, err)
    csr_edge_dot.launches += 1
    return out


csr_edge_dot.launches = 0
