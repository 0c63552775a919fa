"""K4 segment max, and the scalar segment sum, over a CSR; with plain twins.

  csr_segment_max(v, rowptr)[s] = max(-3e38, max_{k ∈ seg s} v[k])
  csr_segment_sum(v, rowptr)[s] = Σ_{k ∈ seg s} v[k]

``csr_segment_max`` is the counterpart of ``ihgnn_tpu/ops/pallas/segsum.py``
``csr_segment_max_t`` (the GAT destination-softmax stabiliser): an empty
segment reads -3e38, as that kernel gives, not the -inf of
``jax.ops.segment_max``. ``csr_segment_sum`` is K1 (``csr_segment_sum_t``)
on a scalar stream: the softmax denominators and the attention backward's
per-node sums. Both kernels live in ``csrc/segmax.cu``.

Layout: ``v`` contiguous f32 ``[K]``, ``rowptr`` int32 ``[S+1]``; the
result is f32 ``[S]``. The CUDA kernel (one for both reductions) reduces
each segment in a fixed order, so it repeats bit for bit: a segment of at
most ``LONG_SEGMENT`` entries from the identity in entry order (its sum is
the sequential f32 sum), a longer one by a block of ``BLOCK_THREADS``
threads. Thread t takes, in turn, entries t, t + BLOCK_THREADS, ... of the
head (the entries before the first 16-byte boundary), the 16-byte vectors
t, t + BLOCK_THREADS, ... of the body (each vector's four entries in
order), and entries t, t + BLOCK_THREADS, ... of the ragged tail; each
warp's 32 values then combine by xor shuffles (offsets 16, 8, 4, 2, 1),
and the warps' values in warp order.
"""

from __future__ import annotations

import ctypes

import torch

from ihgnn_torch.ops import _build
from ihgnn_torch.ops.segment import segment_ids, segment_max, segment_sum

EMPTY_MAX = -3.0e38   # an empty segment's max (segsum.py:791)
# csrc/segmax.cu's kLong and kThreads: the order of a long segment's sum
LONG_SEGMENT = 256
BLOCK_THREADS = 256

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]


def csr_segment_max_plain(v: torch.Tensor, rowptr: torch.Tensor
                          ) -> torch.Tensor:
    """Plain PyTorch twin of ``csr_segment_max`` (any device)."""
    return segment_max(v, segment_ids(rowptr), rowptr.shape[0] - 1,
                       empty=EMPTY_MAX)


def csr_segment_sum_plain(v: torch.Tensor, rowptr: torch.Tensor
                          ) -> torch.Tensor:
    """Plain PyTorch twin of ``csr_segment_sum`` (any device)."""
    return segment_sum(v, segment_ids(rowptr), rowptr.shape[0] - 1)


def csr_segment_sum_ordered(v: torch.Tensor, rowptr: torch.Tensor
                            ) -> torch.Tensor:
    """``csr_segment_sum`` in the CUDA kernel's order of f32 adds (the
    module docstring; ``v`` taken as starting on a 16-byte boundary), so
    it equals the kernel bit for bit on the same inputs: sequential sums
    for the segments of at most ``LONG_SEGMENT`` entries, the block order
    for the longer ones. Any device; for tests."""
    starts, ends = rowptr[:-1].long(), rowptr[1:].long()
    lengths = ends - starts
    out = torch.zeros(lengths.shape[0], dtype=torch.float32,
                      device=v.device)
    short = lengths <= LONG_SEGMENT
    for k in range(int(lengths[short].max()) if short.any() else 0):
        has = short & (k < lengths)
        idx = torch.where(has, starts + k, 0)
        out = torch.where(has, out + v[idx], out)
    lanes = torch.arange(BLOCK_THREADS, device=v.device)
    for s in torch.nonzero(~short).view(-1).tolist():
        lb, le = int(starts[s]), int(ends[s])
        ab = min((lb + 3) // 4 * 4, le)
        nv = (le - ab) // 4
        acc = torch.zeros(BLOCK_THREADS, dtype=torch.float32,
                          device=v.device)
        # head, body, tail: (first entry, items, entries an item); thread
        # t takes items t, t + BLOCK_THREADS, ...
        for first, items, size in ((lb, ab - lb, 1), (ab, nv, 4),
                                   (ab + 4 * nv, le - ab - 4 * nv, 1)):
            for r in range(0, items, BLOCK_THREADS):
                t = lanes[:min(BLOCK_THREADS, items - r)]
                for c in range(size):
                    acc[t] = acc[t] + v[first + size * (r + t) + c]
        for off in (16, 8, 4, 2, 1):
            acc = acc + acc[lanes ^ off]
        total = acc[0]
        for warp in range(1, BLOCK_THREADS // 32):
            total = total + acc[32 * warp]
        out[s] = total
    return out


def _launch(entry: str, wrapper, v: torch.Tensor,
            rowptr: torch.Tensor) -> torch.Tensor:
    what = wrapper.__name__
    _build.require(v.dim() == 1 and v.dtype == torch.float32
                   and v.is_contiguous(), what, "v must be contiguous [K] f32")
    _build.require(rowptr.dim() == 1 and rowptr.dtype == torch.int32
                   and rowptr.is_contiguous(), what,
                   "rowptr must be contiguous 1-D int32")
    s = rowptr.shape[0] - 1
    out = torch.empty(s, dtype=torch.float32, device=v.device)
    if s > 0:
        fn = _build.function("segmax", entry, _ARGTYPES)
        err = fn(v.data_ptr(), rowptr.data_ptr(), out.data_ptr(), s,
                 _build.stream_ptr(v.device))
        _build.check("segmax", what, err)
        wrapper.launches += 1
    return out


def csr_segment_max(v: torch.Tensor, rowptr: torch.Tensor) -> torch.Tensor:
    """``[S]`` per-segment max of ``v`` (see the module docstring). CPU
    tensors run the plain twin; CUDA tensors launch ``csrc/segmax.cu`` and
    count one in ``csr_segment_max.launches``."""
    if not _build.use_kernel("csr_segment_max", v, rowptr):
        return csr_segment_max_plain(v, rowptr)
    return _launch("ihgnn_csr_segment_max", csr_segment_max, v, rowptr)


def csr_segment_sum(v: torch.Tensor, rowptr: torch.Tensor) -> torch.Tensor:
    """``[S]`` per-segment sum of ``v``. CPU tensors run the plain twin;
    CUDA tensors launch ``csrc/segmax.cu`` and count one in
    ``csr_segment_sum.launches``."""
    if not _build.use_kernel("csr_segment_sum", v, rowptr):
        return csr_segment_sum_plain(v, rowptr)
    return _launch("ihgnn_csr_segment_sum", csr_segment_sum, v, rowptr)


csr_segment_max.launches = 0
csr_segment_sum.launches = 0
