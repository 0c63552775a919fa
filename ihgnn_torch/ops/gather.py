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
"""

from __future__ import annotations

import ctypes

import torch

from ihgnn_torch.ops import _build

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p]


def gather_roles_plain(x: torch.Tensor, i3: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of ``gather_roles`` (any device)."""
    return x[i3.t().long()]


def gather_roles(x: torch.Tensor, i3: torch.Tensor) -> torch.Tensor:
    """``[3, E, d]``: the (u, q, i) endpoint rows of every edge. CPU
    tensors run the plain twin; CUDA tensors launch ``csrc/gather.cu`` and
    count one in ``gather_roles.launches``."""
    what = "gather_roles"
    if not _build.use_kernel(what, x, i3):
        return gather_roles_plain(x, i3)
    _build.require(x.dim() == 2 and x.dtype == torch.float32
                   and x.is_contiguous(), what, "x must be contiguous [N, d] f32")
    _build.require(x.shape[1] % 4 == 0 and x.data_ptr() % 16 == 0, what,
                   "the kernel copies 16-byte vectors: d must be a multiple "
                   "of 4 and x 16-byte aligned")
    _build.require(i3.dim() == 2 and i3.shape[1] == 3
                   and i3.dtype == torch.int32 and i3.is_contiguous(), what,
                   "i3 must be contiguous [E, 3] int32")
    e, d = i3.shape[0], x.shape[1]
    _build.require(e * d // 4 < 2 ** 31, what, "E * d / 4 must fit in int32")
    out = torch.empty(3, e, d, dtype=x.dtype, device=x.device)
    if e == 0 or d == 0:
        return out
    fn = _build.function("gather", "ihgnn_gather_roles", _ARGTYPES)
    err = fn(x.data_ptr(), i3.data_ptr(), out[0].data_ptr(),
             out[1].data_ptr(), out[2].data_ptr(), e, d,
             _build.stream_ptr(x.device))
    _build.check("gather", what, err)
    gather_roles.launches += 1
    return out


gather_roles.launches = 0
