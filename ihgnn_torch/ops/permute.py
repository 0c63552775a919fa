"""K6/K7: row-local permutes and block transposes of an ``[R, C]`` grid of
rows, and their plain twins.

Counterpart of ``ihgnn_tpu/ops/pallas/permute.py``: the stage kernels that
run a Clos-routed permutation (``ops/benes.py``) on the TPU. Every one of
them moves whole rows (a row is the ``d`` features of one grid element),
so the card runs all of them as one row-copy kernel (``csrc/permute.cu``),
each output row reading the source row that ``(mode, p)`` names:

* ``row_local_permute(x [R, C, …], p [R, C])`` → ``[R, C, …]``:
  ``out[r, c] = x[r, p[r, c]]`` — K6, ``row_local_permute`` (``:114``)
  and its int8, hier, dg, dg2 and bfly variants (``:429``, ``:517``,
  ``:718``, ``:770``, ``:1136``, ``:1385``), which differ only in how the
  TPU encodes ``p``;
* ``transposed_local_permute(x [R, C, …], p [R, C])`` → ``[C, R, …]``:
  ``out[c, r] = x[r, p[r, c]]``, a row-local permute then a transpose —
  K7, ``transposed_local_permute`` (``:289``) and its dg, hier and bfly
  variants (``:869``, ``:1251``, ``:1306``); with ``p=None`` the plain
  ``block_transpose`` (``:187``);
* ``transposed_local_permute(x [R, C, …], p [C, R], pre=True)`` →
  ``[R, C, …]``: ``out[r, c] = x[p[c, r], c]``, a transpose, a row-local
  permute and a transpose back — ``transposed_local_permute_dg_pre``
  (``:980``).

The two-stream forms ``block_transpose2`` (``:807``) and
``row_local_permute_dg2`` (``:770``) are two launches here. The port keeps
every stage as a plain int32 table (the TPU's dg words, hier and bfly
packings and int8 byte planes do not carry over). A copy is exact, so the
kernel serves f32 and bf16 rows alike.

Host part: ``pick_grid`` (``permute.py:45``), the ``[R, C]`` grid of an
E-element routed permutation.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ihgnn_torch.ops import _build

MODE_RLP, MODE_BT, MODE_TLP, MODE_PRE = 0, 1, 2, 3
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def pick_grid(e: int, c: int = 1024) -> Tuple[int, int]:
    """``(R, C)`` of an E-element permutation: C a power of two (Euler
    colouring) near sqrt(E) and at most ``c``, halved while the grid would
    have 64 rows or fewer; R a multiple of 128. E pads to R·C."""
    c = min(c, max(128, 1 << (e.bit_length() // 2)))
    while c > 128 and -(-e // c) <= 64:
        c //= 2
    return _round_up(-(-e // c), 128), c


def row_local_permute_plain(x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Plain twin of ``row_local_permute`` (any device)."""
    idx = p.long().reshape(*p.shape, *([1] * (x.dim() - 2)))
    return torch.gather(x, 1, idx.expand_as(x))


def transposed_local_permute_plain(x: torch.Tensor,
                                   p: Optional[torch.Tensor] = None,
                                   pre: bool = False) -> torch.Tensor:
    """Plain twin of ``transposed_local_permute`` (any device)."""
    if pre:
        y = row_local_permute_plain(x.transpose(0, 1), p)
        return y.transpose(0, 1).contiguous()
    if p is not None:
        x = row_local_permute_plain(x, p)
    return x.transpose(0, 1).contiguous()


def _launch(what: str, x: torch.Tensor, p: Optional[torch.Tensor],
            out: Optional[torch.Tensor], out_shape, mode: int) -> torch.Tensor:
    """Checks the kernel's inputs and runs ``csrc/permute.cu``."""
    _build.require(x.dtype in (torch.float32, torch.bfloat16)
                   and x.is_contiguous() and x.data_ptr() % 16 == 0, what,
                   "x must be contiguous, 16-byte aligned f32 or bf16")
    rows, cols = x.shape[0], x.shape[1]
    row_bytes = x[0, 0].numel() * x.element_size() if x.numel() else 0
    _build.require(row_bytes % 16 == 0, what,
                   "the kernel copies 16-byte vectors: a row must be a "
                   "multiple of 16 bytes")
    _build.require(x.numel() * x.element_size() // 16 < 2 ** 31, what,
                   "the grid must hold fewer than 2^31 16-byte vectors")
    if p is not None:
        _build.require(p.dtype == torch.int32 and p.is_contiguous(), what,
                       "p must be a contiguous int32 table")
    if out is None:
        out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    else:
        _build.require(tuple(out.shape) == tuple(out_shape)
                       and out.dtype == x.dtype and out.is_contiguous()
                       and out.data_ptr() % 16 == 0, what,
                       f"out must be a contiguous, aligned {tuple(out_shape)} "
                       f"{x.dtype} tensor")
    if x.numel() == 0:
        return out
    fn = _build.function("permute", "ihgnn_permute_rows", _ARGTYPES)
    err = fn(x.data_ptr(), None if p is None else p.data_ptr(),
             out.data_ptr(), rows, cols, row_bytes // 16, mode,
             _build.stream_ptr(x.device))
    _build.check("permute", what, err)
    return out


def _check_table(what: str, p: torch.Tensor, shape) -> None:
    if tuple(p.shape) != tuple(shape):
        raise ValueError(f"{what}: p {tuple(p.shape)} is not {tuple(shape)}")


def row_local_permute(x: torch.Tensor, p: torch.Tensor,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[r, c] = x[r, p[r, c]]`` for ``x`` ``[R, C, …]`` and an int32
    ``p`` ``[R, C]`` whose rows are permutations of ``range(C)``. CPU
    tensors run the plain twin; CUDA tensors launch ``csrc/permute.cu``
    (written into ``out`` when given) and count one in
    ``row_local_permute.launches`` (f32 rows) or
    ``row_local_permute.launches_bf16`` (bf16 rows)."""
    what = "row_local_permute"
    _check_table(what, p, x.shape[:2])
    if not _build.use_kernel(what, x, p, out):
        y = row_local_permute_plain(x, p)
        return y if out is None else out.copy_(y)
    y = _launch(what, x, p, out, x.shape, MODE_RLP)
    _build.count(row_local_permute, x.dtype == torch.bfloat16)
    return y


row_local_permute.launches = 0
row_local_permute.launches_bf16 = 0


def transposed_local_permute(x: torch.Tensor,
                             p: Optional[torch.Tensor] = None,
                             pre: bool = False,
                             out: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """The transposed forms, for ``x`` ``[R, C, …]``:

    * ``p`` None: the block transpose, ``out[c, r] = x[r, c]``, ``[C, R, …]``;
    * ``p`` ``[R, C]``: ``out[c, r] = x[r, p[r, c]]``, ``[C, R, …]``;
    * ``pre=True``, ``p`` ``[C, R]``: ``out[r, c] = x[p[c, r], c]``,
      ``[R, C, …]``.

    CPU tensors run the plain twin; CUDA tensors launch ``csrc/permute.cu``
    (written into ``out`` when given) and count one in
    ``transposed_local_permute.launches`` (f32 rows) or
    ``transposed_local_permute.launches_bf16`` (bf16 rows)."""
    what = "transposed_local_permute"
    rows, cols = x.shape[0], x.shape[1]
    if pre:
        if p is None:
            raise ValueError(f"{what}: the pre form needs a table")
        _check_table(what, p, (cols, rows))
        out_shape, mode = x.shape, MODE_PRE
    else:
        if p is not None:
            _check_table(what, p, (rows, cols))
        out_shape = (cols, rows, *x.shape[2:])
        mode = MODE_BT if p is None else MODE_TLP
    if not _build.use_kernel(what, x, p, out):
        y = transposed_local_permute_plain(x, p, pre)
        return y if out is None else out.copy_(y)
    y = _launch(what, x, p, out, out_shape, mode)
    _build.count(transposed_local_permute, x.dtype == torch.bfloat16)
    return y


transposed_local_permute.launches = 0
transposed_local_permute.launches_bf16 = 0
