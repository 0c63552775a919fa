"""Row gathers whose gradient sums in a fixed order on either device.

The gradient of ``x[idx]`` adds the cotangent rows of repeated ids into
one row. PyTorch's own scatter-adds fix that order on one device each:
``index_put_(accumulate=True)`` sorts the ids on the card but adds from
parallel threads on the CPU, and ``index_add_`` is serial on the CPU but
adds by atomics on the card. Ranks that must compute the same gradient
bit for bit (the ranks of one data index on a mesh with a model axis,
``parallel/tables.py``) take the fixed-order one of their device.
"""

from __future__ import annotations

import torch


def accumulate_rows(n: int, idx: torch.Tensor,
                    rows: torch.Tensor) -> torch.Tensor:
    """``out [n, ...]`` with ``out[idx[k]] += rows[k]``, summed in the same
    order on every run."""
    out = rows.new_zeros(n, *rows.shape[1:])
    if rows.is_cuda:
        return out.index_put_((idx,), rows, accumulate=True)
    return out.index_add_(0, idx, rows)


class TakeRowsFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx):
        ctx.n = x.shape[0]
        ctx.save_for_backward(idx)
        return x.index_select(0, idx)

    @staticmethod
    def backward(ctx, cot):
        (idx,) = ctx.saved_tensors
        return accumulate_rows(ctx.n, idx, cot.contiguous()), None


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` (``idx`` integer ids of ``x``'s rows); its gradient is
    ``accumulate_rows``'."""
    return TakeRowsFn.apply(x, idx.long())
