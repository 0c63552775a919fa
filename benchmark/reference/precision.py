"""The precision the reference computes its matrix products in.

``F32`` is float32 with TF32 off: the precision the configurations state.
``TF32`` rounds both operands of every matrix product (and, in the
backward, the incoming gradient) to TF32's 10-bit mantissa and
accumulates in float32, as the tensor cores do with TF32 on. It is the
lower-precision control of a configuration whose program has no lower
precision of its own; the rounding is done here, so it reads the same on
the card and on the CPU.
"""

from __future__ import annotations

import torch


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to the nearest TF32 value (ties away from
    zero), as float32."""
    bits = x.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    return rounded.view(torch.float32)


class _Tf32Mm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return to_tf32(a) @ to_tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = to_tf32(g)
        return g @ to_tf32(b).t(), to_tf32(a).t() @ g


class Precision:
    def __init__(self, name: str):
        if name not in ("f32", "tf32"):
            raise ValueError(f"unknown reference precision {name!r}")
        self.name = name

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "tf32":
            return _Tf32Mm.apply(a, b)
        return a @ b

    def linear(self, x: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
        """``x · weightᵀ + bias`` (``weight`` ``[out, in]``, as
        ``torch.nn.Linear`` keeps it)."""
        return self.mm(x, weight.t()) + bias


F32 = Precision("f32")
TF32 = Precision("tf32")


def strict_f32() -> None:
    """Keep PyTorch's own float32 products out of TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
