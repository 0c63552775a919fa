"""Shared small modules: the torch-initialized Linear, ``MLP`` and
``Aggregation``.

Counterpart of ``ihgnn_tpu/models/common.py`` ``TorchDense``,
``TorchDenseT``, ``MLP`` and ``Aggregation`` (Models/CommonLayers.py:7-26).
The JAX package keeps two Linears because it lays features out
feature-major ([in, N]) in one and row-major in the other; the port is
row-major throughout, so both names are one ``nn.Linear``. A flax kernel
``[in, out]`` is ``weight.T`` here (``ihgnn_torch.convert``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ihgnn_torch.models.initializers import torch_linear_


class TorchDense(nn.Linear):
    """``nn.Linear(in_features, out_features)`` with its weights drawn from
    ``generator``: ``[*, in]`` → ``[*, out]``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_features, out_features, bias=bias)
        torch_linear_(self, generator)


TorchDenseT = TorchDense


LEAKY_SLOPE = 0.01  # torch nn.LeakyReLU default negative_slope


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=LEAKY_SLOPE)


class MLP(nn.Module):
    """Linear(in, in) → LeakyReLU → Linear(in, out)
    (CommonLayers.py:7-16)."""

    def __init__(self, in_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc1 = TorchDense(in_features, in_features, generator=generator)
        self.fc2 = TorchDense(in_features, out_features, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(leaky_relu(self.fc1(x)))


class Aggregation(nn.Module):
    """Linear(in, out) → LeakyReLU (CommonLayers.py:18-26)."""

    def __init__(self, in_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc = TorchDense(in_features, out_features, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu(self.fc(x))
