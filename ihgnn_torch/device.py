"""Device selection for the port's entry points."""

from __future__ import annotations

import dataclasses
from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a concrete ``torch.device``.

    ``"cuda"`` becomes the current CUDA device, and raises when PyTorch sees
    no card: the port never drops to the CPU on its own. Only ``cpu`` and
    ``cuda`` devices are accepted."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def model_device(model: torch.nn.Module,
                 device: DeviceLike = "cuda") -> torch.device:
    """``resolve_device(device)``; raises ``ValueError`` unless ``model``'s
    parameters are already there."""
    dev = resolve_device(device)
    model_dev = next(model.parameters()).device
    if model_dev != dev:
        raise ValueError(f"the model is on {model_dev}, not {dev}; "
                         "move it with model.to(device)")
    return dev


def moved(obj, device: DeviceLike):
    """A copy of the frozen dataclass ``obj`` with every tensor field on
    ``device``, and every nested dataclass field (or tuple of them) moved by
    its own ``to``."""
    dev = resolve_device(device)

    def move(v):
        if isinstance(v, torch.Tensor) or dataclasses.is_dataclass(v):
            return v.to(dev)
        if isinstance(v, tuple):
            return tuple(move(x) for x in v)
        return v

    return dataclasses.replace(obj, **{f.name: move(getattr(obj, f.name))
                                       for f in dataclasses.fields(obj)})
