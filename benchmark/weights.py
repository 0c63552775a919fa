"""The weights of a run, drawn on the device from the seed.

Every parameter that ``reference.rawgnn.leaves`` lists is drawn on one
``torch.Generator`` of the device: one uniform draw for all the uniform
leaves, scaled leaf by leaf; a normal leaf (the HEM head's item biases)
takes the n quantiles of N(0, 1) in an order drawn from the seed. The
item biases decide which items lead every ranking, and the work of the
catalog's top-k selection depends on how the leading scores are spread,
so every seed ranks against the same set of biases. The same seed on the
same device gives the same weights, so the reference draws them again
once the program has been freed.
"""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.reference import rawgnn


def draw(model: dict, sizes: dict, seed: int,
         device: torch.device) -> Dict[str, torch.Tensor]:
    specs = rawgnn.leaves(model, sizes)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    total = sum(int(torch.Size(shape).numel())
                for _, shape, init, _ in specs if init == "uniform")
    flat = torch.rand(total, generator=gen, device=device).mul_(2).sub_(1)
    at = 0
    out = {}
    for name, shape, init, scale in specs:
        n = int(torch.Size(shape).numel())
        if init == "normal":
            quantiles = torch.special.ndtri(
                (torch.arange(n, device=device, dtype=torch.float64) + 0.5)
                / n).float()
            order = torch.randperm(n, generator=gen, device=device)
            w = quantiles[order].view(shape).mul_(scale)
        else:
            w = flat[at:at + n].view(shape).mul_(scale)
            at += n
        if name in ("embeddings.user_table", "embeddings.item_table"):
            w[0] = 0.0
        out[name] = w
    return out
