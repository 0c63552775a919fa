"""Hyperedge feature interaction — the "I" in IHGNN.

Counterpart of ``ihgnn_tpu/models/interaction.py`` ``FeatureInteractor``
(reference: Models/CommonLayers.py:29-87). Per hyperedge e = (u, q, i):

  order 1: [u, q, i]                      → Linear(3d, out)
  order 2: [u, q, i, u⊙q, q⊙i, i⊙u]       → Linear(6d, out)
  order 3: order 2 + [u⊙q⊙i]              → Linear(7d, out)

The projection runs in K3 through ``InteractFn`` (``ops/interact.py``):
``interact_fwd`` forward, ``interact_bwd`` backward; neither writes a part
to memory. On a routed pack the IHGNN layer asks for the absorbed form
(``interaction.py:81-107,135-138``): K5 through ``InteractAbsorbFn``, the
i rows in t1 order and two outputs. The parameters are one Linear named
``aggregation``, as in the JAX package's ``aggregation/dense`` tree.

Under a mesh (``parallel/``) a rank runs the interaction on its own edges
as it is: du, dq, di stay the rank's, and its dW and db are partials that
the step sums over the ranks with every other gradient
(``reduce_gradients``), so it takes no ``mesh`` argument, where the JAX
package's sums them inside ``fused_interaction_sharded``
(``interaction.py:81-145``, ``ops/pallas/interact.py:484-565``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ihgnn_torch.models.common import TorchDense
from ihgnn_torch.ops.interact import (ORDER_PARTS, InteractAbsorbFn,
                                      InteractFn)
from ihgnn_torch.ops.packing import AnyHyperPack


class FeatureInteractor(nn.Module):
    def __init__(self, max_order: int, feature_dim: int, output_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if max_order not in ORDER_PARTS:
            raise ValueError(f"interaction order must be 1, 2 or 3, got "
                             f"{max_order}")
        self.max_order = max_order
        self.aggregation = TorchDense(ORDER_PARTS[max_order] * feature_dim,
                                      output_dim, generator=generator)

    def forward(self, roles: torch.Tensor,
                absorb: Optional[AnyHyperPack] = None):
        """``[3, E, d]`` (u, q, i) role rows in edge order → ``[E, out]``.

        ``absorb``: the routed pack whose σ-ordered rows ``roles`` holds,
        with the i rows in t1 order; returns the absorbed interaction's
        ``(o1, o2)``, o1 in σ order and o2 = ρ(o1). On a chunked pack π is
        the chunks' stage-2 tables stacked on the row axis
        (``absorb_tables``, ``hyperagg.py:531-553``)."""
        agg = self.aggregation
        w = agg.weight.t().contiguous()
        if absorb is not None:
            pi, mask = absorb.absorb_tables()
            return InteractAbsorbFn.apply(roles, w, agg.bias, pi, mask,
                                          self.max_order)
        return InteractFn.apply(roles, w, agg.bias, self.max_order)
