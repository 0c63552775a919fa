"""The data × model mesh of the port's ranks.

Counterpart of ``ihgnn_tpu/parallel/mesh.py`` ``make_mesh``. JAX lays a
grid of devices under one program; here each rank is one
``torch.distributed`` process, and ``make_mesh`` reads the grid off an
initialised process group:

* axis ``data`` splits the training batch and the hyperedges (and the 2D
  graph's entries): rank r holds the r-th contiguous slice and the full
  node tables. Node sums are partials, combined over the axis by
  collectives (``parallel/collectives.py``).
* axis ``model`` (the tables' rows over ranks) is not ported: a mesh with
  ``model > 1`` raises, naming ROADMAP item 8c.

The backend is the caller's choice, never swapped: NCCL where every rank
has a card of its own, gloo where ranks share a card (NCCL refuses two
ranks on one GPU; gloo moves CUDA tensors through the host) or run on the
CPU. ``pick_backend`` says which a layout needs.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """This process's place on a (data, model) mesh: ``rank`` on the data
    axis of ``data`` ranks, their process ``group`` and its ``backend``.

    ``bf16_wire`` is the JAX package's ``IHGNN_BF16_RS`` switch as an
    argument (default on, as there): on bf16 edge streams a node partial
    is rounded to bf16 and combined by one bf16 all-reduce
    (``ihgnn_tpu/ops/hyperagg.py:702``)."""

    def __init__(self, data: int, model: int, rank: int, group,
                 backend: str, bf16_wire: bool = True):
        self.data, self.model, self.rank = data, model, rank
        self.group, self.backend, self.bf16_wire = group, backend, bf16_wire

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    def block(self, n: int) -> slice:
        """This rank's contiguous slice of an axis of ``n`` (a multiple of
        ``data``) entries."""
        if n % self.data:
            raise ValueError(f"an axis of {n} does not split into "
                             f"{self.data} equal slices; pad it first")
        size = n // self.data
        return slice(self.rank * size, (self.rank + 1) * size)

    def __repr__(self) -> str:
        return (f"Mesh(data={self.data}, model={self.model}, "
                f"rank={self.rank}, backend={self.backend!r}, "
                f"bf16_wire={self.bf16_wire})")


def pick_backend(world_size: int, device: torch.device) -> str:
    """``"nccl"`` when ``device`` is a card and there is one card a rank,
    else ``"gloo"`` (ranks on the CPU, or ranks sharing cards)."""
    if device.type == "cuda" and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def make_mesh(cfg, backend: str, group=None,
              bf16_wire: bool = True) -> Mesh:
    """The ``Mesh`` of ``cfg`` (``MeshConfig``: data × model) over the
    initialised process group ``group`` (the default group when None).

    Raises when ``torch.distributed`` is not initialised, when its backend
    is not ``backend``, when its world size is not data × model, and
    (``NotImplementedError``) when model > 1."""
    if cfg.model > 1:
        raise NotImplementedError(
            f"a mesh with model = {cfg.model} shards the tables' rows over "
            "ranks: not ported to ihgnn_torch yet (ROADMAP queue 1 item 8c)")
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed "
                           "process group (init_process_group)")
    have = dist.get_backend(group)
    if have != backend:
        raise ValueError(f"the process group runs {have!r}, not {backend!r}")
    world = dist.get_world_size(group)
    need = cfg.data * cfg.model
    if world != need:
        raise ValueError(f"mesh {cfg.data}x{cfg.model} needs {need} ranks, "
                         f"the process group has {world}")
    return Mesh(cfg.data, cfg.model, dist.get_rank(group), group, backend,
                bf16_wire)
