"""The data × model mesh of the port's ranks.

Counterpart of ``ihgnn_tpu/parallel/mesh.py`` ``make_mesh``. JAX lays a
grid of devices under one program; here each rank is one
``torch.distributed`` process, and ``make_mesh`` reads the grid off an
initialised process group. Rank ``w`` sits at ``(data, model)`` =
``(w // M, w % M)``, as JAX reshapes its device list to ``(D, M)``:

* axis ``data`` splits the training batch and the hyperedges (and the 2D
  graph's entries): the ranks of data index k hold the k-th contiguous
  slice. Node sums are partials, combined over the **data group** (the D
  ranks of one model index) by collectives (``parallel/collectives.py``).
* axis ``model`` splits the embedding tables' rows
  (``parallel/tables.py``): the ranks of one data index do the same work
  on the same slice, and each holds a block of every table's rows and of
  its Adam moments, gathered over the **model group** (the M ranks of one
  data index) when the features are built. With ``table_shard_both`` the
  rows split over all D·M ranks (``IHGNN_TABLE_SHARD_BOTH=1``,
  ``ihgnn_tpu/parallel/sharding.py:36-55``, here a keyword).

The backend is the caller's choice, never swapped: NCCL where every rank
of a host has a card of its own, gloo where ranks share a card (NCCL
refuses two ranks on one GPU; gloo moves CUDA tensors through the host)
or run on the CPU. ``pick_backend`` says which a layout needs.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """This process's place on a (data, model) mesh: its world ``rank``
    among ``data`` × ``model`` ranks, the process groups of its axes and
    their ``backend``.

    ``group`` is the data group (node partials, losses and replicated
    gradients are summed over it), ``model_group`` the model group (table
    blocks are gathered over it) and ``world_group`` every rank (None:
    the default group). ``bf16_wire`` is the JAX package's
    ``IHGNN_BF16_RS`` switch as an argument (default on, as there): on
    bf16 edge streams a node partial is rounded to bf16 and combined by
    one bf16 all-reduce (``ihgnn_tpu/ops/hyperagg.py:702``).
    ``table_shard_both`` splits the tables' rows over all ranks."""

    def __init__(self, data: int, model: int, rank: int, group,
                 backend: str, bf16_wire: bool = True, model_group=None,
                 world_group=None, table_shard_both: bool = False):
        self.data, self.model, self.rank = data, model, rank
        self.group, self.backend, self.bf16_wire = group, backend, bf16_wire
        self.model_group, self.world_group = model_group, world_group
        self.table_shard_both = table_shard_both

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def table_parts(self) -> int:
        """The blocks each table's rows split into: M, or D·M with
        ``table_shard_both``."""
        return self.data * self.model if self.table_shard_both else self.model

    @property
    def table_block(self) -> int:
        """This rank's block of a table's rows, model-major (JAX's
        ``P((model, data))``): block ``m·D + k`` sits at (k, m)."""
        if self.table_shard_both:
            return self.model_index * self.data + self.data_index
        return self.model_index

    def axis(self, name: str):
        """``(group, size)`` of axis ``name`` (data or model)."""
        if name == DATA_AXIS:
            return self.group, self.data
        if name == MODEL_AXIS:
            return self.model_group, self.model
        raise ValueError(f"no mesh axis {name!r}")

    def block(self, n: int) -> slice:
        """This rank's contiguous slice, by its data index, of an axis of
        ``n`` (a multiple of ``data``) entries."""
        if n % self.data:
            raise ValueError(f"an axis of {n} does not split into "
                             f"{self.data} equal slices; pad it first")
        size = n // self.data
        return slice(self.data_index * size, (self.data_index + 1) * size)

    def __repr__(self) -> str:
        return (f"Mesh(data={self.data}, model={self.model}, "
                f"rank={self.rank}, backend={self.backend!r}, "
                f"bf16_wire={self.bf16_wire}, "
                f"table_shard_both={self.table_shard_both})")


def pick_backend(local_world: int, device: torch.device) -> str:
    """``"nccl"`` when ``device`` is a card and this host has a card for
    each of its ``local_world`` ranks (rank on card ``LOCAL_RANK``), else
    ``"gloo"`` (ranks on the CPU, or ranks sharing cards). Across hosts
    the choice is by the host's own ranks, never the world size."""
    if device.type == "cuda" and torch.cuda.device_count() >= local_world:
        return "nccl"
    return "gloo"


def _new_groups(data: int, model: int, rank: int, backend: str):
    """The data and model groups of ``rank`` on a (data, model) mesh.
    Every rank creates every group, in one order (``new_group`` is
    collective over the default group)."""
    data_group = model_group = None
    for m in range(model):
        g = dist.new_group([k * model + m for k in range(data)],
                           backend=backend)
        if rank % model == m:
            data_group = g
    for k in range(data):
        g = dist.new_group([k * model + m for m in range(model)],
                           backend=backend)
        if rank // model == k:
            model_group = g
    return data_group, model_group


def make_mesh(cfg, backend: str, group=None, bf16_wire: bool = True,
              table_shard_both: bool = False) -> Mesh:
    """The ``Mesh`` of ``cfg`` (``MeshConfig``: data × model) over the
    initialised process group ``group`` (the default group when None).
    With ``model`` = 1 the data group is ``group`` itself; else the data
    and model groups are new groups of the default group, which must then
    be ``group``.

    Raises when ``torch.distributed`` is not initialised, when its backend
    is not ``backend``, or when its world size is not data × model."""
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
    rank = dist.get_rank(group)
    if cfg.model == 1:
        data_group: Optional[object] = group
        model_group = None
    else:
        if group is not None and group is not dist.group.WORLD:
            raise ValueError("a mesh with model > 1 spans the default "
                             "process group")
        data_group, model_group = _new_groups(cfg.data, cfg.model, rank,
                                              backend)
    return Mesh(cfg.data, cfg.model, rank, data_group, backend, bf16_wire,
                model_group=model_group, world_group=group,
                table_shard_both=table_shard_both)
