"""The embedding tables' rows over the mesh's model axis, and the
one-device train state of a mesh's ranks.

Counterpart of ``ihgnn_tpu/parallel/sharding.py`` ``_table_spec`` and
``state_sharding`` (``:29-55``, ``:94-123``): JAX shards the rows of
``user_table``, ``item_table`` and ``vocab_table``, and Adam's moments
with them, over ``model`` (over ``(model, data)`` with
``IHGNN_TABLE_SHARD_BOTH=1``), padding the rows to a multiple of the
axis (``models/embedding.py`` ``row_multiple``). A rank here holds its
block of each table as the module's parameter, so ``torch.optim.Adam``
over the module keeps moments of the block only:

* ``shard_tables`` — cut a one-device model's tables into the rank's
  blocks: the rows padded with zero rows to ``parts · b``, block
  ``Mesh.table_block`` of ``b`` rows kept (``parts`` =
  ``Mesh.table_parts``). The whole table is drawn from the seed first, so
  every other weight is the one-device model's.
* ``GatherTablesFn`` — the full tables from every rank's blocks: one
  all-gather of the three blocks laid end to end over the model group
  (with ``table_shard_both``, first over the data group, then over the
  model group). Its backward gives each rank its own block of the
  cotangent summed over the data group (an all-reduce; with
  ``table_shard_both`` a reduce-scatter of the model index's rows): the
  ranks of one data index hold the same loss share, so a sum over all
  D·M ranks would count each share M times. ``reduce_gradients`` leaves
  the blocks out (``replicated_parameters``).
* ``shard_params`` / ``gather_params`` and ``shard_optimizer_state`` /
  ``gather_optimizer_state`` — a one-device state dict cut into a rank's
  blocks, and assembled from them (every rank calls the gathers);
  ``gather_grads`` the one-device gradients.
  Checkpoints hold the one-device format, so a run resumes on any mesh.

Pad rows are zero, never gathered by an id, and stay zero under Adam
(gradient 0, moments 0).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ihgnn_torch.parallel.collectives import _call
from ihgnn_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh

TABLES = ("user_table", "item_table", "vocab_table")


def block_rows(rows: int, parts: int) -> int:
    """The rows of one block of a table of ``rows`` rows in ``parts``."""
    return -(-rows // parts)


def cut_block(full: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's block (a copy) of ``full`` ``[rows, ...]``, zero rows
    past ``rows``."""
    parts, k = mesh.table_parts, mesh.table_block
    b = block_rows(full.shape[0], parts)
    out = full.new_zeros(b, *full.shape[1:])
    lo, hi = k * b, min((k + 1) * b, full.shape[0])
    if hi > lo:
        out[:hi - lo] = full[lo:hi]
    return out


def _gather(mesh: Mesh, rows: Sequence[int], blocks: Sequence[torch.Tensor],
            site: str) -> Tuple[torch.Tensor, ...]:
    """The full ``[rows_k, d]`` tables of every rank's ``blocks``."""
    d = blocks[0].shape[1]
    mine = torch.cat([b.reshape(b.shape[0], d) for b in blocks])
    total = mine.shape[0]
    if mesh.table_shard_both:
        column = mine.new_empty(mesh.data * total, d)
        _call("all-gather", column, mine, mesh, DATA_AXIS, site,
              timing="table")
        mine = column
    parts = mine.new_empty(mesh.model * mine.shape[0], d)
    _call("all-gather", parts, mine, mesh, MODEL_AXIS, site, timing="table")
    # [parts, total, d], blocks in model-major order
    parts = parts.view(mesh.table_parts, total, d)
    out, offset = [], 0
    for n, b in zip(rows, blocks):
        size = b.shape[0]
        out.append(parts[:, offset:offset + size].reshape(-1, d)[:n]
                   .reshape(n, *b.shape[1:]))
        offset += size
    return tuple(out)


class GatherTablesFn(torch.autograd.Function):
    """``(mesh, rows, *blocks)`` → the full tables (module docstring)."""

    @staticmethod
    def forward(ctx, mesh, rows, *blocks):
        ctx.mesh, ctx.rows = mesh, rows
        ctx.sizes = [b.shape[0] for b in blocks]
        return _gather(mesh, rows, [b.contiguous() for b in blocks],
                       "gather_tables")

    @staticmethod
    def backward(ctx, *cots):
        mesh, parts = ctx.mesh, ctx.mesh.table_parts
        d = cots[0].shape[1]
        mine = []
        for cot, n, size in zip(cots, ctx.rows, ctx.sizes):
            full = cot.new_zeros(parts * size, d)
            full[:n] = cot
            full = full.view(parts, size, d)
            if mesh.table_shard_both:
                m = mesh.model_index
                mine.append(full[m * mesh.data:(m + 1) * mesh.data])
            else:
                mine.append(full[mesh.table_block].unsqueeze(0))
        # [D or 1, b_total, d]: this model index's rows of every table
        mine = torch.cat(mine, dim=1)
        total = mine.shape[1]
        if mesh.table_shard_both:
            grad = mine.new_empty(total, d)
            _call("reduce-scatter", grad, mine.reshape(-1, d), mesh,
                  DATA_AXIS, "grad:gather_tables", timing="table")
        else:
            grad = mine.reshape(total, d).contiguous()
            _call("all-reduce", grad, None, mesh, DATA_AXIS,
                  "grad:gather_tables", timing="table")
        return (None, None, *grad.split(ctx.sizes))


def gather_tables(mesh: Mesh, rows: Sequence[int],
                  blocks: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """The full tables (``rows`` rows each) of every rank's ``blocks``,
    with autograd (``GatherTablesFn``)."""
    return GatherTablesFn.apply(mesh, tuple(rows), *blocks)


def shard_tables(model: nn.Module, mesh: Mesh) -> nn.Module:
    """``model`` (a one-device ``RawGnn``, before its optimizer is made)
    with its tables cut into this rank's blocks; unchanged when the mesh
    keeps whole tables (``table_parts`` 1)."""
    emb = model.embeddings
    if mesh.table_parts == 1:
        return model
    if emb.table_mesh is not None:
        raise ValueError("the tables are cut into blocks already")
    for name in TABLES:
        full = getattr(emb, name).detach()
        setattr(emb, name, nn.Parameter(cut_block(full, mesh)))
    emb.table_mesh = mesh
    return model


def table_blocks(model: nn.Module) -> List[nn.Parameter]:
    """The table parameters that are a rank's blocks (none on one
    device or with whole tables)."""
    emb = model.embeddings
    if emb.table_mesh is None:
        return []
    return [getattr(emb, name) for name in TABLES]


def replicated_parameters(model: nn.Module) -> List[nn.Parameter]:
    """The parameters every rank holds whole: all but the table blocks."""
    blocks = {id(p) for p in table_blocks(model)}
    return [p for p in model.parameters() if id(p) not in blocks]


_KEYS = [f"embeddings.{name}" for name in TABLES]


def shard_params(state: Dict[str, torch.Tensor],
                 mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    """A one-device ``RawGnn`` state dict with its tables cut into this
    rank's blocks (``state`` itself when the mesh keeps whole tables)."""
    if mesh is None or mesh.table_parts == 1:
        return state
    out = dict(state)
    for key in _KEYS:
        out[key] = cut_block(state[key], mesh)
    return out


def _rows(model: nn.Module) -> Tuple[int, ...]:
    rows = model.embeddings.rows
    return tuple(rows[name] for name in TABLES)


def gather_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The one-device state dict of ``model`` (a copy): the full tables
    gathered from every rank's blocks. Every rank of the mesh calls it."""
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    mesh = model.embeddings.table_mesh
    if mesh is None:
        return state
    with torch.no_grad():
        full = _gather(mesh, _rows(model), table_blocks(model),
                       "gather_params")
    state.update(zip(_KEYS, full))
    return state


def gather_grads(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Every parameter's ``.grad`` by name (copies), the tables' gathered
    from every rank's blocks: the one-device gradients. Every rank of the
    mesh calls it."""
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    mesh = model.embeddings.table_mesh
    if mesh is None:
        return grads
    with torch.no_grad():
        full = _gather(mesh, _rows(model),
                       [p.grad for p in table_blocks(model)], "gather_grads")
    grads.update(zip(_KEYS, full))
    return grads


def _table_indices(optimizer: torch.optim.Optimizer,
                   model: nn.Module) -> List[int]:
    """The optimizer state's indices of the three tables, in TABLES'
    order."""
    params = [p for group in optimizer.param_groups
              for p in group["params"]]
    emb = model.embeddings
    ids = {id(p): k for k, p in enumerate(params)}
    return [ids[id(getattr(emb, name))] for name in TABLES]


_MOMENTS = ("exp_avg", "exp_avg_sq")


def gather_optimizer_state(optimizer: torch.optim.Optimizer,
                           model: nn.Module) -> dict:
    """``optimizer.state_dict()`` with the tables' Adam moments gathered
    from every rank's blocks: the one-device optimizer's. Every rank of
    the mesh calls it."""
    state = optimizer.state_dict()
    mesh = model.embeddings.table_mesh
    if mesh is None:
        return state
    index = _table_indices(optimizer, model)
    out = {k: dict(v) for k, v in state["state"].items()}
    if all(k in out for k in index):
        for moment in _MOMENTS:
            with torch.no_grad():
                full = _gather(mesh, _rows(model),
                               [out[k][moment] for k in index],
                               "gather_optimizer_state")
            for k, t in zip(index, full):
                out[k][moment] = t
    return {"state": out, "param_groups": state["param_groups"]}


def shard_optimizer_state(state: dict, optimizer: torch.optim.Optimizer,
                          model: nn.Module) -> dict:
    """A one-device optimizer state dict with the tables' Adam moments
    cut into this rank's blocks, for ``optimizer.load_state_dict``."""
    mesh = model.embeddings.table_mesh
    if mesh is None:
        return state
    out = {k: dict(v) for k, v in state["state"].items()}
    for k in _table_indices(optimizer, model):
        if k in out:
            for moment in _MOMENTS:
                out[k][moment] = cut_block(out[k][moment], mesh)
    return {"state": out, "param_groups": state["param_groups"]}


def state_bytes(model: nn.Module, optimizer: torch.optim.Optimizer) -> dict:
    """This rank's persistent bytes: ``params`` (every parameter),
    ``adam`` (every Adam moment) and ``tables`` (the tables and their
    moments)."""
    tables = {id(getattr(model.embeddings, name)) for name in TABLES}
    out = {"params": 0, "adam": 0, "tables": 0}
    for p in model.parameters():
        n = p.numel() * p.element_size()
        out["params"] += n
        moments = sum(t.numel() * t.element_size()
                      for key, t in optimizer.state.get(p, {}).items()
                      if key in _MOMENTS)
        out["adam"] += moments
        if id(p) in tables:
            out["tables"] += n + moments
    return out
