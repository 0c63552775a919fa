"""The collectives of the data-parallel path, each an autograd Function.

Counterpart of the ``shard_map`` bodies' collectives in
``ihgnn_tpu/ops/hyperagg.py:653-936``, ``ops/bag.py:220-333`` and
``ops/pallas/interact.py:475-565``. JAX's GSPMD places the collectives
and sums each gradient once inside the VJPs (``_sh_gather_bwd`` psums the
node gradient). The port makes every collective explicit and uses
sum-of-partials autograd instead: each rank differentiates its own share
of the loss (its batch rows over the global row weight), a collective
whose forward sums partials over the ranks has the same sum as its
backward, and a rank's parameter gradients are partials that
``reduce_gradients`` all-reduces once at the end of the step. Every
replicated value (node features, parameters) is then the same on every
rank, and equal to the one-device step's up to the order of adds.

"The ranks" are the data group (``Mesh.group``): the ranks of one model
index, which hold different slices. The ranks of one data index hold the
same slice and the same loss share, so no sum runs over them; the table
blocks they gather are ``parallel/tables.py``'s. A collective over a
group of one rank is the identity and does not run.

* ``combine_nodes`` — the sum over ranks of ``[N, d]`` node partials,
  replicated: f32 partials by a reduce-scatter into node blocks of
  ``node_pad(N, S) / S`` rows and an all-gather of the blocks (the next
  gather reads every node); on bf16 edge streams with ``mesh.bf16_wire``,
  the partial rounded to bf16 and summed by one bf16 all-reduce, widened
  to f32 (``_bf16_rs_on``, ``hyperagg.py:702``).
* ``combine_rows`` — the tail psum: the sum over ranks of a partial's
  rows ``nodes`` only (``_sh_scatter_at_*``, ``hyperagg.py:876-936``); its
  backward all-reduces the ``[K, d]`` cotangent and scatters it back into
  a sparse ``[N, d]`` one (batch nodes repeat) in a fixed order
  (``ops/rows.py``): the ranks of one data index must compute the same
  partials bit for bit, or their replicas part.
* ``gather_slices`` — the all-gather of each rank's ``[rows, d]`` slice
  (the word bag's query slices); its backward reduce-scatters the
  cotangent into the rank's slice.

Two plain functions (no autograd) serve an attention softmax whose
destination's entries span ranks (``ops/gatconv.py``): ``all_reduce_max``
and ``all_reduce_sum`` of an ``[N]`` f32 stream, the segment maxima and
the denominators (and the backward's ``tsum``) over every rank's entries.

Every call can be timed (``set_timing``: ``TIMES``) and recorded
(``set_recording``: ``RECORD``, read by ``utils/collective_stats.py``).
"""

from __future__ import annotations

import time
from typing import Optional

import torch
import torch.distributed as dist

from ihgnn_torch.ops.rows import accumulate_rows
from ihgnn_torch.parallel.mesh import DATA_AXIS, Mesh

# the collectives under their current names (torch 2.13 renames the two
# "_tensor" forms "_single")
_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor

# while timing is on (set_timing), ``(kind, ms)`` of each collective call:
# the host time from the card idle before it to the card idle after it;
# kind "scalar" for the softmax's [N] streams, "table" for the table
# blocks' gathers and their gradients' sum, else "rows"
TIMES: list = []
_TIMING = [False]
# while recording is on (set_recording), one dict a collective call:
# kind (all-reduce, all-gather, reduce-scatter), the result's bytes and
# shape ("f32[700000,32]", ``ihgnn_tpu/utils/hlo_stats.py``'s convention),
# the group's axis (data, model) and the call site ("grad:" in a
# backward); read by ``utils/collective_stats.py``
RECORD: list = []
_RECORDING = [False]

_OPS = {"all-reduce": lambda out, inp, **kw: dist.all_reduce(out, **kw),
        "all-gather": lambda out, inp, **kw: _ALL_GATHER(out, inp, **kw),
        "reduce-scatter": lambda out, inp, **kw: _REDUCE_SCATTER(out, inp,
                                                                 **kw)}
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16",
           torch.float64: "f64", torch.int32: "s32", torch.int64: "s64"}


def set_timing(on: bool) -> None:
    """Start (clearing ``TIMES``) or stop timing the collectives. Timing
    waits for the card before and after each call."""
    if on:
        TIMES.clear()
    _TIMING[0] = on


def set_recording(on: bool) -> None:
    """Start (clearing ``RECORD``) or stop recording the collectives.
    Recording reads shapes only: it never waits for the card."""
    if on:
        RECORD.clear()
    _RECORDING[0] = on


def _shape_text(t: torch.Tensor) -> str:
    return (f"{_DTYPES.get(t.dtype, str(t.dtype))}"
            f"[{','.join(str(n) for n in t.shape)}]")


def _call(kind: str, out: torch.Tensor, inp: Optional[torch.Tensor],
          mesh: Mesh, axis: str, site: str, op=None,
          timing: str = "rows") -> None:
    """Collective ``kind`` over ``mesh``'s ``axis`` into ``out`` (from
    ``inp`` for a gather or a scatter). Over one rank it is the identity
    (a copy), and neither runs nor is recorded."""
    group, size = mesh.axis(axis)
    if size == 1:
        if inp is not None:
            out.copy_(inp)
        return
    if _RECORDING[0]:
        RECORD.append({"kind": kind, "bytes": out.numel() * out.element_size(),
                       "shape": _shape_text(out), "group": axis,
                       "attribution": site})
    kwargs = {"group": group} if op is None else {"group": group, "op": op}
    if not _TIMING[0]:
        _OPS[kind](out, inp, **kwargs)
        return
    cuda = out.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(out.device)
    t0 = time.perf_counter()
    _OPS[kind](out, inp, **kwargs)
    if cuda:
        torch.cuda.synchronize(out.device)
    TIMES.append((timing, (time.perf_counter() - t0) * 1e3))


def node_pad(n: int, ranks: int) -> int:
    """The node axis of a reduce-scatter: ``n`` rounded up to a multiple
    of ``ranks`` (``_node_pad``, ``hyperagg.py:694``, pads to 128-lane
    blocks for the TPU's tiles; rows need no such alignment here)."""
    return -(-max(n, 1) // ranks) * ranks


def _sum_over_ranks(x: torch.Tensor, mesh: Mesh, bf16: bool,
                    site: str) -> torch.Tensor:
    """Σ over the data group of ``x`` ``[N, d]``, replicated, in ``x``'s
    dtype; with ``bf16`` rounded to bf16 for the wire and widened back."""
    if bf16:
        wire = x.to(torch.bfloat16)
        _call("all-reduce", wire, None, mesh, DATA_AXIS, site)
        return wire.to(x.dtype)
    n, d = x.shape
    n_pad = node_pad(n, mesh.data)
    full = x.new_zeros(n_pad, d)
    full[:n] = x
    block = x.new_empty(n_pad // mesh.data, d)
    _call("reduce-scatter", block, full, mesh, DATA_AXIS, site)
    _call("all-gather", full, block, mesh, DATA_AXIS, site)
    return full[:n]


class CombineNodesFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, partial, mesh, bf16):
        ctx.mesh, ctx.bf16 = mesh, bf16
        return _sum_over_ranks(partial.contiguous(), mesh, bf16,
                               "combine_nodes")

    @staticmethod
    def backward(ctx, cot):
        return _sum_over_ranks(cot.contiguous(), ctx.mesh, ctx.bf16,
                               "grad:combine_nodes"), None, None


def combine_nodes(partial: torch.Tensor, mesh: Mesh,
                  bf16: bool = False) -> torch.Tensor:
    """The ``[N, d]`` node sums of every rank's ``partial`` over the data
    group, on every rank (``bf16``: over the bf16 wire)."""
    if mesh.data == 1:
        return partial
    return CombineNodesFn.apply(partial, mesh, bf16)


class CombineRowsFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, partial, nodes, mesh):
        ctx.mesh, ctx.n = mesh, partial.shape[0]
        ctx.save_for_backward(nodes)
        rows = partial.index_select(0, nodes)
        _call("all-reduce", rows, None, mesh, DATA_AXIS, "combine_rows")
        return rows

    @staticmethod
    def backward(ctx, cot):
        (nodes,) = ctx.saved_tensors
        cot = cot.contiguous().clone()
        _call("all-reduce", cot, None, ctx.mesh, DATA_AXIS,
              "grad:combine_rows")
        return accumulate_rows(ctx.n, nodes, cot), None, None


def combine_rows(partial: torch.Tensor, nodes: torch.Tensor,
                 mesh: Mesh) -> torch.Tensor:
    """``[K, d]``: the sum over the data group of ``partial[nodes]``
    (``nodes`` the same on every rank)."""
    return CombineRowsFn.apply(partial, nodes.long(), mesh)


class GatherSlicesFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, mesh):
        ctx.mesh = mesh
        local = local.contiguous()
        out = local.new_empty(mesh.data * local.shape[0], *local.shape[1:])
        _call("all-gather", out, local, mesh, DATA_AXIS, "gather_slices")
        return out

    @staticmethod
    def backward(ctx, cot):
        mesh = ctx.mesh
        cot = cot.contiguous()
        local = cot.new_empty(cot.shape[0] // mesh.data, *cot.shape[1:])
        _call("reduce-scatter", local, cot, mesh, DATA_AXIS,
              "grad:gather_slices")
        return local, None


def gather_slices(local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every data index's ``local`` ``[rows, d]`` stacked in data order."""
    if mesh.data == 1:
        return local
    return GatherSlicesFn.apply(local, mesh)


def all_reduce_sum(x: torch.Tensor, mesh: Mesh, kind: str = "rows",
                   site: str = "all_reduce_sum") -> torch.Tensor:
    """A copy of ``x`` summed over the data group (no gradient); ``kind``
    the label of its time (``TIMES``), ``site`` of its record
    (``RECORD``)."""
    x = x.detach().clone()
    _call("all-reduce", x, None, mesh, DATA_AXIS, site, timing=kind)
    return x


def all_reduce_max(x: torch.Tensor, mesh: Mesh,
                   site: str = "softmax_max") -> torch.Tensor:
    """A copy of the ``[N]`` stream ``x``, its elementwise max over the
    data group (no gradient)."""
    x = x.detach().clone()
    _call("all-reduce", x, None, mesh, DATA_AXIS, site,
          op=dist.ReduceOp.MAX, timing="scalar")
    return x


def reduce_gradients(params, mesh: Mesh) -> None:
    """Sum every parameter's ``.grad`` over the data group, in one
    all-reduce of the gradients laid end to end (f32). A parameter without
    a gradient sends zeros and gets the sum, so every rank sends the same
    layout and ends with the same gradients. A table block's gradient is
    summed by its gather's backward (``parallel/tables.py``): leave it
    out of ``params``."""
    params = [p for p in params if p.requires_grad]
    if not params or mesh.data == 1:
        return
    flat = torch.cat([(p.grad if p.grad is not None
                       else torch.zeros_like(p)).reshape(-1).float()
                      for p in params])
    _call("all-reduce", flat, None, mesh, DATA_AXIS, "grad:reduce_gradients")
    offset = 0
    for p in params:
        n = p.numel()
        p.grad = flat[offset:offset + n].view_as(p).to(p.dtype)
        offset += n
