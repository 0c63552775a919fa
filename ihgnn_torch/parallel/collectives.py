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

* ``combine_nodes`` — the sum over ranks of ``[N, d]`` node partials,
  replicated: f32 partials by a reduce-scatter into node blocks of
  ``node_pad(N, S) / S`` rows and an all-gather of the blocks (the next
  gather reads every node); on bf16 edge streams with ``mesh.bf16_wire``,
  the partial rounded to bf16 and summed by one bf16 all-reduce, widened
  to f32 (``_bf16_rs_on``, ``hyperagg.py:702``).
* ``combine_rows`` — the tail psum: the sum over ranks of a partial's
  rows ``nodes`` only (``_sh_scatter_at_*``, ``hyperagg.py:876-936``); its
  backward all-reduces the ``[K, d]`` cotangent and scatters it back into
  a sparse ``[N, d]`` one by an index-add (batch nodes repeat).
* ``gather_slices`` — the all-gather of each rank's ``[rows, d]`` slice
  (the word bag's query slices); its backward reduce-scatters the
  cotangent into the rank's slice.

Two plain functions (no autograd) serve an attention softmax whose
destination's entries span ranks (``ops/gatconv.py``): ``all_reduce_max``
and ``all_reduce_sum`` of an ``[N]`` f32 stream, the segment maxima and
the denominators (and the backward's ``tsum``) over every rank's entries.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from ihgnn_torch.parallel.mesh import Mesh

# the collectives under their current names (torch 2.13 renames the two
# "_tensor" forms "_single")
_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor

# while timing is on (set_timing), ``(kind, ms)`` of each collective call:
# the host time from the card idle before it to the card idle after it;
# kind "scalar" for the softmax's [N] streams, else "rows"
TIMES: list = []
_TIMING = [False]


def set_timing(on: bool) -> None:
    """Start (clearing ``TIMES``) or stop timing the collectives. Timing
    waits for the card before and after each call."""
    if on:
        TIMES.clear()
    _TIMING[0] = on


def _call(fn, tensor: torch.Tensor, *args, kind: str = "rows",
          **kwargs) -> None:
    if not _TIMING[0]:
        fn(tensor, *args, **kwargs)
        return
    cuda = tensor.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(tensor.device)
    t0 = time.perf_counter()
    fn(tensor, *args, **kwargs)
    if cuda:
        torch.cuda.synchronize(tensor.device)
    TIMES.append((kind, (time.perf_counter() - t0) * 1e3))


def node_pad(n: int, ranks: int) -> int:
    """The node axis of a reduce-scatter: ``n`` rounded up to a multiple
    of ``ranks`` (``_node_pad``, ``hyperagg.py:694``, pads to 128-lane
    blocks for the TPU's tiles; rows need no such alignment here)."""
    return -(-max(n, 1) // ranks) * ranks


def _sum_over_ranks(x: torch.Tensor, mesh: Mesh,
                    bf16: bool) -> torch.Tensor:
    """Σ over ranks of ``x`` ``[N, d]``, replicated, in ``x``'s dtype; with
    ``bf16`` rounded to bf16 for the wire and widened back."""
    if bf16:
        wire = x.to(torch.bfloat16)
        _call(dist.all_reduce, wire, group=mesh.group)
        return wire.to(x.dtype)
    n, d = x.shape
    n_pad = node_pad(n, mesh.data)
    full = x.new_zeros(n_pad, d)
    full[:n] = x
    block = x.new_empty(n_pad // mesh.data, d)
    _call(_REDUCE_SCATTER, block, full, group=mesh.group)
    _call(_ALL_GATHER, full, block, group=mesh.group)
    return full[:n]


class CombineNodesFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, partial, mesh, bf16):
        ctx.mesh, ctx.bf16 = mesh, bf16
        return _sum_over_ranks(partial.contiguous(), mesh, bf16)

    @staticmethod
    def backward(ctx, cot):
        return _sum_over_ranks(cot.contiguous(), ctx.mesh, ctx.bf16), None, \
            None


def combine_nodes(partial: torch.Tensor, mesh: Mesh,
                  bf16: bool = False) -> torch.Tensor:
    """The ``[N, d]`` node sums of every rank's ``partial``, on every rank
    (``bf16``: over the bf16 wire)."""
    return CombineNodesFn.apply(partial, mesh, bf16)


class CombineRowsFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, partial, nodes, mesh):
        ctx.mesh, ctx.n = mesh, partial.shape[0]
        ctx.save_for_backward(nodes)
        rows = partial.index_select(0, nodes)
        _call(dist.all_reduce, rows, group=mesh.group)
        return rows

    @staticmethod
    def backward(ctx, cot):
        (nodes,) = ctx.saved_tensors
        cot = cot.contiguous().clone()
        _call(dist.all_reduce, cot, group=ctx.mesh.group)
        full = cot.new_zeros(ctx.n, cot.shape[1])
        full.index_add_(0, nodes, cot)
        return full, None, None


def combine_rows(partial: torch.Tensor, nodes: torch.Tensor,
                 mesh: Mesh) -> torch.Tensor:
    """``[K, d]``: the sum over ranks of ``partial[nodes]`` (``nodes``
    the same on every rank)."""
    return CombineRowsFn.apply(partial, nodes.long(), mesh)


class GatherSlicesFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, mesh):
        ctx.mesh = mesh
        local = local.contiguous()
        out = local.new_empty(mesh.data * local.shape[0], *local.shape[1:])
        _call(_ALL_GATHER, out, local, group=mesh.group)
        return out

    @staticmethod
    def backward(ctx, cot):
        mesh = ctx.mesh
        cot = cot.contiguous()
        local = cot.new_empty(cot.shape[0] // mesh.data, *cot.shape[1:])
        _call(_REDUCE_SCATTER, local, cot, group=mesh.group)
        return local, None


def gather_slices(local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``local`` ``[rows, d]`` stacked in rank order."""
    return GatherSlicesFn.apply(local, mesh)


def all_reduce_sum(x: torch.Tensor, mesh: Mesh,
                   kind: str = "rows") -> torch.Tensor:
    """A copy of ``x`` summed over the ranks (no gradient); ``kind`` the
    label of its time (``TIMES``)."""
    x = x.detach().clone()
    _call(dist.all_reduce, x, group=mesh.group, kind=kind)
    return x


def all_reduce_max(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A copy of the ``[N]`` stream ``x``, its elementwise max over the
    ranks (no gradient)."""
    x = x.detach().clone()
    _call(dist.all_reduce, x, op=dist.ReduceOp.MAX, group=mesh.group,
          kind="scalar")
    return x


def reduce_gradients(params, mesh: Mesh) -> None:
    """Sum every parameter's ``.grad`` over the ranks, in one all-reduce
    of the gradients laid end to end (f32). A parameter without a
    gradient sends zeros and gets the sum, so every rank sends the same
    layout and ends with the same gradients."""
    params = [p for p in params if p.requires_grad]
    if not params:
        return
    flat = torch.cat([(p.grad if p.grad is not None
                       else torch.zeros_like(p)).reshape(-1).float()
                      for p in params])
    _call(dist.all_reduce, flat, group=mesh.group)
    offset = 0
    for p in params:
        n = p.numel()
        p.grad = flat[offset:offset + n].view_as(p).to(p.dtype)
        offset += n
