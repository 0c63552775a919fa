"""The interaction's weight gradient dW at 300, 3,000 and 17,000 edges
against float64 on the CPU.

On the H100 80GB HBM3 at 700 W, K3's ``interact_bwd`` and K5's
``interact_bwd_absorb`` once
summed a chunk's dW (1024 edges, 384 ``mma.sync`` a chunk) in the tensor
cores' accumulator, and their dW drifted from float64 with the edge
count: 2.8-4.0e-6 of its largest value at 300 edges, 1.04-1.19e-5 at
3,000 and 17,000, above the 1e-5 limit of ``chip_smoke.py``'s small
checks; summed a 32-edge tile at a time, at most 3.0e-7.
``chip_smoke.py``'s phase ``fault_3_1`` holds the card's dW against
float64 at these sizes. Here:

* the f32 twin (``interact_bwd_plain``, the CPU path the card is held
  against) does not drift: within 1e-6 of float64 at every size, direct
  and on the chunked pack (K5's absorbed form), on the inputs of a train
  step of the default model (``chip_smoke.py``'s ``_interaction_inputs``);
* a model of the kernel's arithmetic, 3xTF32 products whose every
  ``mma`` rounds the sum it accumulates toward zero: carried over a whole
  chunk (the old design) the bias grows with the chunk's edges and stays
  there, more than 10 times the error of a fresh accumulator a 32-edge
  tile added to the chunk's sum by a rounded f32 add (the kernel's
  design since), which stays within 1e-6.
"""

import sys
from pathlib import Path

import pytest
import torch

from ihgnn_torch.config import ModelConfig
from ihgnn_torch.graph import build_hypergraph
from ihgnn_torch.ops.hyperagg import strip_kernel_packing
from ihgnn_torch.ops.interact import (CHUNK_EDGES, interact_bwd_absorb_plain,
                                      interact_bwd_plain, interact_parts)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

EDGES = (300, 3_000, 17_000)
TWIN_RTOL = 1e-6
TILE = 32            # edges a staged tile of csrc/interact_bwd.cu


def _inputs(edges, chunked):
    s = chip_smoke.SMALL
    nodes = s["users"] + s["queries"] + s["items"]
    qw, qc = chip_smoke.random_words(s["queries"], s["vocab"], 91)
    _, uqi = chip_smoke.random_graph(s["users"], s["queries"], s["items"],
                                     edges, 93)
    graph = build_hypergraph(uqi, nodes, s["users"], s["queries"],
                             pack_kernels=True,
                             chunk_rows_cap=chip_smoke.SCALE_CHUNK_CAP)
    if not chunked:
        graph = strip_kernel_packing(graph)
    return chip_smoke._interaction_inputs(torch, ModelConfig(), graph, uqi,
                                          qw, qc, 94)


def _f64(args):
    return [a.detach().double() if torch.is_tensor(a)
            and a.is_floating_point() else a for a in args]


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("edges", EDGES)
def test_twin_dw_matches_float64(edges, chunked):
    calls = _inputs(edges, chunked)
    assert len(calls) == 2 and all(absorb == chunked
                                   for absorb, _, _ in calls)
    for absorb, args, dw in calls:
        plain = interact_bwd_absorb_plain if absorb else interact_bwd_plain
        want = plain(*_f64(args))[1]
        err = (dw.double() - want).abs().max() / want.abs().max()
        assert err <= TWIN_RTOL, (edges, absorb, args[-1], err.item())


def _tf32_split(x):
    """``split_tf32`` (csrc/tf32.cuh): hi to 11 significant bits, lo the
    rest as the tensor cores read it (low 13 bits ignored)."""
    c = x * 8193.0
    hi = c - (c - x)
    lo = ((x - hi).contiguous().view(torch.int32) & ~0x1FFF).view(
        torch.float32)
    return hi, lo


def _mma_toward_zero(acc, a, b):
    """``acc + a @ b`` for an [8]-deep product of TF32 operands, formed
    in float64 and rounded toward zero to f32 (the model of an mma)."""
    exact = acc.double() + a.double() @ b.double()
    f = exact.float()
    return torch.where(f.double().abs() > exact.abs(),
                       torch.nextafter(f, torch.zeros_like(f)), f)


def _modelled_dw(parts, cot, fresh_tile_sums):
    """dW as the kernel's arithmetic would give it under the model: each
    chunk's 3xTF32 products accumulated by mma 8 edges at a time, either
    in one accumulator for the chunk or in a fresh one a tile whose sum
    joins the chunk's by an f32 add; the chunks' partials summed in
    order."""
    stacked = torch.cat(parts, 1)
    e = stacked.shape[0]
    total = torch.zeros(stacked.shape[1], cot.shape[1])
    for c0 in range(0, e, CHUNK_EDGES):
        c1 = min(c0 + CHUNK_EDGES, e)
        acc = torch.zeros_like(total)
        for t0 in range(c0, c1, TILE):
            tile = torch.zeros_like(total) if fresh_tile_sums else acc
            for k0 in range(t0, min(t0 + TILE, c1), 8):
                ah, al = _tf32_split(stacked[k0:k0 + 8].t().contiguous())
                bh, bl = _tf32_split(cot[k0:k0 + 8])
                for x, y in ((ah, bl), (al, bh), (ah, bh)):
                    tile = _mma_toward_zero(tile, x, y)
            acc = acc + tile if fresh_tile_sums else tile
        total = total + acc
    return total


@pytest.mark.parametrize("edges", EDGES[1:])
def test_tile_sums_remove_the_accumulator_bias(edges):
    for _, args, _ in _inputs(edges, False):
        u, q, i, w, cot, order = [a.detach() if torch.is_tensor(a) else a
                                  for a in args]
        want = interact_bwd_plain(*_f64(args))[1]
        scale = want.abs().max()
        parts = interact_parts(u, q, i, order)
        chunk = (_modelled_dw(parts, cot, False).double() - want).abs().max()
        tile = (_modelled_dw(parts, cot, True).double() - want).abs().max()
        assert tile / scale <= TWIN_RTOL, (order, (tile / scale).item())
        assert chunk > 10 * tile, (order, chunk.item(), tile.item())
