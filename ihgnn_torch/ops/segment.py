"""Plain PyTorch segment primitives: the reference semantics of the kernels.

Counterpart of ``ihgnn_tpu/ops/segment.py`` (the XLA segment ops behind
the TPU kernels):

* ``segment_sum`` / ``segment_max`` / ``segment_softmax`` over segment ids
  (dgl ``edge_softmax`` semantics, Models/GnnLayers.py:112);
* ``spmm`` — sparse COO × dense, ``out[r] = Σ v · dense[c]``;
* ``hyperedge_gather`` / ``hyperedge_scatter`` — Hᵀ·X and H·E of the
  degree-3 hypergraph.

``segment_ids`` expands a CSR ``rowptr`` into the segment id of each
entry. The kernels' plain twins (``segsum``, ``segmax``, ``edgedot``)
are written with these functions, and run wherever the tensors lie; the
kernels themselves never call them.
"""

from __future__ import annotations

import torch


def segment_ids(rowptr: torch.Tensor) -> torch.Tensor:
    """``[K]`` int64 segment id of each entry of the CSR ``rowptr``."""
    s = rowptr.shape[0] - 1
    counts = (rowptr[1:] - rowptr[:-1]).long()
    return torch.repeat_interleave(
        torch.arange(s, device=rowptr.device), counts)


def _expand_ids(ids: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    return ids.long().view(-1, *([1] * (values.dim() - 1))).expand_as(values)


def segment_sum(values: torch.Tensor, ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``out[s] = Σ_{k: ids[k] = s} values[k]``; empty segments are 0."""
    out = values.new_zeros((num_segments, *values.shape[1:]))
    return out.index_add_(0, ids.long(), values)


def segment_max(values: torch.Tensor, ids: torch.Tensor, num_segments: int,
                empty: float = float("-inf")) -> torch.Tensor:
    """``out[s] = max(empty, max_{k: ids[k] = s} values[k])``: an empty
    segment holds ``empty`` (-inf, as ``jax.ops.segment_max`` gives)."""
    out = values.new_full((num_segments, *values.shape[1:]), empty)
    return out.scatter_reduce_(0, _expand_ids(ids, values), values, "amax",
                               include_self=True)


def segment_softmax(scores: torch.Tensor, ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Softmax of a flat score vector over the entries sharing a segment
    id, max-shifted per segment."""
    ids = ids.long()
    shifted = scores - segment_max(scores, ids, num_segments)[ids]
    ex = torch.exp(shifted)
    return ex / segment_sum(ex, ids, num_segments)[ids]


def spmm(row: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
         dense: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Sparse (COO) @ dense: ``out[r] = Σ_{(r, c, v)} v · dense[c]``
    (torch_sparse.matmul in Models/GnnLayers.py:37-41,148-151)."""
    return segment_sum(val[:, None] * dense[col.long()], row, num_rows)


def hyperedge_gather(node_feats: torch.Tensor, i3: torch.Tensor
                     ) -> torch.Tensor:
    """Hᵀ-side gather of degree-3 hyperedges: ``[E, 3, d]`` endpoint rows."""
    return node_feats[i3.long()]


def hyperedge_scatter(edge_feats: torch.Tensor, inc_edge: torch.Tensor,
                      inc_node: torch.Tensor, node_count: int
                      ) -> torch.Tensor:
    """H-side scatter: ``out[v] = Σ_{(v, e)} edge_feats[e]`` over the
    node-major incidence (Models/GnnLayers.py:233)."""
    return segment_sum(edge_feats[inc_edge.long()], inc_node, node_count)
