"""K1's long segments on the CPU: the list a CSR carries of its segments of
more than ``LONG_ENTRIES`` entries (``ops/segsum.py`` ``long_segments``),
built with the hypergraph and the log hypergraph and moved with them; and
the plain path, which ignores the list, as are the model's forward and
backward on the CPU. The block that sums a long segment on the card is held
in ``tests/test_torch_cuda.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ihgnn_torch.config import ModelConfig, V
from ihgnn_torch.graph import (build_hypergraph, hypergraph_from_i3,
                               log_hypergraph_from_edges)
from ihgnn_torch.models.embedding import make_word_bag
from ihgnn_torch.models.rawgnn import RawGnn
from ihgnn_torch.ops.segsum import (LONG_ENTRIES, LongSegments,
                                    csr_gather_sum, long_segments)

USERS, QUERIES, ITEMS, VOCAB = 40, 12, 60, 20


def _hub_uqi(edges, seed):
    """(u, q, i) rows in which query 0 and item 3 are hubs of more than
    LONG_ENTRIES edges each, query 0 the larger."""
    rng = np.random.default_rng(seed)
    q = np.where(rng.random(edges) < 0.5, 0, rng.integers(1, QUERIES, edges))
    i = np.where(rng.random(edges) < 0.4, 3, rng.integers(0, ITEMS, edges))
    return np.stack([rng.integers(0, USERS, edges), q, i], axis=1)


def _same(a, b):
    return torch.equal(a.ids, b.ids) and a.entries == b.entries


def _hub_graph(edges=3000, seed=0):
    return build_hypergraph(_hub_uqi(edges, seed), USERS + QUERIES + ITEMS,
                            USERS, QUERIES)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_long_segments_are_the_longest_first(seed):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 40, 500)
    picks = rng.choice(500, 12, replace=False)
    lengths[picks] = rng.integers(LONG_ENTRIES - 2, LONG_ENTRIES + 4, 12)
    lengths[picks[:3]] = LONG_ENTRIES + 50      # ties keep id order
    rowptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    hubs = long_segments(rowptr)
    want = sorted(np.flatnonzero(lengths > LONG_ENTRIES),
                  key=lambda s: (-lengths[s], s))
    assert hubs.ids.dtype == torch.int32
    assert hubs.ids.tolist() == want
    assert hubs.entries == int(lengths[want].sum())
    assert _same(long_segments(torch.from_numpy(rowptr)), hubs)


def test_a_uniform_graph_has_no_long_segments():
    rng = np.random.default_rng(4)
    uqi = np.stack([rng.integers(0, USERS, 3000),
                    rng.integers(0, QUERIES + 20, 3000),
                    rng.integers(0, ITEMS, 3000)], axis=1)
    graph = build_hypergraph(uqi, USERS + QUERIES + 20 + ITEMS, USERS,
                             QUERIES + 20)
    assert graph.long_segments.ids.shape == (0,)
    assert graph.long_segments.entries == 0
    log = log_hypergraph_from_edges(uqi.reshape(-1), np.full(3000, 3),
                                    USERS + QUERIES + 20 + ITEMS)
    assert log.long_segments.ids.shape == (0,)


def test_graphs_carry_their_long_segments():
    """The hypergraph's list is that of its node CSR ``rowptr``, moved by
    ``to`` with the rest; a rank's slice (``hypergraph_from_i3`` on its
    edges) and the log hypergraph build their own."""
    graph = _hub_graph()
    lengths = np.diff(graph.rowptr.numpy())
    q0, i3 = USERS, USERS + QUERIES + 3
    assert np.sort(lengths)[-3] <= LONG_ENTRIES
    assert graph.long_segments.ids.tolist() == [q0, i3]
    assert graph.long_segments.entries == lengths[q0] + lengths[i3]
    moved = graph.to("cpu")
    assert isinstance(moved.long_segments, LongSegments)
    assert torch.equal(moved.long_segments.ids, graph.long_segments.ids)
    half = hypergraph_from_i3(graph.i3.numpy()[:1500], graph.node_count,
                              dv=graph.dv)
    assert _same(half.long_segments, long_segments(half.rowptr))
    log = log_hypergraph_from_edges(graph.i3.numpy().reshape(-1),
                                    np.full(graph.edge_count, 3),
                                    graph.node_count)
    assert _same(log.long_segments, graph.long_segments)


@pytest.mark.parametrize("weighted", [False, True])
def test_plain_path_ignores_the_list(weighted):
    graph = _hub_graph()
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((graph.edge_count, 8))
                         .astype(np.float32))
    w = (torch.from_numpy(rng.random(graph.inc_edge.numel())
                          .astype(np.float32)) if weighted else None)
    got = csr_gather_sum(x, graph.inc_edge, graph.rowptr, w,
                         long_segments=graph.long_segments)
    assert torch.equal(got, csr_gather_sum(x, graph.inc_edge, graph.rowptr,
                                           w))


@pytest.mark.parametrize("gnn", [V.IHGNN, V.HGCN])
def test_model_step_on_the_cpu_is_unchanged_by_the_list(gnn):
    """Features, loss and every gradient of a step on a graph with hubs,
    with the graph's long segments and without them, bit for bit."""
    graph = _hub_graph()
    rng = np.random.default_rng(6)
    words = rng.integers(1, VOCAB + 1, (QUERIES, 3)).astype(np.int32)
    bag = make_word_bag(words, np.full(QUERIES, 3, np.int32), VOCAB + 1)
    rows = [torch.from_numpy(rng.integers(0, n, 32).astype(np.int32))
            for n in (USERS, QUERIES, ITEMS)]
    runs = []
    for g in (graph, dataclasses.replace(graph, long_segments=None)):
        model = RawGnn(ModelConfig(gnn=gnn, embedding_size=8), USERS,
                       QUERIES, ITEMS, VOCAB,
                       generator=torch.Generator().manual_seed(0))
        features = model.all_features(g, bag)
        loss = model.score(features, *rows).square().mean()
        loss.backward()
        runs.append((features.detach(), loss.detach(),
                     [p.grad for p in model.parameters()]))
    (fa, la, ga), (fb, lb, gb) = runs
    assert torch.equal(fa, fb) and torch.equal(la, lb)
    assert len(ga) == len(gb) and all(torch.equal(a, b)
                                      for a, b in zip(ga, gb))
