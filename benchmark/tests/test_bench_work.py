"""The work counts against counts made by hand at a tiny shape."""

import pytest

from benchmark.work import common, ihgnn

# 2 users, 1 query, 3 items (N = 6), 4 edges, 2 words a query over a
# vocabulary of 2, width 2, two layers of order 3 then 1
S = {"users": 2, "queries": 1, "items": 3, "vocab": 2, "words_per_query": 2,
     "interactions": 4, "d": 2, "layers": 2, "order": 3, "gnn": "ihgnn",
     "rows": 5, "batch_logs": 4, "truth_max": 2, "entries": 10}


def test_op_bound_takes_the_slower_of_bytes_and_operations():
    assert common.Op("x", read=3.35e12, write=0).bound_s == pytest.approx(1)
    assert common.Op("x", 0, 0, products=165e12).bound_s == pytest.approx(1)
    assert common.Op("x", 0, 0, other=67e12).bound_s == pytest.approx(1)
    assert common.Op("x", 3.35e12, 0, other=134e12).bound_s == \
        pytest.approx(2)


def test_ihgnn_interaction_by_hand():
    # reads X' (6 × 2), the edges' ids (4 × 3), W (7·2 × 2) and b (2);
    # writes 4 × 2; 2 · E · 7d · d products; u⊙q, q⊙i, i⊙u, u⊙q⊙i and the
    # bias add, 5 · E · d
    op = ihgnn.layer_forward(S, 0)[1]
    assert op.read == (12 + 12 + 28 + 2) * 4
    assert op.write == 8 * 4
    assert op.products == 2 * 4 * 7 * 2 * 2
    assert op.other == 5 * 4 * 2
    # the second layer runs at order 1: [u, q, i] only
    op1 = ihgnn.layer_forward(S, 1)[1]
    assert op1.name == "interaction_o1"
    assert op1.products == 2 * 4 * 3 * 2 * 2


def test_params_and_adam_by_hand():
    # tables (2 + 1) + (3 + 1) + (2 + 1) rows of 2; 3 item biases;
    # layer 0: W 2×2, b 2, interaction 14×2 + 2; layer 1: 4 + 2 + 6×2 + 2
    assert common.params(S) == 20 + 3 + 36 + 20
    (adam,) = common.adam(common.params(S))
    assert adam.read + adam.write == 7 * 79 * 4
    gat = dict(S, gnn="gat")
    assert common.params(gat) == 20 + 3 + 2 * (4 + 2 + 4 + 1)


@pytest.mark.parametrize("gnn,per_layer", [("ihgnn", (3, 3)),
                                            ("gat", (4, 5))])
def test_step_is_forward_head_backward_adam(gnn, per_layer):
    s = dict(S, gnn=gnn)
    ops = common.train_step(s)
    fwd, bwd = per_layer
    assert len(ops) == 1 + 2 * fwd + 2 + 2 * bwd + 2 + 1
    assert ops[0].name == "bag" and ops[-1].name == "adam"
    assert common.total_flops(ops) == sum(o.products + o.other for o in ops)


def test_rank_batch_by_hand():
    # 4 logs × width 6 ([X0 | X1 | X2]) against 3 items
    score = common.rank_batch(S)[1]
    assert score.products == 2 * 4 * 6 * 3
    assert score.read == (3 * 6 + 3 + 4 * 6) * 4
