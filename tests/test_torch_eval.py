"""The port's serving evaluation against the JAX package: ranking metrics,
``make_eval_fns``/``evaluate`` end to end with weights carried over by
``params_from_jax``, and the rule that the port imports nothing of JAX.

Tolerances: metric rows 1e-5 (the same f32 formulas); the averaged
``Metrics`` of a whole evaluation 1e-5, since both sides rank the same
scores to within 1e-5 and the random weights leave no near-ties in the
top 10.
"""

import ast
import math
import pkgutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ihgnn_torch
from ihgnn_torch import config as tcfg
from ihgnn_torch.convert import params_from_jax
from ihgnn_torch.data.collections import SearchLogCollection
from ihgnn_torch.data.dataset import EvalLogs as TEvalLogs
from ihgnn_torch.data.dataset import pad_ragged as t_pad_ragged
from ihgnn_torch.data.schema import SearchLog as TSearchLog
from ihgnn_torch.graph import build_hypergraph
from ihgnn_torch.models.rawgnn import RawGnn as TRawGnn
from ihgnn_torch.train import eval as teval
from ihgnn_torch.train.metrics import Metrics as TMetrics
from ihgnn_torch.train.metrics import ranking_metrics as t_ranking_metrics
from ihgnn_tpu.config import ModelConfig
from ihgnn_tpu.data.dataset import EvalLogs, pad_ragged
from ihgnn_tpu.data.synthetic import make_synthetic_data, make_synthetic_logs
from ihgnn_tpu.models.rawgnn import RawGnn
from ihgnn_tpu.ops.hyperagg import strip_kernel_packing
from ihgnn_tpu.train import eval as jeval
from ihgnn_tpu.train.metrics import Metrics, ranking_metrics

TOL = dict(rtol=1e-5, atol=1e-5)

# the reference's worked example (tests/test_metrics.py): ground truth
# [0, 7, 9] ranks [1, 3, 5]
SCORES = [0.15, 0.05, 0.25, 0.05, 0.05, 0.13, 0.08, 0.12, 0.05, 0.07]
TRUTH = [0, 7, 9]
EXP = [1.0,
       (1 / math.log2(3) + 1 / math.log2(5) + 1 / math.log2(7))
       / (1 / math.log2(2) + 1 / math.log2(3) + 1 / math.log2(4)),
       (1 / 2 + 2 / 4 + 3 / 6) / 3,
       1 / 2]


def _row(m):
    """(HR, NDCG, MAP, MRR) of a ``Metrics`` of either package."""
    return [m.HitRatio_at10, m.NDCG_at10, m.MAP_at10, m.MRR_at10]


def _t_rows(scores, truth, counts):
    return t_ranking_metrics(torch.from_numpy(scores), torch.from_numpy(truth),
                             torch.from_numpy(counts)).numpy()


def _j_rows(scores, truth, counts):
    return np.asarray(ranking_metrics(jnp.asarray(scores), jnp.asarray(truth),
                                      jnp.asarray(counts)))


# ---------------------------------------------------------------------------
# ranking metrics
# ---------------------------------------------------------------------------


def test_ranking_metrics_worked_example():
    scores = np.array([SCORES], np.float32)
    truth = np.full((1, 5), -1, np.int32)
    truth[0, :3] = TRUTH
    rows = _t_rows(scores, truth, np.array([3], np.int32))
    np.testing.assert_allclose(rows[0], EXP, **TOL)
    m = TMetrics.calculate_on_all_items(np.array(SCORES), TRUTH, None, True)
    np.testing.assert_allclose(m.as_row(), EXP, **TOL)


@pytest.mark.parametrize("items,batch,width,seed", [
    (50, 32, 8, 0), (40, 16, 14, 1), (400, 8, 3, 2)])
def test_ranking_metrics_match_jax(items, batch, width, seed):
    """Random scores, ragged truth (some rows with more than 10 truths,
    padding rows with none): rows equal the JAX rows and the host golden."""
    rng = np.random.default_rng(seed)
    scores = rng.standard_normal((batch, items)).astype(np.float32)
    truth = np.full((batch, width), -1, np.int32)
    counts = rng.integers(0, width + 1, batch).astype(np.int32)
    for b in range(batch):
        truth[b, :counts[b]] = rng.choice(items, counts[b], replace=False)
    # plant hits so every metric is exercised
    for b in range(0, batch, 2):
        if counts[b]:
            top = np.argsort(-scores[b])[:3]
            truth[b, :min(3, counts[b])] = top[:min(3, counts[b])]
    got = _t_rows(scores, truth, counts)
    np.testing.assert_allclose(got, _j_rows(scores, truth, counts), **TOL)
    assert got[:, 0].max() > 0
    for b in range(batch):
        if counts[b] == 0:
            assert (got[b] == 0).all()
            continue
        m = TMetrics.calculate_on_all_items(
            scores[b], list(truth[b, :counts[b]]), None, True)
        np.testing.assert_allclose(got[b], m.as_row(), rtol=1e-4, atol=1e-4)


def test_hr_denominator_is_min_truth_10():
    scores = np.zeros((1, 30), np.float32)
    scores[0, :10] = np.arange(10, 0, -1)
    truth = np.arange(15, dtype=np.int32)[None]
    rows = _t_rows(scores, truth, np.array([15], np.int32))
    assert rows[0, 0] == pytest.approx(1.0)


def test_host_metrics_golden_branches_match_jax():
    """The host golden (graded relevance, no hits) equals the JAX one."""
    cases = [
        (np.array([0.9, 0.8, 0.1, 0.05], np.float32), [0, 2], [2, 3], False),
        (np.arange(20, 0, -1, dtype=np.float32), [15], None, True),
        (np.array(SCORES, np.float32), TRUTH, None, True),
    ]
    for scores, truth, flags, all1 in cases:
        got = TMetrics.calculate_on_all_items(scores, truth, flags, all1)
        want = Metrics.calculate_on_all_items(scores, truth, flags, all1)
        np.testing.assert_allclose(_row(got), _row(want), **TOL)
    m = TMetrics.from_row([1, 2, 3, 4])
    m.add_to_self(TMetrics.from_row([1, 1, 1, 1]))
    assert m.divide_and_get_new(2).as_row() == [1.0, 1.5, 2.0, 2.5]


# ---------------------------------------------------------------------------
# eval logs
# ---------------------------------------------------------------------------


def _port_logs(jax_logs):
    """The JAX package's SearchLogCollection carried over by its CSV form."""
    return SearchLogCollection(TSearchLog.parse(log.tostr())
                               for log in jax_logs)


def test_eval_logs_match_jax(tmp_path):
    logs, _, _ = make_synthetic_logs(user_count=10, query_count=6,
                                     item_count=15, vocab_size=9,
                                     log_count=60, seed=4)
    ours = _port_logs(logs)
    path = tmp_path / "logs.csv"
    ours.write(str(path))
    want = EvalLogs(logs)
    for got in (TEvalLogs(ours), TEvalLogs.from_file(str(path))):
        assert got.count == want.count and got.line_count == want.line_count
        for a, b in zip(got.batches(16), want.batches(16)):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    rows = [[1, 2], [], [3, 4, 5]]
    for a, b in zip(t_pad_ragged(rows, -1), pad_ragged(rows, -1)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# make_eval_fns / evaluate, end to end
# ---------------------------------------------------------------------------


COUNTS = dict(user_count=20, query_count=12, item_count=30, vocab_size=25)


@pytest.fixture(scope="module")
def splits():
    """(train GraphData, [valid, test] search-log collections)."""
    train = make_synthetic_data(log_count=300, seed=0, **COUNTS)
    held_out = [make_synthetic_logs(log_count=n, seed=s, **COUNTS)[0]
                for n, s in ((30, 1), (60, 2))]
    return train, held_out


@pytest.mark.parametrize("batch", [7, 64])
def test_evaluate_matches_jax(splits, batch):
    train, held_out = splits
    kw = dict(embedding_size=16, gnn_layer_count=2)
    graph = strip_kernel_packing(train.hypergraph)
    model = RawGnn(ModelConfig(**kw), train.user_count, train.query_count,
                   train.item_count, train.vocab_size)
    z = jnp.zeros((1,), jnp.int32)
    params = model.init(jax.random.key(11), graph,
                        jnp.asarray(train.query_words),
                        jnp.asarray(train.query_word_counts), z, z, z)
    j_feat, j_met = jeval.make_eval_fns(model, graph, train.query_words,
                                        train.query_word_counts)

    ours = TRawGnn(tcfg.ModelConfig(**kw), train.user_count,
                   train.query_count, train.item_count, train.vocab_size)
    ours.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)), strict=True)
    tgraph = build_hypergraph(train.pos_uqif, train.node_count,
                              train.user_count, train.query_count)
    t_feat, t_met = teval.make_eval_fns(ours, tgraph, train.query_words,
                                        train.query_word_counts,
                                        device="cpu")
    feats = t_feat()
    assert not feats.requires_grad
    np.testing.assert_allclose(feats.numpy(), np.asarray(j_feat(params)).T,
                               **TOL)
    for logs in held_out:
        want, want_rows, _ = jeval.evaluate(params, j_feat, j_met,
                                            EvalLogs(logs), batch,
                                            collect_rows=True)
        tlogs = TEvalLogs(_port_logs(logs))
        got, got_rows, secs = teval.evaluate(t_feat, t_met, tlogs, batch,
                                             collect_rows=True)
        assert secs >= 0 and got_rows.shape == want_rows.shape
        np.testing.assert_allclose(got_rows, want_rows, **TOL)
        np.testing.assert_allclose(_row(got), _row(want), **TOL)
        assert got.HitRatio_at10 > 0
        shared, _, _ = teval.evaluate(t_feat, t_met, tlogs, batch,
                                      features=feats)
        assert shared.as_row() == got.as_row()


def test_make_eval_fns_checks_devices(splits):
    train, _ = splits
    model = TRawGnn(tcfg.ModelConfig(embedding_size=8), train.user_count,
                    train.query_count, train.item_count, train.vocab_size)
    g = build_hypergraph(train.pos_uqif, train.node_count, train.user_count,
                         train.query_count)
    if not torch.cuda.is_available():
        # the default device is the card: without one it raises, and
        # never drops to the CPU on its own
        with pytest.raises(RuntimeError, match="cuda"):
            teval.make_eval_fns(model, g, train.query_words,
                                train.query_word_counts)
    with pytest.raises(ValueError):
        teval.make_eval_fns(model, g, train.query_words,
                            train.query_word_counts, device="meta")
    # inputs that do not fit the model are refused before any kernel runs
    rows = train.pos_uqif[train.pos_uqif[:, 2] < train.item_count - 1]
    small = build_hypergraph(rows, train.node_count - 1, train.user_count,
                             train.query_count)
    too_big = train.query_words.copy()
    too_big[0, 0] = train.vocab_size + 1
    for graph, words in ((small, train.query_words),
                         (g, too_big), (g, train.query_words[1:])):
        with pytest.raises(ValueError):
            teval.make_eval_fns(model, graph, words,
                                train.query_word_counts, device="cpu")


# ---------------------------------------------------------------------------
# the port stands alone
# ---------------------------------------------------------------------------

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ihgnn_tpu", "tools")


def _package_modules():
    return [m.name for m in pkgutil.walk_packages(ihgnn_torch.__path__,
                                                  "ihgnn_torch.")]


def test_port_imports_no_jax_at_runtime():
    """Import every module of ihgnn_torch in a fresh interpreter and scan
    sys.modules."""
    mods = _package_modules()
    assert {"ihgnn_torch.ops.segsum", "ihgnn_torch.models.rawgnn",
            "ihgnn_torch.train.eval", "ihgnn_torch.convert"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print(sorted({n.split('.')[0] for n in sys.modules}))\n")
    root = Path(ihgnn_torch.__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                         capture_output=True, text=True, timeout=120).stdout
    loaded = set(ast.literal_eval(out.strip().splitlines()[-1]))
    assert "torch" in loaded
    assert not loaded & set(FORBIDDEN), loaded & set(FORBIDDEN)


def test_port_sources_import_no_jax():
    """No import statement in the package names a forbidden module, even
    inside a function."""
    root = Path(ihgnn_torch.__file__).resolve().parent
    bad = []
    for path in root.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            bad += [f"{path.name}: {n}" for n in names
                    if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad
