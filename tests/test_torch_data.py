"""The port's data layer and run-control helpers against the JAX package:
synthetic logs, the Step-3 artifact files, ``GraphData``'s histories and
negatives, ``EpochSchedule``, ``MetricsCollection``, the tee logger and
the debug statistics.

Everything here is exact (equal logs, byte-for-byte files, equal integer
arrays, equal schedule decisions and epochs), except the floating-point
statistics: the remaining-time estimate and the debug statistics are held
to 1e-12 relative and 1e-6 relative (f32 inputs, the same NumPy reductions
on both sides) respectively.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from ihgnn_torch.convert import params_from_jax
from ihgnn_torch.data import artifacts as tartifacts
from ihgnn_torch.data import synthetic as tsynthetic
from ihgnn_torch.data.dataset import GraphData as TGraphData
from ihgnn_torch.models.rawgnn import RawGnn as TRawGnn
from ihgnn_torch import config as tcfg
from ihgnn_torch.train.controller import EpochSchedule as TEpochSchedule
from ihgnn_torch.train.metrics import Metrics as TMetrics
from ihgnn_torch.train.metrics import MetricsCollection as TCollection
from ihgnn_torch.utils import debug as tdebug
from ihgnn_torch.utils import logging as tlogging
from ihgnn_tpu.config import ModelConfig
from ihgnn_tpu.data import artifacts as jartifacts
from ihgnn_tpu.data import synthetic as jsynthetic
from ihgnn_tpu.data.dataset import GraphData
from ihgnn_tpu.models.rawgnn import RawGnn
from ihgnn_tpu.ops.hyperagg import strip_kernel_packing
from ihgnn_tpu.train.controller import EpochSchedule
from ihgnn_tpu.train.metrics import Metrics, MetricsCollection
from ihgnn_tpu.utils import debug as jdebug

TINY = dict(user_count=25, query_count=15, item_count=40, vocab_size=30,
            log_count=300)


def _log_lines(logs):
    return [log.tostr() for log in logs]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_synthetic_logs_equal_jax(seed):
    j_logs, j_qw, j_qc = jsynthetic.make_synthetic_logs(seed=seed, **TINY)
    t_logs, t_qw, t_qc = tsynthetic.make_synthetic_logs(seed=seed, **TINY)
    assert _log_lines(t_logs) == _log_lines(j_logs)
    np.testing.assert_array_equal(t_qw, j_qw)
    np.testing.assert_array_equal(t_qc, j_qc)
    assert t_qw.dtype == j_qw.dtype and t_qc.dtype == j_qc.dtype


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_synthetic_splits_equal_jax(seed):
    j_train, j_valid, j_test = jsynthetic.make_synthetic_splits(seed=seed,
                                                                **TINY)
    t_train, t_valid, t_test = tsynthetic.make_synthetic_splits(seed=seed,
                                                                **TINY)
    assert _log_lines(t_train.search_logs) == _log_lines(j_train.search_logs)
    np.testing.assert_array_equal(t_train.pos_uqif, j_train.pos_uqif)
    np.testing.assert_array_equal(t_train.query_words, j_train.query_words)
    for t_ev, j_ev in ((t_valid, j_valid), (t_test, j_test)):
        assert (t_ev.count, t_ev.line_count) == (j_ev.count, j_ev.line_count)
        for name in ("users", "queries", "truth", "truth_counts"):
            np.testing.assert_array_equal(getattr(t_ev, name),
                                          getattr(j_ev, name), err_msg=name)


@pytest.mark.parametrize("seed,sizes", [
    (11, TINY),
    (7, dict(user_count=60, query_count=30, item_count=90, vocab_size=50,
             log_count=500, items_per_log=7, positive_rate=0.3)),
    (3, {}),
])
def test_write_synthetic_dataset_bytes_equal_jax(tmp_path, seed, sizes):
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jartifacts.write_synthetic_dataset(str(jdir), seed=seed, **sizes)
    tartifacts.write_synthetic_dataset(str(tdir), seed=seed, **sizes)
    names = sorted(os.listdir(jdir))
    assert sorted(os.listdir(tdir)) == names
    assert {"graph_info.txt", "queries_multihot.txt", "train_data.csv",
            "valid_data.csv", "test_data.csv", "vocabulary.txt"} <= set(names)
    for name in names:
        assert (tdir / name).read_bytes() == (jdir / name).read_bytes(), name


def test_write_split_artifacts_optional_files_equal_jax(tmp_path):
    logs, qw, _ = jsynthetic.make_synthetic_logs(seed=4, **TINY)
    t_logs, _, _ = tsynthetic.make_synthetic_logs(seed=4, **TINY)
    rows = [[int(w) - 1 for w in row if w > 0] for row in qw]
    titles = [[i % 7, (3 * i) % 11] for i in range(TINY["item_count"])]
    args = (TINY["user_count"], TINY["query_count"], TINY["item_count"],
            TINY["vocab_size"], rows)
    jartifacts.write_split_artifacts(str(tmp_path / "j"), logs, logs, logs,
                                     *args, item_titles=titles)
    tartifacts.write_split_artifacts(str(tmp_path / "t"), t_logs, t_logs,
                                     t_logs, *args, item_titles=titles)
    names = sorted(os.listdir(tmp_path / "j"))
    assert "item_titles_multihot.txt" in names
    assert "vocabulary.txt" not in names
    assert sorted(os.listdir(tmp_path / "t")) == names
    for name in names:
        assert ((tmp_path / "t" / name).read_bytes()
                == (tmp_path / "j" / name).read_bytes()), name


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("data") / "ds"
    jartifacts.write_synthetic_dataset(str(path), seed=11, **TINY)
    return str(path)


@pytest.mark.parametrize("limit", [500, 3, 1, -1])
def test_graph_data_from_files_equal_jax(dataset_dir, limit):
    j = GraphData.from_files(dataset_dir, "train", user_history_limit=limit)
    t = TGraphData.from_files(dataset_dir, "train", user_history_limit=limit)
    assert t.user_history_limit == j.user_history_limit == limit
    assert t.user_history() == j.user_history()
    for ta, ja in zip(t.user_history_tensors(), j.user_history_tensors()):
        assert ta.dtype == ja.dtype
        np.testing.assert_array_equal(ta, ja)
    assert t.neg_interactions == j.neg_interactions
    assert len(t.neg_interactions) > 0
    assert t.neg_items_for_uq == j.neg_items_for_uq
    np.testing.assert_array_equal(t.pos_uqif, j.pos_uqif)
    if limit > 0:
        assert max(len(h) for h in t.user_history()[1]) <= limit


@pytest.mark.parametrize("split", ["valid", "test"])
def test_graph_data_other_splits_equal_jax(dataset_dir, split):
    j = GraphData.from_files(dataset_dir, split, user_history_limit=2)
    t = TGraphData.from_files(dataset_dir, split, user_history_limit=2)
    assert t.user_history() == j.user_history()
    assert t.neg_interactions == j.neg_interactions


# (epoch_count, first_epoch, test_start, test_every, store_start,
# store_every)
SCHEDULES = [
    (10, 1, 2, 2, None, None),
    (7, 1, 3, 2, 7, 1000000),
    (5, 6, 2, 2, 5, 1000000),
    (60, 1, 5, 5, None, None),
    (4, 1, 10, 10, 4, 1000000),
    (9, 3, 1, 4, 2, 3),
    (1, 1, 1, 1, 1, 1000000),
    (12, 13, 5, 3, 4, 4),
]


@pytest.mark.parametrize("args", SCHEDULES)
def test_epoch_schedule_equal_jax(args):
    j, t = EpochSchedule(*args), TEpochSchedule(*args)
    assert list(t.epochs) == list(j.epochs)
    assert (t.end_epoch, t.last_epoch) == (j.end_epoch, j.last_epoch)
    assert t.remaining_text(t.first_epoch) == "n/a"
    for epoch in j.epochs:
        assert t.is_test_epoch(epoch) == j.is_test_epoch(epoch), epoch
        assert t.is_store_epoch(epoch) == j.is_store_epoch(epoch), epoch
    rng = np.random.default_rng(sum(a or 0 for a in args))
    for k, epoch in enumerate(j.epochs):
        seconds = float(rng.uniform(1, 4000))
        j.record_train_seconds(seconds)
        t.record_train_seconds(seconds)
        if k % 3 == 1:
            j.record_eval_seconds(2 * seconds)
            t.record_eval_seconds(2 * seconds)
        np.testing.assert_allclose(t.remaining_seconds(epoch),
                                   j.remaining_seconds(epoch), rtol=1e-12)
        assert t.remaining_text(epoch) == j.remaining_text(epoch)


@pytest.mark.parametrize("valid_rows,has_valid", [
    ([0.10, 0.30, 0.20, 0.30], True),          # tie: the first best
    ([0.40, 0.30, 0.20, 0.10], True),
    ([0.05, 0.06, 0.07, 0.08], False),
])
def test_metrics_collection_best_equal_jax(valid_rows, has_valid):
    j, t = MetricsCollection(has_valid), TCollection(has_valid)
    rng = np.random.default_rng(len(valid_rows))
    for k, ndcg in enumerate(valid_rows):
        test_row = rng.uniform(0, 1, 4)
        valid_row = [ndcg + 0.1, ndcg, ndcg / 2, ndcg / 3]
        epoch = 5 * (k + 1)
        jm = [Metrics.from_row(test_row)] + (
            [Metrics.from_row(valid_row)] if has_valid else [])
        tm = [TMetrics.from_row(test_row)] + (
            [TMetrics.from_row(valid_row)] if has_valid else [])
        j.add(epoch, *jm)
        t.add(epoch, *tm)
    rows = lambda ms: [m.to_string() for m in ms]  # noqa: E731
    key = lambda m: m.NDCG_at10  # noqa: E731
    if has_valid:
        je, jt, jv = j.get_valid_best(key)
        te, tt, tv = t.get_valid_best(key)
        assert (te, tt.to_string(), tv.to_string()) == \
            (je, jt.to_string(), jv.to_string())
        assert [(e, a.to_string(), b.to_string())
                for e, a, b in t.iter_epoch_test_valid()] == \
            [(e, a.to_string(), b.to_string())
             for e, a, b in j.iter_epoch_test_valid()]
    else:
        with pytest.raises(ValueError):
            t.get_valid_best(key)
    jb, tb = j.get_test_best(key), t.get_test_best(key)
    assert tb[0] == jb[0] and rows(tb[1:]) == rows(jb[1:])
    jb, tb = j.get_test_best(key, max_is_best=False), \
        t.get_test_best(key, max_is_best=False)
    assert tb[0] == jb[0]
    assert [(e, m.to_string()) for e, m in t.iter_epoch_test()] == \
        [(e, m.to_string()) for e, m in j.iter_epoch_test()]
    with pytest.raises(ValueError):
        t.add(99, TMetrics(), None if has_valid else TMetrics())


def test_tee_logger_strips_ansi_in_file(tmp_path, capsys):
    path = tmp_path / "log.txt"
    tlogging.start_logging(str(path))
    tlogging.log_print("\033[1;32mgreen\033[0m plain")
    tlogging.log_print("two\nlines")
    tlogging.log_print("head\n\033[31mbody\033[0m",
                       put_time_in_single_line=True)
    tlogging.end_logging()
    tlogging.log_print("after end")
    out = capsys.readouterr().out
    assert "\033[1;32mgreen\033[0m plain" in out and "after end" in out
    lines = path.read_text(encoding="utf-8").splitlines()
    assert "\033" not in path.read_text(encoding="utf-8")
    assert lines[0].endswith("] green plain")
    assert lines[1].endswith("] two") and lines[2].endswith("] lines")
    assert lines[3].endswith("] ") and lines[4:] == ["head", "body"]


@pytest.mark.parametrize("layers", [0, 1, 2])
def test_debug_stats_equal_jax(layers):
    d, n = 8, 57
    feats = np.random.default_rng(layers).standard_normal(
        (n, d * (1 + layers))).astype(np.float32)
    j = jdebug.feature_stats_from(feats.T, d, layers)
    for t in (tdebug.feature_stats_from(feats, d, layers),
              tdebug.feature_stats_from(torch.from_numpy(feats), d, layers)):
        assert [s["layer"] for s in t] == [s["layer"] for s in j]
        for ts, js in zip(t, j):
            np.testing.assert_allclose([ts["absmean"], ts["std"]],
                                       [js["absmean"], js["std"]],
                                       rtol=1e-6)


def test_embedding_info_equal_jax():
    data = jsynthetic.make_synthetic_data(seed=2, **TINY)
    cfg = ModelConfig(embedding_size=8)
    graph = strip_kernel_packing(data.hypergraph)
    model = RawGnn(cfg=cfg, user_count=data.user_count,
                   query_count=data.query_count, item_count=data.item_count,
                   vocab_size=data.vocab_size)
    zeros = np.zeros((1,), np.int32)
    params = model.init(jax.random.key(0), graph, data.query_words,
                        data.query_word_counts, zeros, zeros, zeros)
    params = jax.tree_util.tree_map(np.asarray, params)
    port = TRawGnn(tcfg.ModelConfig(**{f.name: getattr(cfg, f.name)
                                       for f in dataclasses.fields(
                                           tcfg.ModelConfig)}),
                   data.user_count, data.query_count, data.item_count,
                   data.vocab_size)
    port.load_state_dict(params_from_jax(params))
    np.testing.assert_allclose(tdebug.embedding_info(port),
                               jdebug.embedding_info(params), rtol=1e-6)
