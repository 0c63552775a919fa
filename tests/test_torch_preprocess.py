"""The port's offline preprocessing pipeline against the JAX package's.

The five cases of ``tests/test_preprocess.py`` run on the port, on the
same Amazon and CIKM fixtures. Against JAX everything is exact: the
intermediate directories of Steps 1 and 2 and the artifacts of Step 3
are byte for byte the JAX package's, with Python's global ``random``
seeded alike before each package's run; so are the module CLIs' outputs,
a Step 3 run from ``presplit_dir``, ``TextPreprocessor``'s tokens with
nltk's pieces as they import here and with nltk made absent on both
sides, and the CIKM quality-set writer's raw files and artifacts against
``tools/make_cikm_synth.py`` at a small size.
"""

import os
import random
import sys

import pytest

from ihgnn_torch.data.dataset import EvalLogs as TEvalLogs
from ihgnn_torch.data.dataset import GraphData as TGraphData
from ihgnn_torch.data.preprocess import amazon as tamazon
from ihgnn_torch.data.preprocess import cikm as tcikm
from ihgnn_torch.data.preprocess import onehot as tonehot
from ihgnn_torch.data.preprocess import subset as tsubset
from ihgnn_torch.data.preprocess import synth_cikm
from ihgnn_torch.data.preprocess import text as ttext
from ihgnn_tpu.data.preprocess import amazon as jamazon
from ihgnn_tpu.data.preprocess import cikm as jcikm
from ihgnn_tpu.data.preprocess import onehot as jonehot
from ihgnn_tpu.data.preprocess import subset as jsubset
from ihgnn_tpu.data.preprocess import text as jtext
from test_preprocess import make_amazon_files, make_cikm_files

TEXTS = ["The Running Shoes 42 (Blue)!", "Électronique: câbles, 2x USB-C",
         "Books > Science Fiction & Fantasy", "  ", "don't STOP—believing…"]


def _files(path):
    """{relative path: bytes} of every file under ``path``."""
    out = {}
    for root, _, names in os.walk(path):
        for name in names:
            full = os.path.join(root, name)
            with open(full, "rb") as f:
                out[os.path.relpath(full, path)] = f.read()
    return out


def _assert_same_files(got, want):
    g, w = _files(got), _files(want)
    assert sorted(g) == sorted(w)
    for name in w:
        assert g[name] == w[name], name


# ---- the cases of tests/test_preprocess.py, on the port ----

def test_amazon_pipeline_end_to_end(tmp_path):
    meta, reviews = make_amazon_files(tmp_path)
    inter = tamazon.step1_amazon(meta, reviews)
    assert len(inter.logs) > 0
    assert all(len(log.item_ids) == 1 for log in inter.logs)
    assert all(log.interactions == [1] for log in inter.logs)
    sub = tsubset.step2_subset(inter, n_core_item=2)
    assert len(sub.item_ids) <= len(inter.item_ids)
    items = set(sub.item_ids)
    for log in sub.logs:
        assert set(log.item_ids) <= items
    out = tmp_path / "final"
    random.seed(0)
    tonehot.step3_convert(sub, str(out))
    for fn in ["graph_info.txt", "queries_multihot.txt", "train_data.csv",
               "valid_data.csv", "test_data.csv", "vocabulary.txt",
               "item_titles_multihot.txt", "search_ids_train.txt"]:
        assert (out / fn).exists(), fn
    data = TGraphData.from_files(str(out))
    assert data.pos_count > 0
    assert data.hypergraph.edge_count == data.pos_count
    assert TEvalLogs.from_file(str(out / "test_data.csv")).count >= 0
    assert data.pos_uqif[:, 0].max() < data.user_count
    assert data.pos_uqif[:, 1].max() < data.query_count
    assert data.pos_uqif[:, 2].max() < data.item_count


def test_cikm_pipeline_end_to_end(tmp_path):
    q, p, c = make_cikm_files(tmp_path)
    inter = tcikm.step1_cikm(q, p, c, with_category=True)
    assert len(inter.logs) > 0
    max_item_token = max(int(w) for w in inter.vocabulary_item)
    assert [qs for qs in inter.queries
            if int(qs.split()[0]) > max_item_token]
    out = tmp_path / "final"
    random.seed(0)
    tonehot.step3_convert(inter, str(out), split_ratios=(0.6, 0.2, 0.2))
    assert TGraphData.from_files(str(out)).pos_count > 0


def test_text_preprocessor():
    words = ttext.TextPreprocessor().preprocess(TEXTS[0])
    assert "the" not in words
    assert all(w.isalpha() for w in words)
    assert any(w.startswith("run") for w in words)


# ---- against JAX, byte for byte ----

@pytest.mark.parametrize("nltk", ["as_installed", "absent"])
def test_text_preprocessor_equal_jax(monkeypatch, nltk):
    if nltk == "absent":
        for name in ("nltk", "nltk.stem", "nltk.stem.snowball",
                     "nltk.corpus", "nltk.tokenize"):
            monkeypatch.setitem(sys.modules, name, None)
    j, t = jtext.TextPreprocessor(), ttext.TextPreprocessor()
    assert t._stopwords == j._stopwords
    assert ttext.FALLBACK_STOPWORDS == jtext.FALLBACK_STOPWORDS
    for text in TEXTS:
        assert t.preprocess(text) == j.preprocess(text), text
    if nltk == "absent":
        assert t._stem("running") == "running"
        assert t._stopwords is ttext.FALLBACK_STOPWORDS


@pytest.mark.parametrize("nltk", ["as_installed", "absent"])
@pytest.mark.parametrize("subset", [dict(n_core_item=2),
                                    dict(n_core_user=4),
                                    dict(rand_user=5), {}])
def test_amazon_steps_equal_jax(monkeypatch, tmp_path, nltk, subset):
    """Steps 1, 2 and 3 on the Amazon fixture: every file of each step
    byte for byte JAX's."""
    if nltk == "absent":
        for name in ("nltk", "nltk.stem", "nltk.stem.snowball",
                     "nltk.corpus", "nltk.tokenize"):
            monkeypatch.setitem(sys.modules, name, None)
    meta, reviews = make_amazon_files(tmp_path)
    out = {}
    for name, (step1, step2, step3) in (
            ("jax", (jamazon.step1_amazon, jsubset.step2_subset,
                     jonehot.step3_convert)),
            ("port", (tamazon.step1_amazon, tsubset.step2_subset,
                      tonehot.step3_convert))):
        inter = step1(meta, reviews)
        inter.write(str(tmp_path / name / "step1"))
        random.seed(11)
        sub = step2(inter, **subset)
        sub.write(str(tmp_path / name / "step2"))
        random.seed(0)
        step3(sub, str(tmp_path / name / "step3"))
        out[name] = tmp_path / name
    _assert_same_files(out["port"], out["jax"])


@pytest.mark.parametrize("with_category", [True, False])
def test_cikm_steps_equal_jax(tmp_path, with_category):
    q, p, c = make_cikm_files(tmp_path)
    for name, (step1, step3) in (
            ("jax", (jcikm.step1_cikm, jonehot.step3_convert)),
            ("port", (tcikm.step1_cikm, tonehot.step3_convert))):
        inter = step1(q, p, c, with_category=with_category)
        inter.write(str(tmp_path / name / "step1"))
        random.seed(0)
        step3(inter, str(tmp_path / name / "step3"),
              split_ratios=(0.6, 0.2, 0.2))
    _assert_same_files(tmp_path / "port", tmp_path / "jax")


def test_preprocess_module_clis(tmp_path):
    """The three steps through their ``main(argv)``, with the JAX flags:
    the port's directories byte for byte the JAX CLIs'."""
    meta, reviews = make_amazon_files(tmp_path)
    for name, (amazon, subset, onehot) in (
            ("jax", (jamazon, jsubset, jonehot)),
            ("port", (tamazon, tsubset, tonehot))):
        root = tmp_path / name
        amazon.main(["--item", meta, "--search", reviews, "--result",
                     str(root / "inter")])
        subset.main(["--source", str(root / "inter"), "--result",
                     str(root / "sub"), "--nitem", "2"])
        random.seed(0)
        onehot.main(["--source", str(root / "sub"), "--result",
                     str(root / "final"), "--split", "0.7,0.1"])
    _assert_same_files(tmp_path / "port", tmp_path / "jax")
    assert TGraphData.from_files(str(tmp_path / "port" / "final")
                                 ).pos_count > 0
    q, p, c = make_cikm_files(tmp_path)
    for name, cikm in (("jax", jcikm), ("port", tcikm)):
        cikm.main(["--queries", q, "--products", p, "--clicks", c,
                   "--result", str(tmp_path / f"cikm_{name}"),
                   "--no_category"])
    _assert_same_files(tmp_path / "cikm_port", tmp_path / "cikm_jax")


def test_presplit_reproduces_jax(tmp_path):
    """A Step 3 from ``presplit_dir`` reproduces the split it reads, and
    the port's from JAX's ids equals JAX's own."""
    meta, reviews = make_amazon_files(tmp_path)
    j_out, t_out = str(tmp_path / "jax"), str(tmp_path / "port")
    random.seed(3)
    jonehot.step3_convert(jamazon.step1_amazon(meta, reviews), j_out)
    tonehot.step3_convert(tamazon.step1_amazon(meta, reviews), t_out,
                          presplit_dir=j_out)
    _assert_same_files(t_out, j_out)
    # and through the CLI, from the intermediate directory
    inter_dir, again = str(tmp_path / "inter"), str(tmp_path / "again")
    tamazon.step1_amazon(meta, reviews).write(inter_dir)
    tonehot.main(["--source", inter_dir, "--result", again, "--presplit",
                  t_out])
    _assert_same_files(again, t_out)


def test_cikm_quality_set_writer_equal_tool(monkeypatch, tmp_path):
    """The port's writer against ``tools/make_cikm_synth.py`` at a small
    size: its raw files and its Step-3 artifacts, byte for byte."""
    from tools import make_cikm_synth

    small = dict(users=40, products=120, sessions=9, categories=6)
    monkeypatch.setattr(sys, "argv", [
        "make_cikm_synth.py", "--out", str(tmp_path / "tool"),
        *[x for k, v in small.items() for x in (f"--{k}", str(v))]])
    make_cikm_synth.main()
    stats = synth_cikm.make_cikm_set(str(tmp_path / "port"), **small)
    assert stats["bumped"] > 0
    _assert_same_files(tmp_path / "port_raw", tmp_path / "tool_raw")
    _assert_same_files(tmp_path / "port", tmp_path / "tool")
    synth_cikm.main(["--out", str(tmp_path / "cli"), *[
        x for k, v in small.items() for x in (f"--{k}", str(v))]])
    _assert_same_files(tmp_path / "cli", tmp_path / "tool")
