"""The port's training CLI against the JAX package's: the flags
(``parse_args`` field by field, ``validate``), the result directory, whole
runs of both ``main``s on one artifact directory (RawGnn, and Srrl with
every KG and PS step's loss), the checkpoint round trip and resume (Srrl's
too), ``quality_parity``'s sections, and the flags the port refuses.

Tolerances of the whole runs (JAX's XLA path in f32 on the CPU against the
port's plain twins, from the same initial weights, carried over from the
JAX run, and the same sampler draws):
* each epoch's average loss: 1e-4 relative (f32 sums in another order,
  carried through Adam over 4 epochs);
* each test and valid metric of each test epoch: 1e-4 absolute, and the
  best epoch equal. A metric is an average of per-log top-10 decisions, so
  a flipped near-tie would show as a jump of at least 1/logs; the failure
  message prints the scores of both runs.
The checkpoint round trip is held bit for bit.

``--remat``, ``--bf16_stream`` and both run the same 4 epochs against the
JAX CLI with the same flags (JAX's XLA path). ``--remat`` alone, in f32:
the losses within 1e-5 relative and the metrics equal (remat recomputes
the same sums). With ``--bf16_stream``: the losses within 1e-4 relative
and the metrics within 1e-4; the two packages round the bf16 streams at
other points (``tests/test_torch_bf16.py``), which moves a step-0 loss
by about 2e-5 relative on the bf16 test graphs.
"""

import copy
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from ihgnn_torch import cli as tcli
from ihgnn_torch import config as tcfg
from ihgnn_torch.convert import params_from_jax
from ihgnn_torch.data.artifacts import write_synthetic_dataset
from ihgnn_torch.train import checkpoint as tckpt
from ihgnn_tpu import cli as jcli
from ihgnn_tpu import config as jcfg

TINY = dict(user_count=25, query_count=15, item_count=40, vocab_size=30,
            log_count=300)
LOSS_RTOL, METRIC_ATOL = 1e-4, 1e-4
REMAT_LOSS_RTOL = 1e-5
BF16_LOSS_RTOL, BF16_METRIC_ATOL = 1e-4, 1e-4
RUN = ["--epoch_count", "4", "--epoch_start_test", "2",
       "--epoch_test_frequency", "2", "--emb", "16"]


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("data") / "synth_ds"
    write_synthetic_dataset(str(path), seed=11, **TINY)
    return str(path)


ARGVS = [
    [],
    ["--cp", "latest", "--scp", "--sm", "--ec", "7", "--est", "3",
     "--ds", "/data/a/b/c", "--emb", "16", "--bs", "50", "--lr", "0.01"],
    ["--checkpoint", "checkpoint_x", "-c", "-m", "--epochs", "9"],
    ["--epoch_count", "5", "--epochs", "9"],
    ["--epoch_start_test", "4"],
    ["--est", "4", "--etf", "3"],
    ["--neg_random", "0", "--neg_nonrandom", "2"],
    ["--neg_random", "3"],
    ["--gnn", "GATLayer", "--model", "RawGnn", "--gnns", "3", "--fo", "2"],
    ["--gnn", " HGCN ", "--log_hypergraph", "--completeness", "ui"],
    ["--gnn", "gcn", "--completeness", "qi", "--feature_order", "1"],
    ["--phase2_attention", "--longtail", "lt.csv", "--grad_accum", "0",
     "--no_valid", "--eval_batch_size", "64", "--profile_dir", "prof",
     "--no_pallas", "--debug_stats", "--seed", "5", "--result_dir", "R"],
    ["--grad_accum", "4", "--dataset", "rel/ds", "--embedding_size", "8",
     "--batch_size", "7", "--learning_rate", "0.002"],
    ["--model", "srrl", "--remat", "--bf16_stream", "--mesh_data", "2",
     "--mesh_model", "4", "--multihost"],
]


@pytest.mark.parametrize("argv", ARGVS)
def test_parse_args_equal_jax(argv):
    j, t = jcfg.parse_args(argv), tcfg.parse_args(argv)
    for section in ("model", "train", "mesh", "runtime", "io"):
        jd = dataclasses.asdict(getattr(j, section))
        td = dataclasses.asdict(getattr(t, section))
        if section == "runtime":
            assert td.pop("device") == "cuda"
            assert td.pop("run_record") is None
        assert td == jd, section
    assert tcfg.parse_args(argv + ["--device", "cpu"]).runtime.device == "cpu"


@pytest.mark.parametrize("argv", [
    ["--model", "foo"], ["--gnn", "xyz"], ["--fo", "4"],
    ["--completeness", "uqx"], ["--gnns", "-1"], ["--bs", "-5"],
])
def test_validate_rejects_as_jax(argv):
    with pytest.raises(ValueError):
        jcfg.parse_args(argv)
    with pytest.raises(ValueError):
        tcfg.parse_args(argv)


@pytest.mark.parametrize("argv", [
    ["--ds", "/data/amazon/Kindle"],
    ["--ds", "Kindle/", "--gnn", "gat", "--gnns", "3", "--emb", "64"],
    ["--ds", "a/b/c/d", "--fo", "2", "--result_dir", "/tmp/R"],
    ["--ds", "x", "--model", "srrl"],
    ["--ds", "", "--gnn", "hgcn"],
])
def test_result_dir_name_equal_jax(argv):
    assert tcli.result_dir_name(tcfg.parse_args(argv)) == \
        jcli.result_dir_name(jcfg.parse_args(argv))


def test_pick_graph_rejects_log_hypergraph_without_hgcn(dataset_dir):
    from ihgnn_torch.data.dataset import GraphData as TGraphData
    cfg = tcfg.parse_args(["--log_hypergraph"])
    with pytest.raises(ValueError, match="requires --gnn hgcn"):
        tcli.pick_graph(TGraphData.from_files(dataset_dir), cfg)


def _spy(monkeypatch, module, name, record):
    """Wrap ``module.name`` so each call's average loss (its second
    argument) is appended to ``record``."""
    original = getattr(module, name)

    def spy(state, avg_loss, *args, **kwargs):
        record.append(avg_loss)
        return original(state, avg_loss, *args, **kwargs)

    monkeypatch.setattr(module, name, spy)


def _rows(mc):
    return [(e, [m.HitRatio_at10, m.NDCG_at10, m.MAP_at10, m.MRR_at10],
             [v.HitRatio_at10, v.NDCG_at10, v.MAP_at10, v.MRR_at10])
            for e, m, v in mc.iter_epoch_test_valid()]


def _run_both(monkeypatch, tmp_path, dataset_dir, extra):
    """4 epochs of both CLIs with the flags ``extra`` from the same initial
    weights: the JAX run's params go through ``convert.params_from_jax``
    into the port's ``build_model``; the sampler draws the same batches
    from the seed. Returns (JAX losses, port losses, JAX metrics, port
    metrics)."""
    captured = {}
    init_state = jcli.init_state

    def spy_init(*args, **kwargs):
        state = init_state(*args, **kwargs)
        captured["params"] = jax.tree_util.tree_map(np.asarray, state.params)
        return state

    monkeypatch.setattr(jcli, "init_state", spy_init)
    j_losses, t_losses = [], []
    _spy(monkeypatch, jcli, "adjust_lr_after_epoch", j_losses)
    _spy(monkeypatch, tcli, "adjust_lr_after_epoch", t_losses)
    build_model = tcli.build_model

    def carried(cfg, data, device):
        model = build_model(cfg, data, device)
        model.load_state_dict(params_from_jax(captured["params"]))
        return model

    monkeypatch.setattr(tcli, "build_model", carried)
    argv = ["--dataset", dataset_dir, *RUN, "--storemetrics", *extra]
    j_mc = jcli.main(argv + ["--result_dir", str(tmp_path / "jax")])
    t_mc = tcli.main(argv + ["--result_dir", str(tmp_path / "port"),
                             "--device", "cpu"])
    assert len(t_losses) == len(j_losses) == 4
    assert t_losses[-1] < t_losses[0]
    return j_losses, t_losses, j_mc, t_mc


def _assert_metrics_close(j_mc, t_mc, atol):
    """Each test and valid metric of each test epoch within ``atol``, and
    the best epoch by valid NDCG@10 equal."""
    j_rows, t_rows = _rows(j_mc), _rows(t_mc)
    assert [r[0] for r in t_rows] == [r[0] for r in j_rows] == [2, 4]
    for (e, jt, jv), (_, tt, tv) in zip(j_rows, t_rows):
        np.testing.assert_allclose(tt, jt, atol=atol,
                                   err_msg=f"test, epoch {e}: {t_rows} "
                                           f"against {j_rows}")
        np.testing.assert_allclose(tv, jv, atol=atol,
                                   err_msg=f"valid, epoch {e}: {t_rows} "
                                           f"against {j_rows}")
    key = lambda m: m.NDCG_at10  # noqa: E731
    assert t_mc.get_valid_best(key)[0] == j_mc.get_valid_best(key)[0]


@pytest.mark.parametrize("extra", [[], ["--grad_accum", "3",
                                        "--bs", "60"]])
def test_cli_run_equal_jax(monkeypatch, tmp_path, dataset_dir, extra):
    """4 epochs of both CLIs from the same initial weights (``_run_both``),
    and the files they write."""
    j_losses, t_losses, j_mc, t_mc = _run_both(monkeypatch, tmp_path,
                                               dataset_dir, extra)
    np.testing.assert_allclose(t_losses, j_losses, rtol=LOSS_RTOL)
    _assert_metrics_close(j_mc, t_mc, METRIC_ATOL)
    assert [s.epoch for s in t_mc.epoch_stats] == [1, 2, 3, 4]
    assert [s.eval_s is not None for s in t_mc.epoch_stats] == \
        [False, True, False, True]
    np.testing.assert_allclose([s.avg_loss for s in t_mc.epoch_stats],
                               t_losses, rtol=0)

    # both write the same files, and the metrics files the same lines
    # apart from the numbers' last digits
    (j_dir,) = os.listdir(tmp_path / "jax")
    (t_dir,) = os.listdir(tmp_path / "port")
    assert t_dir == j_dir
    assert t_dir.endswith("-synth_ds-RawGnn-2IHGNNLayer-O3-emb16")
    t_files = sorted(os.listdir(tmp_path / "port" / t_dir))
    j_files = sorted(os.listdir(tmp_path / "jax" / j_dir))
    assert [f.split("_", 1)[1] for f in t_files] == \
        [f.split("_", 1)[1] for f in j_files] == \
        ["metrics.txt", "train_log.txt"]
    t_text = (tmp_path / "port" / t_dir / t_files[0]).read_text()
    j_text = (tmp_path / "jax" / j_dir / j_files[0]).read_text()
    strip = lambda s: [ln.split()[0] if ln else ln  # noqa: E731
                       for ln in s.splitlines()]
    assert strip(t_text) == strip(j_text)


def _train_a_little(seed=0):
    """A small model and Adam after three steps, with a decayed lr."""
    from ihgnn_torch.data.synthetic import make_synthetic_data
    from ihgnn_torch.data.dataset import TrainSampler
    from ihgnn_torch.models.rawgnn import RawGnn
    from ihgnn_torch.train.train import make_optimizer, make_train_step
    data = make_synthetic_data(seed=seed, **TINY)
    cfg = tcfg.Config(model=tcfg.ModelConfig(embedding_size=8),
                      train=tcfg.TrainConfig(batch_size=64))
    model = RawGnn(cfg.model, data.user_count, data.query_count,
                   data.item_count, data.vocab_size,
                   generator=torch.Generator().manual_seed(seed))
    opt = make_optimizer(model.parameters(), cfg.train)
    step = make_train_step(model, data.hypergraph, data.query_words,
                           data.query_word_counts, opt, device="cpu")
    for _, batch in zip(range(3), TrainSampler(data, 64, 10).epoch()):
        step(batch)
    opt.param_groups[0]["lr"] *= 0.98
    return model, opt, data, cfg


def test_checkpoint_round_trip_bit_for_bit(tmp_path):
    model, opt, data, cfg = _train_a_little()
    first = tckpt.save_checkpoint(str(tmp_path), 3, model, opt)
    assert first.startswith("checkpoint_") and first.endswith("_epoch3")
    (tmp_path / "checkpoint_000000-000000_epoch1").write_bytes(b"")
    assert tckpt.find_latest(str(tmp_path)) == first
    assert tckpt.find_latest(str(tmp_path / "none")) is None

    fresh, fresh_opt, _, _ = _train_a_little(seed=1)
    assert tckpt.restore_checkpoint(str(tmp_path), "latest", fresh,
                                    fresh_opt) == 3
    for (name, a), (_, b) in zip(model.state_dict().items(),
                                 fresh.state_dict().items()):
        assert torch.equal(a, b), name
    saved, loaded = opt.state_dict(), fresh_opt.state_dict()
    assert loaded["param_groups"] == saved["param_groups"]
    assert fresh_opt.param_groups[0]["lr"] == 1e-3 * 0.98
    assert saved["state"].keys() == loaded["state"].keys()
    for k, state in saved["state"].items():
        for name in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(state[name], loaded["state"][k][name]), name
        assert loaded["state"][k]["step"].device.type == "cpu"
        assert loaded["state"][k]["step"].item() == 3
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(str(tmp_path / "none"), "latest", fresh,
                                 fresh_opt)


def test_cli_resume_from_latest(monkeypatch, tmp_path, dataset_dir):
    """``--storecheckpoint`` stores the last epoch only; ``--checkpoint
    latest`` restores it exactly and renumbers from the next epoch."""
    saved, restored = {}, {}
    save, restore = tcli.save_checkpoint, tcli.restore_checkpoint

    def snapshot(model, opt):
        # copies: the run goes on changing both in place
        return ({k: v.clone() for k, v in model.state_dict().items()},
                copy.deepcopy(opt.state_dict()))

    def spy_save(result_dir, epoch, model, opt, **kw):
        saved[epoch] = snapshot(model, opt)
        return save(result_dir, epoch, model, opt, **kw)

    def spy_restore(result_dir, name, model, opt, **kw):
        epoch = restore(result_dir, name, model, opt, **kw)
        restored[epoch] = snapshot(model, opt)
        return epoch

    monkeypatch.setattr(tcli, "save_checkpoint", spy_save)
    monkeypatch.setattr(tcli, "restore_checkpoint", spy_restore)
    base = ["--dataset", dataset_dir, "--emb", "8", "--device", "cpu",
            "--result_dir", str(tmp_path), "--est", "2"]
    first = tcli.main(base + ["--epoch_count", "4", "--storecheckpoint"])
    assert list(saved) == [4]
    second = tcli.main(base + ["--epoch_count", "2", "--checkpoint",
                               "latest"])
    assert list(restored) == [4]
    (params, opt_state), (r_params, r_opt_state) = saved[4], restored[4]
    for name in params:
        assert torch.equal(params[name], r_params[name]), name
    assert r_opt_state["param_groups"] == opt_state["param_groups"]
    for k, state in opt_state["state"].items():
        for name, value in state.items():
            assert torch.equal(value, r_opt_state["state"][k][name]), name
    assert [s.epoch for s in first.epoch_stats] == [1, 2, 3, 4]
    assert [s.epoch for s in second.epoch_stats] == [5, 6]
    assert [e for e, _ in second.iter_epoch_test()] == [6]
    # the loss goes on from where the first run stopped
    assert second.epoch_stats[0].avg_loss < first.epoch_stats[0].avg_loss
    (result,) = os.listdir(tmp_path)
    names = os.listdir(tmp_path / result)
    assert sum(n.startswith("checkpoint_") for n in names) == 1
    assert "train_log.txt" in names


def test_cli_long_tail_and_debug_flows(tmp_path, dataset_dir, capsys):
    mc = tcli.main(["--dataset", dataset_dir, "--emb", "8", "--device",
                    "cpu", "--result_dir", str(tmp_path), "--ec", "2",
                    "--est", "1", "--longtail", "lt.csv", "--debug_stats",
                    "--no_pallas", "--no_valid", "--profile_dir",
                    str(tmp_path / "prof"), "--gnn", "gat"])
    assert [e for e, _ in mc.iter_epoch_test()] == [1, 2]
    out = capsys.readouterr().out
    assert "[debug] layer 2:" in out and "Best test metrics at epoch" in out
    (result,) = [n for n in os.listdir(tmp_path) if n != "prof"]
    assert result.endswith("-RawGnn-2GATLayer-emb8")
    lines = (tmp_path / result / "lt.csv").read_text().splitlines()
    assert len(lines) == TINY["user_count"]
    assert os.listdir(tmp_path / "prof") == ["epoch2.trace.json"]


@pytest.mark.parametrize("flags,loss_rtol,metric_atol", [
    (["--remat"], REMAT_LOSS_RTOL, 0.0),
    (["--bf16_stream"], BF16_LOSS_RTOL, BF16_METRIC_ATOL),
    (["--bf16_stream", "--remat"], BF16_LOSS_RTOL, BF16_METRIC_ATOL),
])
def test_cli_bf16_and_remat_equal_jax(monkeypatch, tmp_path, dataset_dir,
                                      flags, loss_rtol, metric_atol):
    """``--remat``, ``--bf16_stream`` and both, 4 epochs of each CLI with
    the same flags (``_run_both``; JAX on its XLA path)."""
    j_losses, t_losses, j_mc, t_mc = _run_both(monkeypatch, tmp_path,
                                               dataset_dir, flags)
    np.testing.assert_allclose(t_losses, j_losses, rtol=loss_rtol)
    _assert_metrics_close(j_mc, t_mc, metric_atol)


@pytest.mark.parametrize("flags", [
    ["--mesh_data", "2", "--model", "srrl"],
    ["--mesh_model", "2"],
    ["--multihost"],
])
def test_mesh_flags_need_torchrun(monkeypatch, tmp_path, dataset_dir, flags):
    """A mesh of more ranks than one (a model-only mesh and Srrl under a
    mesh too) and ``--multihost`` run one process a rank: without
    torchrun's ``WORLD_SIZE`` the CLI says so and writes nothing (the runs
    themselves: ``tests/test_torch_model_axis.py``)."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="torchrun"):
        tcli.main(["--dataset", dataset_dir, "--device", "cpu",
                   "--result_dir", str(tmp_path), *flags])
    assert not os.listdir(tmp_path)


def _record_steps(monkeypatch, module, record):
    """Wrap ``module``'s ``make_kg_steps`` and ``make_ps_step`` so every
    step's loss is appended to ``record`` as a float; a JAX step returns
    ``(state, loss)``, a port step the loss."""
    def value(out):
        return float(out[1] if isinstance(out, tuple) else out)

    def wrap(step):
        def recorded(*args):
            out = step(*args)
            record.append(value(out))
            return out
        return recorded

    make_kg, make_ps = module.make_kg_steps, module.make_ps_step
    monkeypatch.setattr(module, "make_kg_steps", lambda *a, **k: {
        mode: wrap(step) for mode, step in make_kg(*a, **k).items()})
    monkeypatch.setattr(module, "make_ps_step",
                        lambda *a, **k: wrap(make_ps(*a, **k)))


def test_cli_srrl_run_equal_jax(monkeypatch, tmp_path, dataset_dir):
    """``--model srrl``: 4 epochs of both CLIs from the same initial
    weights (JAX's ``init_srrl`` carried over with
    ``convert.srrl_params_from_jax``) and the same sampler draws: every KG
    and PS step's loss within LOSS_RTOL and the metrics as
    ``test_cli_run_equal_jax`` holds them."""
    from ihgnn_torch.convert import srrl_params_from_jax
    from ihgnn_torch.train import srrl_loop as tloop
    from ihgnn_tpu.train import srrl_loop as jloop

    captured = {}
    init_srrl = jloop.init_srrl

    def spy_init(*args, **kwargs):
        model, state, *rest = init_srrl(*args, **kwargs)
        captured["params"] = jax.tree_util.tree_map(np.asarray, state.params)
        return (model, state, *rest)

    monkeypatch.setattr(jloop, "init_srrl", spy_init)
    build = tloop.build_srrl

    def carried(cfg, data, device):
        model = build(cfg, data, device)
        model.load_state_dict(srrl_params_from_jax(captured["params"]))
        return model

    monkeypatch.setattr(tloop, "build_srrl", carried)
    j_losses, t_losses = [], []
    _record_steps(monkeypatch, jloop, j_losses)
    _record_steps(monkeypatch, tloop, t_losses)
    argv = ["--dataset", dataset_dir, *RUN, "--storemetrics", "--model",
            "srrl"]
    j_mc = jcli.main(argv + ["--result_dir", str(tmp_path / "jax")])
    t_mc = tcli.main(argv + ["--result_dir", str(tmp_path / "port"),
                             "--device", "cpu"])
    stats = t_mc.epoch_stats
    assert [s.epoch for s in stats] == [1, 2, 3, 4]
    assert len(t_losses) == len(j_losses) == 4 * (stats[0].kg_steps
                                                  + stats[0].steps)
    np.testing.assert_allclose(t_losses, j_losses, rtol=LOSS_RTOL)
    assert stats[-1].avg_loss < stats[0].avg_loss
    _assert_metrics_close(j_mc, t_mc, METRIC_ATOL)
    (t_dir,) = os.listdir(tmp_path / "port")
    assert t_dir == os.listdir(tmp_path / "jax")[0]
    assert t_dir.endswith("-synth_ds-Srrl-emb16")


def test_cli_srrl_resume_from_latest(monkeypatch, tmp_path, dataset_dir):
    """``--model srrl --storecheckpoint`` stores the model and the shared
    Adam; ``--checkpoint latest`` restores them bit for bit and renumbers
    from the next epoch."""
    from ihgnn_torch.train import srrl_loop as tloop

    saved, restored = {}, {}
    save, restore = tloop.save_checkpoint, tloop.restore_checkpoint

    def snapshot(model, opt):
        return ({k: v.clone() for k, v in model.state_dict().items()},
                copy.deepcopy(opt.state_dict()))

    def spy_save(result_dir, epoch, model, opt, **kw):
        saved[epoch] = snapshot(model, opt)
        return save(result_dir, epoch, model, opt, **kw)

    def spy_restore(result_dir, name, model, opt, **kw):
        epoch = restore(result_dir, name, model, opt, **kw)
        restored[epoch] = snapshot(model, opt)
        return epoch

    monkeypatch.setattr(tloop, "save_checkpoint", spy_save)
    monkeypatch.setattr(tloop, "restore_checkpoint", spy_restore)
    base = ["--dataset", dataset_dir, "--emb", "8", "--device", "cpu",
            "--result_dir", str(tmp_path), "--est", "2", "--model", "srrl"]
    first = tcli.main(base + ["--epoch_count", "2", "--storecheckpoint"])
    second = tcli.main(base + ["--epoch_count", "2", "--checkpoint",
                               "latest"])
    assert list(saved) == [2] == list(restored)
    (params, opt_state), (r_params, r_opt_state) = saved[2], restored[2]
    for name in params:
        assert torch.equal(params[name], r_params[name]), name
    assert r_opt_state["param_groups"] == opt_state["param_groups"]
    assert r_opt_state["state"].keys() == opt_state["state"].keys()
    for k, state in opt_state["state"].items():
        for name, value in state.items():
            assert torch.equal(value, r_opt_state["state"][k][name]), name
    assert [s.epoch for s in first.epoch_stats] == [1, 2]
    assert [s.epoch for s in second.epoch_stats] == [3, 4]
    assert [e for e, _ in second.iter_epoch_test()] == [4]
    (result,) = os.listdir(tmp_path)
    assert result.endswith("-Srrl-emb8")


def test_cuda_without_a_card_raises(tmp_path, dataset_dir):
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda runs there")
    with pytest.raises(RuntimeError, match="is_available"):
        tcli.main(["--dataset", dataset_dir, "--result_dir", str(tmp_path)])
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("port,jax_,within", [
    ({"hr": [0.165, 0.001]}, {"hr": [0.164, 0.0011]}, True),
    ({"hr": [0.1663, 0.001]}, {"hr": [0.164, 0.0011]}, False),
    ({"hr": [0.160, 0.003]}, {"hr": [0.164, 0.0011]}, True),
    ({"hr": [0.157, 0.003]}, {"hr": [0.164, 0.0011]}, False),
])
def test_quality_verdict_rule(monkeypatch, port, jax_, within):
    """The port's mean within 2 × max(port std, JAX std) of the JAX
    mean."""
    from ihgnn_torch import quality_parity
    monkeypatch.setattr(quality_parity, "METRICS", ("hr",))
    v = quality_parity.verdict(port, jax_)["hr"]
    assert v["within"] is within
    assert v["limit"] == 2 * max(port["hr"][1], jax_["hr"][1])


def test_quality_parity_small_run(tmp_path, dataset_dir):
    """The script end to end on the CPU at a tiny size: it reads
    PARITY.json without writing it, and its summary and exit code follow
    its runs."""
    import json

    from ihgnn_torch import quality_parity
    parity = quality_parity.ROOT / "PARITY.json"
    before = parity.read_bytes()
    out = tmp_path / "qp.json"
    rc = quality_parity.main(["--dataset", dataset_dir, "--seeds", "2",
                              "--epochs", "5", "--emb", "8", "--device",
                              "cpu", "--out", str(out)])
    assert parity.read_bytes() == before
    result = json.loads(out.read_text())
    runs = result["runs"]
    assert [r["seed"] for r in runs] == [0, 1]
    assert all(r["epoch"] == 5 and r["steps_per_epoch"] == 4 for r in runs)
    for k in quality_parity.METRICS:
        values = [r["test"][k] for r in runs]
        np.testing.assert_allclose(result["summary"]["port"][k],
                                   [np.mean(values), np.std(values)],
                                   rtol=1e-12)
        assert result["summary"]["jax"][k] == \
            json.loads(before)["rawgnn"]["summary"]["ours"][k]
    assert rc == (0 if all(v["within"] for v in
                           result["verdict"].values()) else 1)


@pytest.mark.parametrize("argv,section", [
    (["--model", "srrl", "--seeds", "2"], "srrl"),
    (["--set", "cikm", "--seeds", "1"], "cikm"),
])
def test_quality_parity_srrl_and_cikm_small_runs(monkeypatch, tmp_path,
                                                 dataset_dir, argv, section):
    """``--model srrl`` (on the tiny set) and ``--set cikm`` (the CIKM
    writer and Steps 1 and 3 at a small size) end to end on the CPU,
    each held against its own ``PARITY.json`` section."""
    import json

    from ihgnn_torch import quality_parity
    monkeypatch.setattr(quality_parity, "CIKM_SET", dict(
        seed=3, users=30, products=80, sessions=6, categories=5,
        graded_frac=0.3))
    if section == "srrl":
        argv = argv + ["--dataset", dataset_dir]
    out = tmp_path / "qp.json"
    rc = quality_parity.main(argv + ["--epochs", "5", "--emb", "8",
                                     "--device", "cpu", "--out", str(out)])
    result = json.loads(out.read_text())
    assert result["section"] == section
    parity = json.loads((quality_parity.ROOT / "PARITY.json").read_text())
    assert result["summary"]["jax"] == parity[section]["summary"]["ours"]
    runs = result["runs"]
    assert len(runs) == int(argv[argv.index("--seeds") + 1])
    assert all(r["epoch"] == 5 for r in runs)
    assert all((r["kg_steps_per_epoch"] > 0) == (section == "srrl")
               for r in runs)
    if section == "cikm":
        assert result["preprocess_s"]["bumped"] > 0
    assert rc == (0 if all(v["within"] for v in
                           result["verdict"].values()) else 1)
    with pytest.raises(ValueError, match="RawGnn"):
        quality_parity.parity_section("srrl", "cikm")


def test_chip_smoke_imports_no_jax():
    """``chip_smoke.py`` runs where JAX is absent: none of its imports,
    inside functions too, names JAX or the JAX package."""
    import ast
    from pathlib import Path
    path = Path(tcli.__file__).resolve().parent.parent / "chip_smoke.py"
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert "ihgnn_torch.quality_parity" in names
    forbidden = {"jax", "jaxlib", "flax", "optax", "orbax", "ihgnn_tpu",
                 "tools"}
    assert not [n for n in names if n.split(".")[0] in forbidden]
