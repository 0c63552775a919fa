"""The system under test: ``ihgnn_torch``, built as a configuration says.

Everything the benchmark takes from the program goes through here: the
kernels' build, ``build_hypergraph`` and ``build_graph2d``, ``RawGnn``, ``make_train_step``,
``make_eval_fns``, ``prefetch``, the launch counters and the scores that
the eval path ranks. Nothing here
imports the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict

import numpy as np
import torch


def build_kernels(device: torch.device) -> None:
    """Build every missing kernel library of the package, all at once, into
    its build directory inside the checkout (``ops/_build.py``); on the
    CPU the package runs its plain twins and builds nothing."""
    if device.type != "cuda":
        return
    from ihgnn_torch.ops import _build
    _build.build()


def model_config(model: dict):
    from ihgnn_torch.config import ModelConfig
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    unknown = set(model) - fields
    if unknown:
        raise ValueError(f"not ModelConfig fields: {sorted(unknown)}")
    return ModelConfig(**model)


def build_graph(model: dict, sizes: dict, uqi: np.ndarray):
    """The CPU graph the configuration's layers read: the hypergraph for
    IHGNN and HGCN, the 2D graph for GCN and GAT (direct path)."""
    from ihgnn_torch.graph import build_graph2d, build_hypergraph
    cfg = model_config(model)
    n = sizes["users"] + sizes["queries"] + sizes["items"]
    if cfg.uses_hypergraph:
        return build_hypergraph(uqi, n, sizes["users"], sizes["queries"])
    return build_graph2d(uqi, n, sizes["users"], sizes["queries"],
                         cfg.graph_completeness)


def make_model(model: dict, sizes: dict, weights: Dict[str, torch.Tensor],
               device: torch.device):
    """``RawGnn`` on ``device`` holding ``weights`` (every parameter, by
    name)."""
    from ihgnn_torch.models.rawgnn import RawGnn
    net = RawGnn(model_config(model), sizes["users"], sizes["queries"],
                 sizes["items"], sizes["vocab"]).to(device)
    params = dict(net.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"parameters {sorted(set(params) ^ set(weights))} "
                         "are on one side only")
    with torch.no_grad():
        for name, p in params.items():
            if p.shape != weights[name].shape:
                raise ValueError(f"{name}: {tuple(p.shape)} against "
                                 f"{tuple(weights[name].shape)}")
            p.copy_(weights[name])
    return net


def make_train(net, graph, words, counts, train: dict, device):
    """``(optimizer, train_step)``: Adam as ``make_optimizer`` makes it and
    the step of ``make_train_step``."""
    from ihgnn_torch.config import TrainConfig
    from ihgnn_torch.train.train import make_optimizer, make_train_step
    tcfg = TrainConfig(learning_rate=train["learning_rate"],
                       weight_decay=train["weight_decay"])
    opt = make_optimizer(net.parameters(), tcfg)
    step = make_train_step(net, graph, words, counts, opt, device=device)
    return opt, step


def as_batch(b: dict):
    from ihgnn_torch.data.dataset import Batch
    return Batch(users=b["users"], queries=b["queries"], items=b["items"],
                 flags=b["flags"], weight=b["weight"])


def prefetch(it):
    from ihgnn_torch.data.dataset import prefetch as port_prefetch
    return port_prefetch(it)


def make_eval(net, graph, words, counts, device):
    from ihgnn_torch.train.eval import make_eval_fns
    return make_eval_fns(net, graph, words, counts, device=device)


@contextlib.contextmanager
def watch_scores(seen: Callable):
    """While open, every ``[B, I]`` score matrix that the eval path's
    ``metrics_fn`` hands to ``ranking_metrics`` is passed, with the
    batch's truth items, to ``seen(scores, truth)`` first."""
    from ihgnn_torch.train import eval as port_eval
    inner = port_eval.ranking_metrics

    def watched(scores, truth, counts, *args, **kw):
        seen(scores, truth)
        return inner(scores, truth, counts, *args, **kw)
    port_eval.ranking_metrics = watched
    try:
        yield
    finally:
        port_eval.ranking_metrics = inner


def zero_launches() -> None:
    from ihgnn_torch.ops.launches import zero_launches as zero
    zero()


def launch_counts() -> Dict[str, int]:
    from ihgnn_torch.ops.launches import launch_counts as counts
    return counts()
