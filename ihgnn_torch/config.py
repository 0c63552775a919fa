"""Typed configuration and the command line of ``python -m ihgnn_torch.cli``.

Counterpart of ``ihgnn_tpu/config.py``: the same frozen dataclass tree
(``ModelConfig``, ``TrainConfig``, ``MeshConfig``, ``RuntimeConfig``,
``IOConfig`` under ``Config``) and ``parse_args`` with the same flags,
aliases and defaults (the reference's surface, Helpers/ArgsParser.py:52-95).
Defaults are the reference's (Main.py:45-59): ``RawGnn`` over two IHGNN
layers, d = 32, interaction order 3 in the first layer and 1 after it,
mean query transform, dot-product HEM head.

The fields of the port's own are ``RuntimeConfig.device`` (``--device``,
default ``cuda``), the counterpart of the JAX package's platform choice,
and ``RuntimeConfig.run_record`` (``--run_record DIR``: each rank's
record of the run). Every knob of the JAX package runs, the mesh's model
axis and ``--multihost`` among them.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional


class V:
    """Enumerated string values (reference: Helpers/GlobalSettings.py:4-16)."""

    MEAN = "mean"
    ACTIVATION = "activation"

    CONCAT = "concatenation"
    PRODUCT = "product"

    GRAPH_UQI = "uqi"
    GRAPH_ONLY_UQ = "uq"
    GRAPH_ONLY_UI = "ui"
    GRAPH_ONLY_QI = "qi"

    RAWGNN = "rawgnn"
    SRRL = "srrl"

    GCN = "gcn"
    GAT = "gat"
    HGCN = "hgcn"
    IHGNN = "ihgnn"


GNN_LAYER_NAMES = (V.GCN, V.GAT, V.HGCN, V.IHGNN)
MODEL_NAMES = (V.RAWGNN, V.SRRL)
COMPLETENESS_VALUES = (V.GRAPH_UQI, V.GRAPH_ONLY_UQ, V.GRAPH_ONLY_UI,
                       V.GRAPH_ONLY_QI)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Model architecture knobs (reference defaults: Main.py:45-59)."""

    model: str = V.RAWGNN
    gnn: str = V.IHGNN
    gnn_layer_count: int = 2              # Main.py:55
    embedding_size: int = 32              # GlobalSettings.py:30
    feature_interaction_order: int = 3    # Main.py:56; layers >0 forced to 1
    phase2_attention: bool = False        # Main.py:57
    graph_completeness: str = V.GRAPH_UQI
    lambda_muq: float = 0.5               # GlobalSettings.py:23
    use_cosine_similarity: bool = False   # GlobalSettings.py:78-81
    query_transform: str = V.MEAN         # GlobalSettings.py:68-76
    gat_head: str = V.CONCAT              # GlobalSettings.py:59-66
    # Srrl knobs (GlobalSettings.py:87-91)
    srrl_kg_loss: bool = True
    srrl_uni_weight: bool = False
    srrl_regularization: float = 0.0
    # one hyperedge per whole search log = {u, q, positive items} instead of
    # one per interaction (Helpers/Graph.py:138-189); HGCN only (ragged
    # edges have no fixed-order feature interaction)
    use_log_hypergraph: bool = False
    # recompute each GNN layer in the backward pass (torch.utils.checkpoint)
    remat: bool = False
    # bf16 edge streams with f32 accumulation (models/layers.py; the direct
    # path and the routed pack)
    bf16_stream: bool = False

    @property
    def output_feature_size(self) -> int:
        """Width of the concat [X0, X1, ..., XL] (Models/RawGnn.py:49)."""
        return self.embedding_size * (1 + self.gnn_layer_count)

    @property
    def uses_hypergraph(self) -> bool:
        return self.gnn in (V.HGCN, V.IHGNN)

    def layer_order(self, layer: int) -> int:
        """Interaction order of IHGNN layer ``layer`` (RawGnn.py:76-78)."""
        o = self.feature_interaction_order
        return 1 if (o > 1 and layer > 0) else o


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimisation and evaluation schedule (reference:
    GlobalSettings.py:26-41, Main.py:27-31)."""

    batch_size: int = 100                 # positives per step
    learning_rate: float = 1e-3
    weight_decay: float = 0.0
    random_negative_sample_size: int = 10
    non_random_negative_sample_size: int = 0
    epoch_count: int = 110
    # lr *= 0.98 whenever epoch avg loss < 0.008 while lr > 4e-4
    # (reference: Helpers/TrainTestHelper.py:155-159)
    adjust_learning_rate: bool = True
    lr_decay_factor: float = 0.98
    lr_decay_loss_threshold: float = 0.008
    lr_floor: float = 4e-4
    seed: int = 0
    # gradient accumulation over k batches per optimizer step
    # (the reference's Gs.batch_size_times, TrainTestHelper.py:137-143)
    grad_accum_steps: int = 1
    epoch_start_test: int = 10
    epoch_test_frequency: int = 10
    use_valid_dataset: bool = True
    # logs scored against the whole catalog per batch
    eval_batch_size: int = 256

    @property
    def negative_sample_size(self) -> int:
        return (self.random_negative_sample_size
                + self.non_random_negative_sample_size)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device mesh shape: the data axis shards the batch and the
    hyperedges (one rank a slice, ``ihgnn_torch/parallel``), the model
    axis the embedding tables' rows and their Adam moments
    (``parallel/tables.py``)."""

    data: int = 1
    model: int = 1

    @property
    def device_count(self) -> int:
        return self.data * self.model


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    dtype: str = "float32"           # compute dtype for features
    param_dtype: str = "float32"
    # False strips a routed kernel pack from the graph (--no_pallas); the
    # port's default graph carries none
    use_pallas: bool = True
    user_history_limit: int = 500    # GlobalSettings.py:93-96
    profile_dir: Optional[str] = None
    multihost: bool = False
    # per-epoch embedding/layer statistics (Gs.Debug
    # show_highorder_embedding_info, GlobalSettings.py:98-108)
    debug_stats: bool = False
    # where the run computes: "cuda" (the card; raises without one) or
    # "cpu"
    device: str = "cuda"
    # a directory where each rank writes a record of its run at the end
    # (rank<r>.json: kernel launches, epoch stats, test metrics), or None
    run_record: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class IOConfig:
    data_dir: str = ""               # directory with graph_info.txt etc.
    result_dir: str = "Results"
    checkpoint: str = ""             # '' | 'latest' | explicit name
    store_checkpoint: bool = False
    store_metrics: bool = False
    long_tail_filename: str = ""


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    runtime: RuntimeConfig = dataclasses.field(default_factory=RuntimeConfig)
    io: IOConfig = dataclasses.field(default_factory=IOConfig)

    def validate(self) -> "Config":
        m, t = self.model, self.train
        if m.model not in MODEL_NAMES:
            raise ValueError(f"unknown model {m.model!r}; expected one of "
                             f"{MODEL_NAMES}")
        if m.gnn not in GNN_LAYER_NAMES:
            raise ValueError(f"unknown gnn {m.gnn!r}; expected one of "
                             f"{GNN_LAYER_NAMES}")
        if m.feature_interaction_order not in (1, 2, 3):
            raise ValueError("feature_interaction_order must be 1, 2 or 3")
        if m.graph_completeness not in COMPLETENESS_VALUES:
            raise ValueError(f"graph_completeness must be one of "
                             f"{COMPLETENESS_VALUES}")
        if m.gnn_layer_count < 0:
            raise ValueError("gnn_layer_count must be >= 0")
        if t.batch_size <= 0:
            raise ValueError("batch_size must be positive")
        return self


def _canon_model(name: str) -> str:
    return name.strip().lower()


def _canon_gnn(name: str) -> str:
    n = name.strip().lower()
    if n.endswith("layer"):
        n = n[: -len("layer")]
    return n


def parse_args(argv=None) -> Config:
    """The JAX package's flags (``ihgnn_tpu/config.py`` ``parse_args``:
    the reference's surface plus its own knobs), with their aliases and
    defaults, and ``--device``."""
    p = argparse.ArgumentParser(prog="ihgnn-torch")
    p.add_argument("--checkpoint", "--cp", default="", type=str,
                   help="checkpoint name to load, or 'latest', or '' for "
                        "none")
    p.add_argument("--storecheckpoint", "--scp", "-c", action="store_true",
                   default=False)
    p.add_argument("--storemetrics", "--sm", "-m", action="store_true",
                   default=False)
    p.add_argument("--epoch_count", "--ec", type=int, default=0)
    p.add_argument("--epoch_start_test", "--est", type=int, default=0)
    p.add_argument("--epoch_test_frequency", "--etf", type=int, default=0)
    p.add_argument("--dataset", "--ds", type=str, default="",
                   help="directory containing graph_info.txt / *_data.csv")
    p.add_argument("--model", type=str, default="")
    p.add_argument("--gnn", type=str, default="")
    p.add_argument("--gnns", type=int, default=0)
    p.add_argument("--feature_order", "--fo", type=int, default=0)
    p.add_argument("--phase2_attention", action="store_true", default=False)
    p.add_argument("--completeness", type=str, default=V.GRAPH_UQI)
    p.add_argument("--longtail", type=str, default="")
    p.add_argument("--embedding_size", "--emb", type=int, default=0)
    p.add_argument("--batch_size", "--bs", type=int, default=0)
    p.add_argument("--learning_rate", "--lr", type=float, default=0.0)
    p.add_argument("--grad_accum", type=int, default=1)
    p.add_argument("--neg_random", type=int, default=-1)
    p.add_argument("--neg_nonrandom", type=int, default=-1)
    p.add_argument("--epochs", type=int, default=0,
                   help="alias of --epoch_count")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--result_dir", type=str, default="Results")
    p.add_argument("--log_hypergraph", action="store_true", default=False,
                   help="one hyperedge per search log (HGCN only)")
    p.add_argument("--remat", action="store_true", default=False,
                   help="recompute GNN layers in backward")
    p.add_argument("--bf16_stream", action="store_true", default=False,
                   help="bf16 hyperedge streams")
    p.add_argument("--mesh_data", type=int, default=1)
    p.add_argument("--mesh_model", type=int, default=1)
    p.add_argument("--multihost", action="store_true", default=False,
                   help="one process group across hosts (torchrun "
                        "--nnodes on each host)")
    p.add_argument("--no_pallas", action="store_true", default=False,
                   help="strip a routed kernel pack from the graph")
    p.add_argument("--debug_stats", action="store_true", default=False,
                   help="print per-epoch embedding/layer statistics "
                        "(Gs.Debug equivalent)")
    p.add_argument("--no_valid", action="store_true", default=False)
    p.add_argument("--eval_batch_size", type=int, default=256)
    p.add_argument("--profile_dir", type=str, default="")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (the default; raises without a card) or "
                        "'cpu'")
    p.add_argument("--run_record", type=str, default="",
                   help="write each rank's record of the run (kernel "
                        "launches, epoch stats, test metrics) to "
                        "DIR/rank<r>.json")
    a = p.parse_args(argv)

    base = Config()
    model = dataclasses.replace(
        base.model,
        model=_canon_model(a.model) or base.model.model,
        gnn=_canon_gnn(a.gnn) or base.model.gnn,
        gnn_layer_count=a.gnns or base.model.gnn_layer_count,
        embedding_size=a.embedding_size or base.model.embedding_size,
        feature_interaction_order=(a.feature_order
                                   or base.model.feature_interaction_order),
        phase2_attention=a.phase2_attention,
        graph_completeness=a.completeness,
        use_log_hypergraph=a.log_hypergraph,
        remat=a.remat,
        bf16_stream=a.bf16_stream,
    )
    train = dataclasses.replace(
        base.train,
        batch_size=a.batch_size or base.train.batch_size,
        learning_rate=a.learning_rate or base.train.learning_rate,
        epoch_count=a.epoch_count or a.epochs or base.train.epoch_count,
        epoch_start_test=a.epoch_start_test or base.train.epoch_start_test,
        epoch_test_frequency=(a.epoch_test_frequency or a.epoch_start_test
                              or base.train.epoch_test_frequency),
        random_negative_sample_size=(
            a.neg_random if a.neg_random >= 0
            else base.train.random_negative_sample_size),
        non_random_negative_sample_size=(
            a.neg_nonrandom if a.neg_nonrandom >= 0
            else base.train.non_random_negative_sample_size),
        use_valid_dataset=not a.no_valid,
        seed=a.seed,
        grad_accum_steps=max(a.grad_accum, 1),
        eval_batch_size=a.eval_batch_size,
    )
    mesh = MeshConfig(data=a.mesh_data, model=a.mesh_model)
    runtime = dataclasses.replace(
        base.runtime,
        use_pallas=not a.no_pallas,
        profile_dir=a.profile_dir or None,
        multihost=a.multihost,
        debug_stats=a.debug_stats,
        device=a.device,
        run_record=a.run_record or None,
    )
    io = IOConfig(
        data_dir=a.dataset,
        result_dir=a.result_dir,
        checkpoint=a.checkpoint,
        store_checkpoint=a.storecheckpoint,
        store_metrics=a.storemetrics,
        long_tail_filename=a.longtail,
    )
    return Config(model=model, train=train, mesh=mesh, runtime=runtime,
                  io=io).validate()
