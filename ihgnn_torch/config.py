"""Typed configuration: the model knobs and the train/eval schedule.

Counterpart of ``ihgnn_tpu/config.py`` (``V``, ``ModelConfig`` and
``TrainConfig`` without the epoch count and seed of the run controller). Defaults are the reference's (Main.py:45-59):
``RawGnn`` over two IHGNN layers, d = 32, interaction order 3 in the first
layer and 1 after it, mean query transform, dot-product HEM head.
"""

from __future__ import annotations

import dataclasses


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
    # one hyperedge per whole search log = {u, q, positive items} instead of
    # one per interaction (Helpers/Graph.py:138-189); HGCN only (ragged
    # edges have no fixed-order feature interaction)
    use_log_hypergraph: bool = False

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
    # lr *= 0.98 whenever epoch avg loss < 0.008 while lr > 4e-4
    # (reference: Helpers/TrainTestHelper.py:155-159)
    adjust_learning_rate: bool = True
    lr_decay_factor: float = 0.98
    lr_decay_loss_threshold: float = 0.008
    lr_floor: float = 4e-4
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
