"""Data parallelism over the edge axis, and the embedding tables' rows
over the model axis, with ``torch.distributed`` ranks (counterpart of
``ihgnn_tpu/parallel``). Its ``shard_state`` / ``state_sharding`` are
``parallel/tables.py``: a rank holds the replicated parameters whole and
its block of each table and of the table's Adam moments."""

from ihgnn_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, Mesh,
                                       make_mesh, pick_backend)
from ihgnn_torch.parallel.sharding import (ShardedBag, pad_graph2d_for_mesh,
                                           pad_graph_for_mesh,
                                           pad_hypergraph_for_mesh,
                                           pad_log_hypergraph_for_mesh,
                                           round_up, shard_bag, shard_batch,
                                           shard_graph)
from ihgnn_torch.parallel.tables import (gather_optimizer_state,
                                         gather_params, shard_optimizer_state,
                                         shard_params, shard_tables)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "ShardedBag",
           "gather_optimizer_state", "gather_params", "make_mesh",
           "pad_graph2d_for_mesh", "pad_graph_for_mesh",
           "pad_hypergraph_for_mesh", "pad_log_hypergraph_for_mesh",
           "pick_backend", "round_up", "shard_bag", "shard_batch",
           "shard_graph", "shard_optimizer_state", "shard_params",
           "shard_tables"]
