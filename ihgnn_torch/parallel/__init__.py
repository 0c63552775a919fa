"""Data parallelism over the edge axis with ``torch.distributed`` ranks
(counterpart of ``ihgnn_tpu/parallel``). Its ``shard_state`` and
``state_sharding`` have no counterpart: every rank holds the whole
train state, replicated (the tables over ``model`` are ROADMAP item 8c)."""

from ihgnn_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, Mesh,
                                       make_mesh, pick_backend)
from ihgnn_torch.parallel.sharding import (ShardedBag, pad_graph2d_for_mesh,
                                           pad_graph_for_mesh,
                                           pad_hypergraph_for_mesh,
                                           pad_log_hypergraph_for_mesh,
                                           round_up, shard_bag, shard_batch,
                                           shard_graph)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "ShardedBag", "make_mesh",
           "pad_graph2d_for_mesh", "pad_graph_for_mesh",
           "pad_hypergraph_for_mesh", "pad_log_hypergraph_for_mesh",
           "pick_backend", "round_up", "shard_bag", "shard_batch",
           "shard_graph"]
