"""Carry ``ihgnn_tpu`` RawGnn weights over to the port.

``params_from_jax`` maps the flax parameter tree that ``RawGnn.init``
produces, with its leaves as NumPy arrays, onto the port's ``state_dict``:

* ``embeddings/{user,item,vocab}_table`` ``[d, rows]`` → ``[rows, d]``;
* ``embeddings/query_mlp/dense`` (activation transform) →
  ``embeddings.query_mlp``;
* every ``{kernel [in, out], bias}`` Linear → ``weight = kernel.T``:
  ``gnn_k/feature_transform/dense`` (every layer type),
  ``gnn_k/interactor/aggregation/dense`` and
  ``gnn_k/phase2_transform/dense`` (IHGNN);
* the GAT score heads ``gnn_k/gat/feature_aggregate`` and
  ``gnn_k/phase2_gat/feature_aggregate`` (``kernel [score_in, 1]``) →
  ``gnns.k.{gat,phase2_gat}.feature_aggregate``;
* ``prediction/items_bias [I]``.

``layer_params_from_jax`` maps one layer's tree the same way.
``srrl_params_from_jax`` maps the tree of the JAX package's ``init_srrl``
onto the port's ``Srrl``: the row-major ``{KG,PS}/*_table`` as they are,
each ``<module>/.../dense/{kernel, bias}`` to ``<module>.....{weight =
kernel.T, bias}``, and ``prediction/items_bias`` (the HEM scorer) to
``prediction_layer.items_bias``.

A leaf of the tree that none of these maps raises ``KeyError``, so no
weight is silently left at its initial value. With it both packages
compute with the same weights.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

# layer subtrees (path below gnn_k) → the port's module (below gnns.k)
_LAYER_LINEARS = {
    ("feature_transform", "dense"): "feature_transform",
    ("interactor", "aggregation", "dense"): "interactor.aggregation",
    ("phase2_transform", "dense"): "phase2_transform",
    ("gat", "feature_aggregate"): "gat.feature_aggregate",
    ("phase2_gat", "feature_aggregate"): "phase2_gat.feature_aggregate",
}


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _leaves(tree: Mapping, prefix=()):
    for key, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (key,))
        else:
            yield prefix + (key,)


def _sub(tree: Mapping, path):
    for key in path:
        if not isinstance(tree, Mapping) or key not in tree:
            return None
        tree = tree[key]
    return tree


def _linear(sd: Dict[str, torch.Tensor], name: str, dense: Mapping) -> None:
    sd[f"{name}.weight"] = _t(dense["kernel"]).t().contiguous()
    sd[f"{name}.bias"] = _t(dense["bias"])


def _check_all_mapped(tree: Mapping, used, what: str) -> None:
    unmapped = sorted("/".join(leaf) for leaf in _leaves(tree)
                      if leaf not in used)
    if unmapped:
        raise KeyError(f"{what}: no port parameter for {unmapped}")


def layer_params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """The state_dict of one port layer (GCN, GAT, HGCN or IHGNN) from the
    flax param tree of the same layer."""
    sd: Dict[str, torch.Tensor] = {}
    used = set()
    for path, name in _LAYER_LINEARS.items():
        dense = _sub(tree, path)
        if dense is not None:
            _linear(sd, name, dense)
            used.update({path + ("kernel",), path + ("bias",)})
    _check_all_mapped(tree, used, "layer_params_from_jax")
    return sd


def params_from_jax(tree: Mapping,
                    table_rows: Optional[Mapping[str, int]] = None
                    ) -> Dict[str, torch.Tensor]:
    """The port's ``RawGnn`` state_dict from a flax RawGnn param tree
    (``{"params": ...}`` or its inner mapping).

    ``table_rows`` (``{"user": U + 1, "item": I + 1, "vocab": V + 1}``,
    e.g. ``RawGnn.table_rows``) maps a tree built with
    ``table_row_multiple`` > 1, whose tables carry zero rows past their
    logical rows (``ihgnn_tpu/models/embedding.py:90-96``, for the mesh's
    model axis): the port keeps its tables unpadded, so those rows are
    dropped (and must be zero)."""
    p = tree["params"] if "params" in tree else tree
    sd: Dict[str, torch.Tensor] = {}
    emb = p["embeddings"]
    for name in ("user", "item", "vocab"):
        table = _t(emb[f"{name}_table"]).t().contiguous()
        if table_rows is not None:
            rows = table_rows[name]
            if table.shape[0] < rows or torch.any(table[rows:] != 0):
                raise ValueError(f"params_from_jax: {name}_table has "
                                 f"{table.shape[0]} rows, not {rows} "
                                 "followed by zero padding")
            table = table[:rows].contiguous()
        sd[f"embeddings.{name}_table"] = table
    used = {(f"{name}_table",) for name in ("user", "item", "vocab")}
    if "query_mlp" in emb:
        _linear(sd, "embeddings.query_mlp", emb["query_mlp"]["dense"])
        used.update({("query_mlp", "dense", "kernel"),
                     ("query_mlp", "dense", "bias")})
    _check_all_mapped(emb, used, "params_from_jax: embeddings")
    k = 0
    while f"gnn_{k}" in p:
        for name, v in layer_params_from_jax(p[f"gnn_{k}"]).items():
            sd[f"gnns.{k}.{name}"] = v
        k += 1
    _check_all_mapped(p["prediction"], {("items_bias",)},
                      "params_from_jax: prediction")
    sd["prediction.items_bias"] = _t(p["prediction"]["items_bias"])
    others = set(p) - {"embeddings", "prediction"} - {f"gnn_{j}"
                                                      for j in range(k)}
    if others:
        raise KeyError(f"params_from_jax: no port module for {sorted(others)}")
    return sd


_SRRL_TABLES = {"KG": ("user_table", "item_table", "vocab_table"),
                "PS": ("user_table", "item_table")}


def srrl_params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """The port's ``Srrl`` state_dict from a flax Srrl param tree
    (``{"params": ...}`` or its inner mapping)."""
    p = tree["params"] if "params" in tree else tree
    sd: Dict[str, torch.Tensor] = {}
    used = set()
    for space, tables in _SRRL_TABLES.items():
        for table in tables:
            if table in p.get(space, {}):
                sd[f"{space}.{table}"] = _t(p[space][table])
                used.add((space, table))
    for leaf in _leaves(p):
        if leaf[-2:] == ("dense", "kernel"):
            dense = leaf[:-1]
            _linear(sd, ".".join(dense[:-1]), _sub(p, dense))
            used.update({dense + ("kernel",), dense + ("bias",)})
    if "prediction" in p:
        sd["prediction_layer.items_bias"] = _t(p["prediction"]["items_bias"])
        used.add(("prediction", "items_bias"))
    _check_all_mapped(p, used, "srrl_params_from_jax")
    return sd
