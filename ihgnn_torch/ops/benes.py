"""Clos/Beneš routing of a static permutation through row-local stages:
the NumPy oracle of the native router (``csrc/routing.cc``).

Counterpart of ``ihgnn_tpu/ops/benes.py`` (``euler_split``,
``edge_color_regular_bipartite``, ``benes_route_rect``,
``apply_benes_rect``). Any permutation ``out[j] = in[perm[j]]`` of
E = R·C elements, viewed as an ``[R, C]`` row-major grid, factors as

    stage0: a0[r, c]  = in[r, p0[r, c]]      (p0: [R, C])
    T:      t0[k, r]  = a0[r, k]
    stage1: a1[k, r]  = t0[k, p1[k, r]]      (p1: [C, R])
    T:      t1[r, k]  = a1[k, r]
    stage2: out[r, c] = t1[r, p2[r, c]]      (p2: [R, C])

The demand multigraph between input rows and output rows is C-regular
bipartite, hence C-edge-colourable (König); colour classes give the middle
stage. The colouring is computed by recursive Euler splits, so C must be a
power of two. Pure NumPy and slow (a Python loop over every element): the
tests use it as the oracle, the pack uses the native router.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def euler_split(u: np.ndarray, v: np.ndarray, n_left: int, n_right: int
                ) -> np.ndarray:
    """Split a bipartite multigraph whose degrees are all even into two
    halves of equal degree at every vertex: the edges that Eulerian
    circuits traverse left → right. Returns the ``[E]`` mask of half A."""
    e_count = len(u)
    left_edges = [[] for _ in range(n_left)]
    right_edges = [[] for _ in range(n_right)]
    for e in range(e_count):
        left_edges[u[e]].append(e)
        right_edges[v[e]].append(e)
    left_ptr = [0] * n_left
    right_ptr = [0] * n_right
    used = np.zeros(e_count, bool)
    mask = np.zeros(e_count, bool)

    def next_unused(vertex, on_left):
        lst = left_edges[vertex] if on_left else right_edges[vertex]
        ptr = left_ptr if on_left else right_ptr
        while ptr[vertex] < len(lst):
            e = lst[ptr[vertex]]
            ptr[vertex] += 1
            if not used[e]:
                return e
        return -1

    for start in range(e_count):
        if used[start]:
            continue
        e = start
        at_left = True
        while e != -1 and not used[e]:
            used[e] = True
            mask[e] = at_left
            vertex = v[e] if at_left else u[e]
            at_left = not at_left
            e = next_unused(vertex, at_left)
    return mask


def edge_color_regular_bipartite(u: np.ndarray, v: np.ndarray, s: int,
                                 n_vertices: int) -> np.ndarray:
    """``[E]`` colours in ``[0, s)`` of an s-regular bipartite multigraph
    (s a power of two): at every vertex each colour appears once."""
    if s & (s - 1):
        raise ValueError(f"degree {s} is not a power of two")
    colors = np.zeros(len(u), np.int32)

    def recurse(edge_ids: np.ndarray, degree: int, base: int):
        if degree == 1:
            colors[edge_ids] = base
            return
        mask = euler_split(u[edge_ids], v[edge_ids], n_vertices, n_vertices)
        recurse(edge_ids[mask], degree // 2, base)
        recurse(edge_ids[~mask], degree // 2, base + degree // 2)

    recurse(np.arange(len(u)), s, 0)
    return colors


def benes_route_rect(perm: np.ndarray, rows: int, cols: int
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(p0 [R, C], p1 [C, R], p2 [R, C])`` of ``out[j] = in[perm[j]]``
    over E = rows·cols elements (see the module docstring); cols a power
    of two."""
    e_count = rows * cols
    perm = np.asarray(perm, np.int64)
    if perm.shape != (e_count,):
        raise ValueError(f"perm has shape {perm.shape}, not ({e_count},)")
    j = np.arange(e_count)
    out_row, out_col = j // cols, j % cols
    in_row, in_col = perm // cols, perm % cols
    color = edge_color_regular_bipartite(in_row, out_row, cols, rows)
    p0 = np.empty((rows, cols), np.int64)
    p0[in_row, color] = in_col
    p1 = np.empty((cols, rows), np.int64)
    p1[color, out_row] = in_row
    p2 = np.empty((rows, cols), np.int64)
    p2[out_row, out_col] = color
    return p0, p1, p2


def apply_benes_rect(x: np.ndarray, p0: np.ndarray, p1: np.ndarray,
                     p2: np.ndarray) -> np.ndarray:
    """Stage-by-stage execution of a routed permutation: ``x[perm]`` for
    ``x`` of ``[E, ...]`` rows."""
    rows, cols = p0.shape
    extra = [1] * (x.ndim - 1)
    grid = x.reshape(rows, cols, *x.shape[1:])
    a0 = np.take_along_axis(grid, p0.reshape(rows, cols, *extra), axis=1)
    t0 = np.swapaxes(a0, 0, 1)
    a1 = np.take_along_axis(t0, p1.reshape(cols, rows, *extra), axis=1)
    t1 = np.swapaxes(a1, 0, 1)
    out = np.take_along_axis(t1, p2.reshape(rows, cols, *extra), axis=1)
    return out.reshape(x.shape)
