"""Matching decomposition of a base communication graph.

Port of ``matcha_tpu/topology/decompose.py``.  The JAX package hands
``color`` and ``greedy`` to its native C++ library; the port runs the same
algorithms in Python (``native_np``), so a graph gets the matchings the
JAX package gives it when its library loads.

``color`` (the default above 64 nodes)
    Misra–Gries edge colouring: at most Δ+1 matchings.

``decompose_extract``
    Repeatedly pull a *maximum-cardinality* matching out of the remaining
    graph (networkx blossom algorithm, imported on first use).

``greedy``
    Degree-descending greedy maximal matchings with a splitmix64-seeded
    tie-break (``decompose_greedy`` is the JAX package's Python twin, which
    it runs only without its library).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from . import native_np
from .graphs import DecomposedGraph, Edge, validate_decomposition

__all__ = [
    "decompose",
    "decompose_extract",
    "decompose_greedy",
    "matchings_to_perms",
    "perms_to_neighbors",
]

def _dedup(edges: Sequence[Edge]) -> List[Edge]:
    seen, out = set(), []
    for (u, v) in edges:
        if u == v:
            raise ValueError(f"self-loop ({u},{v}) in base graph")
        key = (min(u, v), max(u, v))
        if key in seen:
            raise ValueError(f"duplicate edge ({u},{v}) in base graph")
        seen.add(key)
        out.append(key)
    return out


def decompose_greedy(edges: Sequence[Edge], size: int, seed: int = 0) -> DecomposedGraph:
    """Greedy maximal-matching decomposition, highest-degree nodes first.

    Same capability as the reference's ``decomposition``
    (graph_manager.py:95-154).
    """
    edges = _dedup(edges)
    adj: List[set] = [set() for _ in range(size)]
    for (u, v) in edges:
        adj[u].add(v)
        adj[v].add(u)

    rng = np.random.default_rng(seed)
    matchings: DecomposedGraph = []
    remaining = sum(len(a) for a in adj) // 2
    while remaining:
        deg = np.array([len(a) for a in adj])
        # stable order: degree descending, ties broken by a seeded permutation
        tie = rng.permutation(size)
        order = sorted(range(size), key=lambda i: (-deg[i], tie[i]))
        used = np.zeros(size, dtype=bool)
        matching: List[Edge] = []
        for u in order:
            if used[u] or not adj[u]:
                continue
            # partner = unmatched neighbor of highest degree
            cands = [v for v in adj[u] if not used[v]]
            if not cands:
                continue
            v = max(cands, key=lambda w: (len(adj[w]), -tie[w]))
            matching.append((min(u, v), max(u, v)))
            used[u] = used[v] = True
            adj[u].discard(v)
            adj[v].discard(u)
            remaining -= 1
        if not matching:  # pragma: no cover - cannot happen on a simple graph
            raise RuntimeError("greedy decomposition stalled")
        matchings.append(matching)
    validate_decomposition(matchings, size, base_edges=edges)
    return matchings


def decompose_extract(edges: Sequence[Edge], size: int, seed: int = 0) -> DecomposedGraph:
    """Repeated maximum-cardinality matching extraction (blossom algorithm)."""
    import networkx as nx

    edges = _dedup(edges)
    rng = np.random.default_rng(seed)
    G = nx.Graph()
    G.add_nodes_from(range(size))
    G.add_edges_from(edges)

    matchings: DecomposedGraph = []
    while G.number_of_edges():
        # seeded edge-order perturbation so tie-breaking is reproducible
        elist = list(G.edges)
        rng.shuffle(elist)
        H = nx.Graph()
        H.add_nodes_from(range(size))
        H.add_edges_from(elist)
        M = nx.max_weight_matching(H, maxcardinality=True)
        matching = sorted((min(u, v), max(u, v)) for (u, v) in M)
        G.remove_edges_from(matching)
        matchings.append(matching)
    validate_decomposition(matchings, size, base_edges=edges)
    return matchings


def decompose(
    edges: Sequence[Edge], size: int, method: str = "auto", seed: int = 0
) -> DecomposedGraph:
    """Decompose a base graph into matchings.

    ``method``:
      * ``"extract"`` — repeated maximum matchings (blossom); few matchings
                        but slow on large graphs.
      * ``"greedy"``  — degree-descending greedy passes, seeded by
                        splitmix64 (``native_np.greedy_decompose``).
      * ``"color"``   — Misra–Gries edge coloring, ≤ Δ+1 matchings
                        (``native_np.mg_edge_color``).
      * ``"auto"``    — extract for small graphs, color for large ones.

    ``color`` and ``greedy`` return what the JAX package's native library
    returns; where that library reports a failure, the JAX package falls
    back to :func:`decompose_greedy`, and so does the port.
    """
    if method == "auto":
        method = "extract" if size <= 64 else "color"
    if method == "extract":
        return decompose_extract(edges, size, seed)
    if method not in ("color", "greedy"):
        raise KeyError(f"unknown decomposition method '{method}'")
    if method == "color":
        edges = _dedup(edges)
    try:
        ids, count = (native_np.mg_edge_color(size, edges)
                      if method == "color"
                      else native_np.greedy_decompose(size, edges, seed))
    except RuntimeError:
        return decompose_greedy(edges, size, seed)
    result = _groups(edges, ids, count)
    validate_decomposition(result, size, base_edges=_dedup(edges))
    return result


def _groups(edges, ids, count: int) -> DecomposedGraph:
    """Edges grouped by matching id, each group sorted, empty ids dropped
    (the JAX package's ``native._groups``)."""
    out: DecomposedGraph = [[] for _ in range(count)]
    for (u, v), j in zip(edges, ids):
        out[int(j)].append((min(u, v), max(u, v)))
    return [sorted(g) for g in out if g]


# ---------------------------------------------------------------------------
# Compile-time contract helpers
# ---------------------------------------------------------------------------

def matchings_to_perms(decomposed: Sequence[Sequence[Edge]], size: int) -> np.ndarray:
    """``int32[M, N]`` permutations: ``perms[j, i]`` = i's partner in matching j,
    or ``i`` itself if unmatched.

    This is the involution form of the reference's ``drawer`` neighbor table
    (graph_manager.py:157-180, with -1 sentinels replaced by fixed points so
    each row is a genuine involution usable directly as a ``ppermute``/gather
    index map).
    """
    perms = np.tile(np.arange(size, dtype=np.int32), (len(decomposed), 1))
    for j, matching in enumerate(decomposed):
        for (u, v) in matching:
            if perms[j, u] != u or perms[j, v] != v:
                raise ValueError(f"matching {j} reuses a node at edge ({u},{v})")
            perms[j, u] = v
            perms[j, v] = u
    return perms


def perms_to_neighbors(perms: np.ndarray) -> np.ndarray:
    """Back-convert to the reference's ``neighbors_info`` convention
    (partner rank or -1) for parity tests and logging."""
    neighbors = perms.astype(np.int64).copy()
    fixed = neighbors == np.arange(perms.shape[1])[None, :]
    neighbors[fixed] = -1
    return neighbors
