"""Graph zoo and random-topology generators.

Port of ``matcha_tpu/topology/graphs.py`` (a numpy copy: the port imports
nothing of the JAX package).

The zoo reproduces the six benchmark topologies of the MATCHA reference
(the reference's ``util.py:275-342``) — the paper's Fig. 1(a), Fig. A.3(a-c),
Fig. 3(b) graphs and an 8-node ring — stored here as *data* (edge lists,
already decomposed into matchings) so that benchmark configurations are
reproducible one-for-one.  Beyond the zoo we provide parametric generators
(ring, torus, Erdős–Rényi, random geometric, hypercube, complete, star,
chain) so the framework scales to arbitrary worker counts (the reference is
hard-coded to 8/16 nodes).

Edges are ``(int, int)`` tuples over nodes ``0..n-1``.  A *matching* is a set
of edges in which no node appears twice; a *decomposed graph* is a
``list[list[edge]]`` whose union is the base graph and whose members are each
valid matchings (the format consumed by the scheduler).
"""

from __future__ import annotations

import itertools
from typing import List, Sequence, Tuple

import numpy as np

Edge = Tuple[int, int]
Matching = List[Edge]
DecomposedGraph = List[Matching]

# ---------------------------------------------------------------------------
# Zoo (reference parity; the reference's util.py:275-342)
# ---------------------------------------------------------------------------

_ZOO: dict[int, DecomposedGraph] = {
    # 8-node Erdős–Rényi graph, MATCHA paper Fig. 1(a); 5 matchings.
    0: [
        [(1, 5), (6, 7), (0, 4), (2, 3)],
        [(1, 7), (3, 6)],
        [(1, 0), (3, 7), (5, 6)],
        [(1, 2), (7, 0)],
        [(3, 1)],
    ],
    # 16-node geometric graph, paper Fig. A.3(a); 5 matchings.
    1: [
        [(4, 8), (6, 11), (7, 13), (0, 12), (5, 14), (10, 15), (2, 3), (1, 9)],
        [(11, 13), (14, 2), (5, 6), (15, 3), (10, 9)],
        [(11, 8), (2, 5), (13, 4), (14, 3), (0, 10)],
        [(11, 5), (15, 14), (13, 8)],
        [(2, 11)],
    ],
    # 16-node geometric graph, paper Fig. A.3(b); 10 matchings.
    2: [
        [(2, 7), (12, 15), (3, 13), (5, 6), (8, 0), (9, 4), (11, 14), (1, 10)],
        [(8, 6), (0, 11), (3, 2), (5, 4), (15, 14), (1, 9)],
        [(8, 3), (0, 6), (11, 2), (4, 1), (12, 14)],
        [(8, 11), (6, 3), (0, 5)],
        [(8, 2), (0, 3), (6, 7), (11, 12)],
        [(8, 5), (6, 4), (0, 2), (11, 7)],
        [(8, 15), (3, 7), (0, 4), (6, 2)],
        [(8, 14), (5, 3), (11, 6), (0, 9)],
        [(8, 7), (15, 11), (2, 5), (4, 3), (1, 0), (13, 6)],
        [(12, 8)],
    ],
    # 16-node geometric graph, paper Fig. A.3(c); 13 matchings.
    3: [
        [(3, 12), (4, 8), (1, 13), (5, 7), (9, 10), (11, 14), (6, 15), (0, 2)],
        [(7, 14), (2, 6), (5, 13), (8, 10), (1, 15), (0, 11), (3, 9), (4, 12)],
        [(2, 7), (3, 15), (9, 13), (6, 11), (4, 14), (10, 12), (1, 8), (0, 5)],
        [(5, 14), (1, 12), (13, 8), (9, 4), (2, 11), (7, 0)],
        [(5, 1), (14, 8), (13, 12), (10, 4), (6, 7)],
        [(5, 9), (14, 1), (13, 3), (8, 2), (11, 7)],
        [(5, 12), (14, 13), (1, 9), (8, 0)],
        [(5, 2), (14, 10), (1, 3), (9, 8), (13, 15)],
        [(5, 8), (14, 12), (1, 4), (13, 10)],
        [(5, 3), (14, 2), (9, 12), (1, 10), (13, 4)],
        [(5, 6), (14, 0), (8, 12), (1, 2)],
        [(5, 15), (9, 14)],
        [(11, 5)],
    ],
    # 16-node Erdős–Rényi graph, paper Fig. 3(b); 8 matchings.
    4: [
        [(2, 7), (3, 15), (13, 14), (8, 9), (1, 5), (0, 10), (6, 12), (4, 11)],
        [(12, 11), (5, 6), (14, 1), (9, 10), (15, 2), (8, 13)],
        [(12, 5), (11, 6), (1, 8), (9, 3), (2, 10)],
        [(12, 14), (11, 9), (5, 15), (0, 6), (1, 7)],
        [(12, 8), (5, 2), (11, 14), (1, 6)],
        [(12, 15), (13, 11), (10, 5), (3, 14)],
        [(12, 9)],
        [(0, 12)],
    ],
    # 8-node ring; 2 matchings (even edges / odd edges).
    5: [
        [(0, 1), (2, 3), (4, 5), (6, 7)],
        [(0, 7), (2, 1), (4, 3), (6, 5)],
    ],
}

ZOO_SIZES = {0: 8, 1: 16, 2: 16, 3: 16, 4: 16, 5: 8}


def select_graph(graph_id: int) -> DecomposedGraph:
    """Return a zoo graph as a pre-decomposed list of matchings.

    Parity with the reference's ``util.select_graph`` (util.py:275-342).
    """
    if graph_id not in _ZOO:
        raise KeyError(f"unknown graph id {graph_id}; zoo has {sorted(_ZOO)}")
    return [list(m) for m in _ZOO[graph_id]]


def graph_size(graph_id: int) -> int:
    return ZOO_SIZES[graph_id]


# ---------------------------------------------------------------------------
# Edge-list helpers
# ---------------------------------------------------------------------------

def union_edges(decomposed: Sequence[Sequence[Edge]]) -> List[Edge]:
    """Flatten a decomposed graph into a duplicate-free base edge list.

    Counterpart of ``GraphProcessor.getGraphFromSub``
    (the reference's graph_manager.py:51-55), without networkx.
    """
    seen = set()
    edges: List[Edge] = []
    for matching in decomposed:
        for (u, v) in matching:
            key = (min(u, v), max(u, v))
            if key not in seen:
                seen.add(key)
                edges.append(key)
    return edges


def num_nodes(edges: Sequence[Edge]) -> int:
    return 1 + max(max(u, v) for u, v in edges)


def validate_matching(matching: Sequence[Edge], size: int) -> None:
    """Raise ``ValueError`` unless ``matching`` is a valid matching.

    Mirrors the runtime checks in the reference's ``drawer``
    (graph_manager.py:157-180) and ``decomposition`` (graph_manager.py:106-111)
    — but raises instead of ``exit()``.
    """
    seen: set[int] = set()
    for (u, v) in matching:
        if u == v:
            raise ValueError(f"self-loop ({u},{v}) in matching")
        if not (0 <= u < size and 0 <= v < size):
            raise ValueError(f"edge ({u},{v}) out of range for size {size}")
        if u in seen or v in seen:
            raise ValueError(f"node reused in matching at edge ({u},{v})")
        seen.add(u)
        seen.add(v)


def validate_decomposition(
    decomposed: Sequence[Sequence[Edge]], size: int, base_edges: Sequence[Edge] | None = None
) -> None:
    """Check every member is a matching and (optionally) the union matches."""
    for matching in decomposed:
        validate_matching(matching, size)
    if base_edges is not None:
        want = {(min(u, v), max(u, v)) for u, v in base_edges}
        got = {(min(u, v), max(u, v)) for m in decomposed for u, v in m}
        if want != got:
            raise ValueError(
                f"decomposition edge set mismatch: missing={want - got}, extra={got - want}"
            )


def is_connected(edges: Sequence[Edge], size: int) -> bool:
    """Union-find connectivity over nodes 0..size-1."""
    parent = list(range(size))

    def find(a: int) -> int:
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for (u, v) in edges:
        parent[find(u)] = find(v)
    roots = {find(i) for i in range(size)}
    return len(roots) == 1


# ---------------------------------------------------------------------------
# Generators (beyond the reference zoo)
# ---------------------------------------------------------------------------

def ring_graph(n: int) -> List[Edge]:
    if n < 3:
        raise ValueError("ring needs n >= 3")
    return [(i, (i + 1) % n) for i in range(n)]


def chain_graph(n: int) -> List[Edge]:
    return [(i, i + 1) for i in range(n - 1)]


def complete_graph(n: int) -> List[Edge]:
    return [(i, j) for i in range(n) for j in range(i + 1, n)]


def star_graph(n: int) -> List[Edge]:
    return [(0, i) for i in range(1, n)]


def hypercube_graph(n: int) -> List[Edge]:
    if n & (n - 1):
        raise ValueError("hypercube needs n to be a power of two")
    edges = []
    d = n.bit_length() - 1
    for i in range(n):
        for b in range(d):
            j = i ^ (1 << b)
            if i < j:
                edges.append((i, j))
    return edges


def torus_graph(rows: int, cols: int) -> List[Edge]:
    """2-D torus (each node 4 neighbors); degenerate dims collapse to a ring."""
    edges = set()
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            for (dr, dc) in ((0, 1), (1, 0)):
                j = ((r + dr) % rows) * cols + (c + dc) % cols
                if i != j:
                    edges.add((min(i, j), max(i, j)))
    return sorted(edges)


def erdos_renyi_graph(n: int, p: float, seed: int = 0) -> List[Edge]:
    """Connected ER graph: sample G(n, p), retry with fresh draws until connected."""
    rng = np.random.default_rng(seed)
    for _ in range(1000):
        mask = rng.random((n, n)) < p
        edges = [(i, j) for i in range(n) for j in range(i + 1, n) if mask[i, j]]
        if edges and is_connected(edges, n):
            return edges
    raise RuntimeError(f"could not sample a connected ER({n},{p}) graph; raise p")


def random_geometric_graph(n: int, radius: float | None = None, seed: int = 0) -> List[Edge]:
    """Connected random geometric graph on the unit square."""
    rng = np.random.default_rng(seed)
    if radius is None:
        # standard connectivity threshold ~ sqrt(log n / (pi n)), padded.
        radius = 1.7 * float(np.sqrt(np.log(max(n, 2)) / (np.pi * n)))
    for _ in range(1000):
        pts = rng.random((n, 2))
        d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
        edges = [(i, j) for i in range(n) for j in range(i + 1, n) if d2[i, j] < radius**2]
        if edges and is_connected(edges, n):
            return edges
        radius *= 1.1
    raise RuntimeError("could not sample a connected geometric graph")


_GENERATORS = {
    "ring": lambda n, seed: ring_graph(n),
    "chain": lambda n, seed: chain_graph(n),
    "complete": lambda n, seed: complete_graph(n),
    "star": lambda n, seed: star_graph(n),
    "hypercube": lambda n, seed: hypercube_graph(n),
    "torus": lambda n, seed: torus_graph(*_torus_dims(n)),
    "erdos_renyi": lambda n, seed: erdos_renyi_graph(n, p=min(0.8, 2.5 * np.log(n) / n), seed=seed),
    "geometric": lambda n, seed: random_geometric_graph(n, seed=seed),
}


def _torus_dims(n: int) -> Tuple[int, int]:
    r = int(np.sqrt(n))
    while n % r:
        r -= 1
    return r, n // r


def make_graph(kind: str, n: int, seed: int = 0) -> List[Edge]:
    """Generate a named topology over ``n`` nodes."""
    if kind not in _GENERATORS:
        raise KeyError(f"unknown topology '{kind}'; have {sorted(_GENERATORS)}")
    return _GENERATORS[kind](n, seed)


def available_topologies() -> List[str]:
    return sorted(_GENERATORS)
