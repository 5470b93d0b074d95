"""The JAX package's native graph builder, in numpy and Python.

Port of ``matcha_tpu/native/src/matcha_native.cpp``: ``splitmix64`` and
``sample_flag_stream`` (:34-59), ``mg_edge_color`` (:68-218) and
``greedy_decompose`` (:226-293).  The JAX package runs these through its
C++ library whenever the library loads (``decompose(method="color" |
"greedy" | "auto")`` above 64 nodes, ``sample_flags(sampler="native")``);
the port imports nothing of that package, so it carries the same
algorithms, step for step, and gives the same matching ids, the same
number of matchings and the same flags.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ["greedy_decompose", "mg_edge_color", "sample_flag_stream",
           "splitmix64", "splitmix64_array"]

_MASK = (1 << 64) - 1


def splitmix64(x: int) -> int:
    """One splitmix64 output of the counter ``x`` (arithmetic mod 2⁶⁴)."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK
    return x ^ (x >> 31)


def splitmix64_array(x: np.ndarray) -> np.ndarray:
    """:func:`splitmix64` of every element of a ``uint64`` array
    (``np.uint64`` arithmetic wraps mod 2⁶⁴)."""
    x = np.asarray(x, dtype=np.uint64) + np.uint64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def sample_flag_stream(probs, iterations: int, seed: int) -> np.ndarray:
    """``uint8[iterations, M]``: flag (t, j) is 1 where the uniform
    ``(splitmix64(seed ^ splitmix64(t·M + j)) >> 11)·2⁻⁵³`` is below
    ``probs[j]`` (a NaN or negative probability clamped to 0, one above 1
    to 1).  Raises ``RuntimeError`` where the library returns an error (no
    matching, or a negative count)."""
    p = np.array(probs, dtype=np.float64).reshape(-1)
    m = p.shape[0]
    if iterations < 0 or m <= 0:
        raise RuntimeError("sample_flag_stream failed with code -1")
    p[np.isnan(p) | (p < 0.0)] = 0.0
    p[p > 1.0] = 1.0
    counter = np.arange(iterations * m, dtype=np.uint64)
    z = splitmix64_array(np.uint64(seed & _MASK) ^ splitmix64_array(counter))
    u = (z >> np.uint64(11)).astype(np.float64) * (1.0 / 9007199254740992.0)
    return (u.reshape(iterations, m) < p[None, :]).astype(np.uint8)


def _check_edges(n: int, edges) -> list:
    if n <= 0:
        raise RuntimeError("native decomposition failed with code -1")
    out = []
    for (u, v) in edges:
        u, v = int(u), int(v)
        if u < 0 or v < 0 or u >= n or v >= n or u == v:
            raise RuntimeError("native decomposition failed with code -2")
        out.append((u, v))
    return out


def mg_edge_color(n: int, edges: Sequence) -> tuple[np.ndarray, int]:
    """Misra–Gries edge colouring: ``(colors int32[E], used)``, where
    ``colors[e]`` is the matching of edge ``e`` and ``used`` is one more
    than the largest colour (at most Δ+1).  Raises ``RuntimeError`` with
    the library's code where it fails."""
    edges = _check_edges(n, edges)
    m = len(edges)
    deg = [0] * n
    for (u, v) in edges:
        deg[u] += 1
        deg[v] += 1
    palette = max(deg, default=0) + 1
    # at[u][c]: the partner of u on its edge of colour c, or -1
    at = [[-1] * palette for _ in range(n)]
    eid = {}
    for e, (u, v) in enumerate(edges):
        key = (u, v) if u < v else (v, u)
        if key in eid:
            raise RuntimeError("mg_edge_color failed with code -2")
        eid[key] = e
    ecol = [-1] * m

    def edge_id(u, v):
        return eid[(u, v) if u < v else (v, u)]

    def set_color(u, v, c):
        at[u][c] = v
        at[v][c] = u
        ecol[edge_id(u, v)] = c

    def clear_color(u, v, c):
        at[u][c] = -1
        at[v][c] = -1
        ecol[edge_id(u, v)] = -1

    def free_color(u):
        row = at[u]
        return row.index(-1) if -1 in row else -1

    for (u, v) in edges:
        # the maximal fan of u from v: each next member is a neighbour of u
        # over a coloured edge whose colour is free on the fan's tail, the
        # lowest such colour first
        at_u = at[u]
        fan = [v]
        in_fan = {v}
        grew = True
        while grew:
            grew = False
            tail = at[fan[-1]]
            for c in range(palette):
                w = at_u[c]
                if w >= 0 and w not in in_fan and tail[c] < 0:
                    fan.append(w)
                    in_fan.add(w)
                    grew = True
                    break
        c_free = free_color(u)
        d = free_color(fan[-1])
        if c_free < 0 or d < 0:
            raise RuntimeError("mg_edge_color failed with code -3")
        # invert the (d, c_free) path from u: collect first, flip after
        if c_free != d:
            path = []
            a, cur = u, d
            while True:
                b = at[a][cur]
                if b < 0:
                    break
                path.append((a, b, cur))
                a = b
                cur = c_free if cur == d else d
            for (a, b, c) in path:
                clear_color(a, b, c)
            for (a, b, c) in path:
                set_color(a, b, c_free if c == d else d)
        # the longest prefix of the fan that is still a fan, whose tip has d
        # free
        w_idx = -1
        for i in range(len(fan) - 1, -1, -1):
            if at[fan[i]][d] < 0:
                ok = True
                for k in range(1, i + 1):
                    ck = ecol[edge_id(u, fan[k])]
                    if ck < 0 or at[fan[k - 1]][ck] >= 0:
                        ok = False
                        break
                if ok:
                    w_idx = i
                    break
        if w_idx < 0:
            raise RuntimeError("mg_edge_color failed with code -4")
        # rotate the prefix: each fan edge takes the next one's colour
        for k in range(w_idx):
            ck1 = ecol[edge_id(u, fan[k + 1])]
            clear_color(u, fan[k + 1], ck1)
            set_color(u, fan[k], ck1)
        set_color(u, fan[w_idx], d)

    if any(c < 0 for c in ecol):
        raise RuntimeError("mg_edge_color failed with code -5")
    colors = np.asarray(ecol, dtype=np.int32)
    return colors, (int(colors.max()) + 1 if m else 0)


def greedy_decompose(n: int, edges: Sequence,
                     seed: int) -> tuple[np.ndarray, int]:
    """Degree-descending greedy maximal matchings with a splitmix64-seeded
    tie-break: ``(matching_id int32[E], passes)``.  Raises
    ``RuntimeError`` with the library's code where it fails."""
    edges = _check_edges(n, edges)
    m = len(edges)
    adj = [[] for _ in range(n)]  # (neighbour, edge) in edge order
    for e, (u, v) in enumerate(edges):
        adj[u].append((v, e))
        adj[v].append((u, e))
    mid = [-1] * m
    seed &= _MASK
    tie = list(range(n))
    for i in range(n - 1, 0, -1):
        j = splitmix64(seed ^ splitmix64(i)) % (i + 1)
        tie[i], tie[j] = tie[j], tie[i]
    remaining, passes = m, 0
    while remaining > 0:
        deg = [sum(1 for (_, e) in adj[i] if mid[e] < 0) for i in range(n)]
        order = sorted(range(n), key=lambda i: (-deg[i], tie[i]))
        used = [False] * n
        matched = 0
        for u in order:
            if used[u] or deg[u] == 0:
                continue
            best, best_e = -1, -1
            for (w, e) in adj[u]:
                if mid[e] >= 0 or used[w]:
                    continue
                if (best < 0 or deg[w] > deg[best]
                        or (deg[w] == deg[best] and tie[w] > tie[best])):
                    best, best_e = w, e
            if best < 0:
                continue
            mid[best_e] = passes
            used[u] = used[best] = True
            matched += 1
        if matched == 0:
            raise RuntimeError("greedy_decompose failed with code -3")
        remaining -= matched
        passes += 1
    return np.asarray(mid, dtype=np.int32), passes
