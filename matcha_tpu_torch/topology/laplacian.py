"""Laplacians, mixing matrices, and spectral utilities.

Port of ``matcha_tpu/topology/laplacian.py`` (a numpy copy).

Counterparts of ``GraphProcessor.graphToLaplacian``
(the reference's graph_manager.py:86-93) and the spectral math scattered
through ``FixedProcessor.getAlpha`` / ``MatchaProcessor.getAlpha``
(graph_manager.py:196-206, 268-296) — all pure numpy, host-side setup code.
The device-side contract only ever sees the *outputs* (alpha, permutations,
flags); none of this runs inside jit.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .graphs import Edge

__all__ = [
    "edge_laplacian",
    "matching_laplacians",
    "base_laplacian",
    "algebraic_connectivity",
    "spectral_gap_alpha",
    "mixing_matrix",
    "expected_contraction_rate",
]


def edge_laplacian(edges: Sequence[Edge], size: int) -> np.ndarray:
    """Dense graph Laplacian ``L = D - A`` over nodes ``0..size-1``."""
    L = np.zeros((size, size), dtype=np.float64)
    for (u, v) in edges:
        L[u, u] += 1.0
        L[v, v] += 1.0
        L[u, v] -= 1.0
        L[v, u] -= 1.0
    return L


def matching_laplacians(decomposed: Sequence[Sequence[Edge]], size: int) -> np.ndarray:
    """``f64[M, N, N]`` per-matching Laplacians (graph_manager.py:86-93)."""
    return np.stack([edge_laplacian(m, size) for m in decomposed], axis=0)


def base_laplacian(decomposed: Sequence[Sequence[Edge]], size: int) -> np.ndarray:
    return matching_laplacians(decomposed, size).sum(axis=0)


def algebraic_connectivity(L: np.ndarray) -> float:
    """λ₂ of a Laplacian (Fiedler value); 0 iff the graph is disconnected."""
    w = np.linalg.eigvalsh(L)
    return float(w[1])


def spectral_gap_alpha(L_base: np.ndarray) -> float:
    """Optimal uniform mixing weight for a *fixed* graph: ``2/(λ₂+λ_max)``.

    Closed form used by D-PSGD (reference ``FixedProcessor.getAlpha``,
    graph_manager.py:196-206): minimizes the spectral norm of
    ``I - αL - J`` over α for the deterministic topology.
    """
    w = np.linalg.eigvalsh(L_base)
    if len(w) < 2:
        raise ValueError("need at least 2 nodes")
    lam2, lam_max = float(w[1]), float(w[-1])
    if lam2 <= 1e-12:
        raise ValueError("base graph is disconnected (λ₂ = 0)")
    return 2.0 / (lam2 + lam_max)


def mixing_matrix(
    laplacians: np.ndarray, flags: np.ndarray, alpha: float
) -> np.ndarray:
    """Effective gossip matrix for one iteration: ``W = I - α·Σ_active L_j``.

    ``W`` is symmetric and doubly stochastic by construction; one gossip step
    is ``x ← W @ x`` (the dense-algebra oracle our device backends are tested
    against).
    """
    size = laplacians.shape[1]
    L_active = np.tensordot(np.asarray(flags, dtype=np.float64), laplacians, axes=1)
    return np.eye(size) - alpha * L_active


def expected_contraction_rate(
    laplacians: np.ndarray, probabilities: np.ndarray, alpha: float
) -> float:
    """Spectral bound ρ on E‖W x − x̄‖² / ‖x − x̄‖² under Bernoulli activation.

    ρ = λ_max( I − J − 2α·E[L] + α²(E[L]² + 2·Var[L]) ), the quantity the
    MATCHA SDP minimizes (graph_manager.py:268-296 / MATCHA paper Thm. 2).
    Convergence of decentralized SGD requires ρ < 1.
    """
    size = laplacians.shape[1]
    p = np.asarray(probabilities, dtype=np.float64)
    mean_L = np.tensordot(p, laplacians, axes=1)
    var_L = np.tensordot(p * (1.0 - p), laplacians, axes=1)
    J = np.full((size, size), 1.0 / size)
    M = np.eye(size) - J - 2.0 * alpha * mean_L + alpha**2 * (mean_L @ mean_L + 2.0 * var_L)
    return float(np.linalg.eigvalsh(M)[-1])
