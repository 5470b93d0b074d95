"""Convex solvers for the MATCHA schedule, in pure numpy/scipy.

Port of ``matcha_tpu/schedule/solvers.py`` (a numpy copy).

The reference solves two convex programs with cvxpy+CVXOPT
(the reference's graph_manager.py:240-296).  cvxpy is a heavyweight
dependency that is not needed: both problems have enough structure to solve
directly, which is also what makes 256+-node graphs tractable at setup time
(SURVEY.md §7 "CVX at setup for big graphs").

Problem 1 — activation probabilities (graph_manager.py:240-266):

    maximize    λ₁(L(p)) + λ₂(L(p)),   L(p) = Σ_j p_j L_j
    subject to  Σ_j p_j ≤ M·budget,    0 ≤ p ≤ 1

The objective (sum of the two smallest eigenvalues of a symmetric matrix,
``cp.lambda_sum_smallest(L, 2)`` in the reference) is *concave* in ``L`` and
``L`` is linear in ``p``, so this is a concave maximization over a box∩halfspace
polytope.  We use projected supergradient ascent: a supergradient of
``λ₁+λ₂`` at ``p`` is ``g_j = Σ_{i∈{1,2}} vᵢᵀ L_j vᵢ`` with ``vᵢ`` the
eigenvectors of the two smallest eigenvalues; the Euclidean projection onto
the feasible set has an exact O(M log M) form (waterfilling / clipped shift).

Problem 2 — mixing weight (graph_manager.py:268-296):

    minimize_{a,b,s}  s
    subject to  (1−s)I − 2a·E[L] − J + b(E[L]² + 2·Var[L]) ⪯ 0,
                a,b,s ≥ 0,  a² ≤ b

At the optimum ``b = a²`` (the constraint matrix is monotone in ``b`` through
a PSD coefficient), so the problem collapses to the 1-D convex minimization

    minimize_{a ≥ 0}  ρ(a) = λ_max( I − J − 2a·E[L] + a²(E[L]² + 2·Var[L]) )

— a pointwise maximum of convex quadratics in ``a`` — which we solve by
bounded scalar minimization (golden section via scipy) with an analytic
bracket.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Tuple

import numpy as np
import scipy.linalg
from scipy.optimize import minimize_scalar

from ..topology import expected_contraction_rate as contraction_rho

__all__ = [
    "project_box_capped_sum",
    "solve_activation_probabilities",
    "solve_mixing_weight",
    "contraction_rho",
]


def project_box_capped_sum(p: np.ndarray, cap: float) -> np.ndarray:
    """Euclidean projection of ``p`` onto ``{q : 0 ≤ q ≤ 1, Σq ≤ cap}``.

    If the clipped point already satisfies the sum constraint it is optimal;
    otherwise the KKT conditions give ``q = clip(p − τ, 0, 1)`` with ``τ > 0``
    chosen so ``Σq = cap`` — found by bisection (Σq is continuous and
    nonincreasing in τ).
    """
    q = np.clip(p, 0.0, 1.0)
    if q.sum() <= cap + 1e-12:
        return q
    lo, hi = 0.0, float(np.max(p))  # τ=hi ⇒ q=0 ⇒ sum 0 ≤ cap
    # clip(p − τ, 0, 1).sum() in a buffer: the same sums as np.clip's
    # without its per-call overhead (3000 calls of 100 steps a solve)
    buf = np.empty(np.shape(p), np.result_type(p, 0.0))
    for _ in range(100):
        tau = 0.5 * (lo + hi)
        np.subtract(p, tau, out=buf)
        np.maximum(buf, 0.0, out=buf)
        np.minimum(buf, 1.0, out=buf)
        s = np.add.reduce(buf)
        if s > cap:
            lo = tau
        else:
            hi = tau
    return np.clip(p - hi, 0.0, 1.0)


def _two_smallest_eigs(L: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    # only the bottom two eigenpairs are needed; LAPACK's range-restricted
    # routine (dsyevr) is ~2x full eigh at N=256 and grows with N
    w, V = scipy.linalg.eigh(L, subset_by_index=[0, 1])
    return w, V


#: solved activation probabilities by (Laplacians, budget, solver
#: settings): every ``train()`` of one graph and budget in a process solves
#: the same program, which takes a second or more of host time
_SOLVED: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
_SOLVED_MAX = 64
_SOLVED_LOCK = threading.Lock()


def solve_activation_probabilities(
    laplacians: np.ndarray,
    budget: float,
    iters: int = 3000,
    step: float | None = None,
    tol: float = 1e-7,
) -> np.ndarray:
    """Maximize λ₁+λ₂ of ``Σ p_j L_j`` s.t. ``Σp ≤ M·budget``, ``0 ≤ p ≤ 1``.

    Projected supergradient ascent with diminishing steps, returning the best
    feasible iterate.  Matches the reference's cvxpy formulation
    (graph_manager.py:240-266) including the final clamp to ``≤ 1``.  The
    solve is deterministic, so a repeated call returns a copy of the
    process's earlier answer.
    """
    laplacians = np.ascontiguousarray(laplacians)
    key = (laplacians.shape, laplacians.dtype.str,
           hashlib.sha256(memoryview(laplacians).cast("B")).hexdigest(),
           float(budget), int(iters), step, tol)
    with _SOLVED_LOCK:
        probs = _SOLVED.get(key)
        if probs is not None:
            _SOLVED.move_to_end(key)
            return probs.copy()
    probs = _solve_activation_probabilities(laplacians, budget, iters, step,
                                            tol)
    with _SOLVED_LOCK:
        _SOLVED[key] = probs
        while len(_SOLVED) > _SOLVED_MAX:
            _SOLVED.popitem(last=False)
    return probs.copy()


def _solve_activation_probabilities(laplacians, budget, iters, step, tol):
    M = laplacians.shape[0]
    cap = M * float(budget)
    if cap <= 0:
        return np.zeros(M)

    # warm start: uniform feasible point
    p = np.full(M, min(1.0, cap / M))
    if step is None:
        # scale steps by typical gradient magnitude (vᵀLv ≤ 2·max degree ≤ 2)
        step = 0.25

    n = laplacians.shape[1]
    Ls_flat = np.ascontiguousarray(laplacians.reshape(M, n * n))
    best_p, best_obj = p.copy(), -np.inf
    stall = 0
    for t in range(1, iters + 1):
        L = np.tensordot(p, laplacians, axes=1)
        w2, V2 = _two_smallest_eigs(L)
        obj = float(w2.sum())
        if obj > best_obj + tol:
            best_obj, best_p = obj, p.copy()
            stall = 0
        else:
            stall += 1
            if stall > 500:
                break
        # supergradient: g_j = Σ_i v_iᵀ L_j v_i = ⟨L_j, V₂V₂ᵀ⟩ over the two
        # smallest eigvecs — one [M, n²]·[n²] matvec, not a naive einsum
        P2 = (V2 @ V2.T).reshape(n * n)
        g = Ls_flat @ P2
        p = project_box_capped_sum(p + (step / np.sqrt(t)) * g, cap)

    return np.minimum(best_p, 1.0)




def solve_mixing_weight(
    laplacians: np.ndarray, probabilities: np.ndarray
) -> Tuple[float, float]:
    """Minimize the contraction bound ρ over the mixing weight α ≥ 0.

    Returns ``(alpha, rho)``.  Equivalent to the reference SDP
    (graph_manager.py:268-296) after eliminating ``b = a²`` and ``s = ρ(a)``.
    """
    p = np.asarray(probabilities, dtype=np.float64)
    mean_L = np.tensordot(p, laplacians, axes=1)
    lam_max = float(np.linalg.eigvalsh(mean_L)[-1])
    if lam_max <= 1e-12:
        # no expected communication at all: any α works, ρ = 1 (no contraction)
        return 0.0, 1.0
    # ρ(a) is convex; the minimizer lies in (0, 2/λ_max(E[L])) because beyond
    # that even the deterministic part I − 2aE[L] + a²E[L]² has λ ≥ 1.
    hi = 2.0 / lam_max
    res = minimize_scalar(
        lambda a: contraction_rho(laplacians, p, a),
        bounds=(0.0, hi),
        method="bounded",
        options={"xatol": 1e-10},
    )
    alpha = float(res.x)
    return alpha, float(res.fun)
