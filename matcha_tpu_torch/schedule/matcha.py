"""MATCHA schedule: budgeted random matching activation.

Port of ``matcha_tpu/schedule/matcha.py`` (a numpy copy).

Counterpart of the reference ``MatchaProcessor`` (graph_manager.py:228-309):
decompose the base graph into matchings, choose per-matching activation
probabilities that maximize expected algebraic connectivity under the
communication budget, choose the mixing weight α that minimizes the expected
consensus-contraction bound, then draw an i.i.d. Bernoulli activation-flag
stream.  All host-side; emits the static `Schedule` contract.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..topology import (
    matching_laplacians,
    matchings_to_perms,
    decompose as decompose_graph,
    union_edges,
    validate_decomposition,
)
from .base import Schedule, sample_flags
from .solvers import solve_activation_probabilities, solve_mixing_weight

__all__ = ["matcha_schedule"]


def matcha_schedule(
    decomposed: Sequence[Sequence[tuple]],
    size: int,
    iterations: int,
    budget: float = 0.5,
    seed: int = 0,
    redecompose: bool = False,
    decompose_method: str = "auto",
    solver_iters: int = 3000,
    flag_sampler: str = "numpy",
) -> Schedule:
    """Build a MATCHA schedule.

    ``redecompose=True`` reproduces the reference's training script, which
    re-decomposes the union of an already-decomposed zoo graph
    (train_mpi.py:73, SURVEY.md Q2) — here deterministic under ``seed``.
    """
    decomposed = [list(m) for m in decomposed]
    validate_decomposition(decomposed, size)
    if redecompose:
        decomposed = decompose_graph(
            union_edges(decomposed), size, method=decompose_method, seed=seed
        )

    laplacians = matching_laplacians(decomposed, size)
    probs = solve_activation_probabilities(laplacians, budget, iters=solver_iters)
    alpha, rho = solve_mixing_weight(laplacians, probs)
    if rho >= 1.0 - 1e-9 and budget > 0:
        # ρ ≥ 1 means the solver found no contraction — only possible when the
        # expected graph is disconnected (some p_j hit 0 on a cut edge).
        # Surface it: training would not reach consensus.
        import warnings

        warnings.warn(
            f"MATCHA schedule has expected contraction rho={rho:.4f} >= 1 "
            f"(budget={budget}); consensus will not converge. Raise the budget."
        )

    flags = sample_flags(probs, iterations, seed, sampler=flag_sampler)
    return Schedule(
        perms=matchings_to_perms(decomposed, size),
        alpha=float(alpha),
        probs=probs,
        flags=flags,
        decomposed=decomposed,
        name=f"matcha-b{budget}",
    )
