"""A new budget mapped onto a committed flag stream.

A numpy copy of ``matcha_tpu/plan/swap.py`` (:37).  A run cannot re-sample
its flag stream mid-run without invalidating every checkpoint cursor; it
can re-weight it.  With committed probabilities ``p_old`` and executed
mixing weight ``α_base``, scaling matching ``j``'s flag row by
``row_scale[j] = p_new[j] / p_old[j]`` and the whole row by
``alpha_scale = α_new / α_base`` makes the expected executed Laplacian
weight ``α_new · p_new[j]``: the re-solved plan's first moment.  The
second moment differs (the firing times stay the committed draw).  A
matching the committed plan never activates (``p_old ≈ 0``) has no flags
to re-weight: its ``row_scale`` is 0 and the mass the re-solve puts on it
is reported as ``unreachable``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["resolve_budget_swap"]

# below this a committed probability never fires: re-weighting its row
# would divide by noise
_P_FLOOR = 1e-9


def resolve_budget_swap(schedule, budget: float,
                        iters: int = 3000) -> Dict:
    """Re-solve (p, α) at ``budget`` and express it as per-row scales.

    Returns ``{"budget", "probs", "alpha", "rho", "row_scale",
    "alpha_scale", "unreachable"}``; ``probs`` are the effective
    probabilities the committed stream can deliver.
    """
    if not 0 <= budget <= 1:
        raise ValueError(f"budget must be in [0, 1], got {budget}")
    from ..schedule import solve_activation_probabilities, solve_mixing_weight

    laplacians = schedule.laplacians()
    p_new = np.asarray(
        solve_activation_probabilities(laplacians, float(budget),
                                       iters=iters), np.float64)
    alpha_new, rho_new = solve_mixing_weight(laplacians, p_new)

    p_old = np.asarray(schedule.probs, np.float64)
    alive = p_old > _P_FLOOR
    row_scale = np.where(alive, p_new / np.where(alive, p_old, 1.0), 0.0)
    p_eff = np.where(alive, p_new, 0.0)
    unreachable = float(np.sum(p_new[~alive]))

    alpha_base = float(schedule.alpha)
    alpha_scale = (float(alpha_new) / alpha_base) if alpha_base else 1.0
    return {
        "budget": float(budget),
        "probs": p_eff,
        "alpha": float(alpha_new),
        "rho": float(rho_new),
        "row_scale": row_scale,
        "alpha_scale": float(alpha_scale),
        "unreachable": unreachable,
    }
