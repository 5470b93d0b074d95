"""Budget autotuner: sweep (topology, budget) candidates and rank them
offline.

A numpy copy of ``matcha_tpu/plan/autotune.py`` (:44-175), on the port's
``topology``, ``schedule.solvers`` and ``plan.cost``.  Each candidate runs
the setup training would run (matching decomposition → activation
probabilities → mixing weight) and is scored without a card:

    steps_to_target = log(target) / log(ρ)          (spectral.steps_to_consensus)
    step_seconds    = c₀ + c₁·E[hop units]          (cost.CostModel)
    score           = steps_to_target × step_seconds

the predicted wall-clock for the consensus error to contract by
``target``; lower is better, and ρ ≥ 1 scores ``inf``.  With
``mc_trials > 0`` each candidate also carries the Monte-Carlo rate of its
realized flag stream beside the bound.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

from ..schedule.solvers import (
    solve_activation_probabilities,
    solve_mixing_weight,
)
from ..topology import (
    decompose,
    graph_size,
    make_graph,
    matching_laplacians,
    select_graph,
)
from .artifact import PlanArtifact
from .cost import CostModel, expected_comm_units, matching_comm_units
from .spectral import simulate_consensus, steps_to_consensus

__all__ = ["resolve_topology", "plan_candidate", "sweep"]


def resolve_topology(spec: dict, seed: int):
    """``(decomposed, size, normalized_spec)`` of a topology spec:
    ``{"graphid": k}`` (a zoo graph, decomposed already) or
    ``{"topology": kind, "num_workers": n}`` (generated and decomposed under
    ``seed``), the two paths ``train.build_schedule`` takes."""
    if spec.get("graphid") is not None:
        gid = int(spec["graphid"])
        decomposed = select_graph(gid)
        size = graph_size(gid)
        return decomposed, size, {"graphid": gid, "topology": None,
                                  "num_workers": size}
    kind = spec["topology"]
    size = int(spec["num_workers"])
    edges = make_graph(kind, size, seed=seed)
    decomposed = decompose(edges, size, seed=seed)
    return decomposed, size, {"graphid": None, "topology": kind,
                              "num_workers": size}


def plan_candidate(
    decomposed: Sequence[Sequence[tuple]],
    size: int,
    budget: float,
    *,
    seed: int = 9001,
    target: float = 1e-3,
    num_chips: int = 1,
    cost_model: Optional[CostModel] = None,
    solver_iters: int = 3000,
    mc_trials: int = 0,
    mc_steps: int = 80,
    graph_spec: Optional[dict] = None,
    laplacians: Optional[np.ndarray] = None,
    unit_costs: Optional[np.ndarray] = None,
) -> dict:
    """Score one (topology, budget) point: the flat candidate dict the
    artifact stores.  ``laplacians`` and ``unit_costs`` depend only on the
    topology and ``num_chips``; ``sweep`` computes them once per
    topology."""
    if laplacians is None:
        laplacians = matching_laplacians(decomposed, size)
    if unit_costs is None:
        unit_costs = matching_comm_units(decomposed, size, num_chips)
    probs = solve_activation_probabilities(laplacians, budget,
                                           iters=solver_iters)
    alpha, rho = solve_mixing_weight(laplacians, probs)
    units = expected_comm_units(probs, unit_costs)
    steps = steps_to_consensus(rho, target)
    cm = cost_model or CostModel()
    step_s = cm.step_seconds(units)
    cand = {
        **(graph_spec or {"graphid": None, "topology": None,
                          "num_workers": size}),
        "matcha": True,
        "budget": float(budget),
        "seed": int(seed),
        "alpha": float(alpha),
        "probs": [float(p) for p in probs],
        "rho": float(rho),
        "expected_comm_fraction": float(np.mean(probs)),
        "expected_comm_units": float(units),
        "steps_to_target": None if math.isinf(steps) else float(steps),
        "predicted_step_s": float(step_s),
        "predicted_seconds_to_target":
            None if math.isinf(steps) else float(steps * step_s),
    }
    if mc_trials > 0:
        sim = simulate_consensus(decomposed, size, probs, alpha,
                                 steps=mc_steps, trials=mc_trials, seed=seed,
                                 laplacians=laplacians)
        cand["mc_empirical_rate"] = sim.empirical_rate()
        cand["mc_trials"] = int(mc_trials)
        cand["mc_steps"] = int(mc_steps)
    return cand


def _score(cand: dict) -> float:
    s = cand["predicted_seconds_to_target"]
    return math.inf if s is None else float(s)


def sweep(
    topologies: Sequence[dict],
    budgets: Sequence[float],
    *,
    seed: int = 9001,
    target: float = 1e-3,
    num_chips: int = 1,
    cost_model: Optional[CostModel] = None,
    solver_iters: int = 3000,
    mc_trials: int = 0,
    mc_steps: int = 80,
) -> PlanArtifact:
    """Score every (topology, budget) pair and return the ranked artifact:
    ``candidates`` best-first by predicted wall-clock to the target,
    ``chosen`` the first.  Ties (every budget of a one-card plan, where
    every hop unit is 0) break toward the smaller budget: the same
    predicted time for less link use."""
    cm = cost_model or CostModel()
    candidates = []
    for spec in topologies:
        decomposed, size, norm = resolve_topology(spec, seed)
        Ls = matching_laplacians(decomposed, size)
        unit_costs = matching_comm_units(decomposed, size, num_chips)
        for b in budgets:
            candidates.append(plan_candidate(
                decomposed, size, b, seed=seed, target=target,
                num_chips=num_chips, cost_model=cm,
                solver_iters=solver_iters, mc_trials=mc_trials,
                mc_steps=mc_steps, graph_spec=norm,
                laplacians=Ls, unit_costs=unit_costs,
            ))
    candidates.sort(key=lambda c: (_score(c), c["budget"]))
    if not candidates:
        raise ValueError("empty sweep: no topologies × budgets")
    return PlanArtifact(
        chosen=candidates[0],
        candidates=candidates,
        target_consensus=float(target),
        num_chips=int(num_chips),
        cost_model=cm.to_json(),
    )
