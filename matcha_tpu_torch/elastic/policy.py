"""Offline elasticity-policy scoring: pick the churn response before churn.

A numpy copy of ``matcha_tpu/elastic/policy.py`` (:36-265), on the port's
``elastic.membership``, ``schedule.base.refold_mixing`` and
``plan.spectral``.  Two knobs decide how a run answers churn:

* re-plan eagerly or with hysteresis K (``membership_hysteresis``):
  re-deriving α at every change keeps the mixing right for the live set,
  but under flapping each re-plan buys little; a fold deferred until the
  membership holds still for K epochs runs a slightly wrong α meanwhile;
* bootstrap from the mean or restore a rejoiner's own rows
  (``membership_bootstrap``): restoring keeps real training state but
  re-injects the departure-time disagreement; the mean starts at
  consensus and drops the worker's history.

``score_elasticity_policies`` plays a :class:`MembershipTrace` against
every combination with the flag-stream simulator the planner uses
(``schedule.base.sample_flags``), applying the realized masked mixing
``W_t = I − α_e·Σ_j flag_j·L_j^masked`` to random worker vectors: frozen
rows ride identity self-loops as the masked gossip realizes them, joins
bootstrap per policy, and the live set's consensus error is tracked per
epoch.  ``elasticity_artifact`` wraps the result as a
``matcha_tpu.plan/1`` artifact that ``planlint`` verifies.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from .membership import MembershipTrace

__all__ = ["score_elasticity_policies", "elasticity_artifact"]


def _policy_grid(hysteresis: Sequence[int]) -> List[Dict]:
    out = []
    for h in hysteresis:
        for bootstrap in ("mean", "restore"):
            out.append({"hysteresis": int(h), "bootstrap": bootstrap,
                        "replan": "eager" if h == 0 else f"hysteresis-{h}"})
    return out


def _replay_occupancy(trace: MembershipTrace, size: int, epochs: int):
    """Per-epoch (alive, joined, restored, eventful) from the trace, by the
    replay the controller performs.  ``eventful`` marks a boundary with
    declared events, not a changed mask: a leave and a join in one epoch
    can leave the mask as it was while the controller still bootstraps the
    entrant and restarts its hysteresis."""
    view = trace.start_view(size)
    alive = np.zeros((epochs, size), np.float64)
    joined = np.zeros((epochs, size), np.float64)
    restored = np.zeros((epochs, size), np.float64)
    eventful = np.zeros(epochs, bool)
    for e in range(epochs):
        events = trace.at_epoch(e)
        if events:
            j, r = view.apply(events)
            joined[e], restored[e] = j, r
            eventful[e] = True
        alive[e] = view.alive_mask()
    return alive, joined, restored, eventful


def score_elasticity_policies(
    decomposed,
    size: int,
    budget: float,
    trace: MembershipTrace,
    seed: int = 9001,
    epochs: Optional[int] = None,
    steps_per_epoch: int = 16,
    trials: int = 4,
    dim: int = 4,
    hysteresis: Sequence[int] = (0, 2),
    solver_iters: int = 3000,
) -> Dict:
    """Score every (re-plan, bootstrap) policy against one churn trace.

    Returns ``{"pool": {...solver outputs...}, "policies": [...ranked...],
    "sim": {...}}``.  Each policy carries its per-epoch consensus-error
    curve over the live set (log-mean over trials), its score (the mean
    error after the last change: lower mixes better through the same
    churn) and the α it executed per epoch.  Restore and mean differ only
    where the trace rejoins, eager and hysteresis only where it re-plans.
    """
    from ..plan.spectral import (
        masked_consensus_error,
        masked_laplacian_expectation,
    )
    from ..schedule.base import refold_mixing, sample_flags
    from ..schedule.solvers import (
        solve_activation_probabilities,
        solve_mixing_weight,
    )
    from ..topology import matching_laplacians

    if epochs is None:
        epochs = max(trace.horizon() + 3, 4)
    epochs = int(epochs)
    Ls = matching_laplacians(decomposed, size)
    probs = solve_activation_probabilities(Ls, budget, iters=solver_iters)
    alpha0, rho0 = solve_mixing_weight(Ls, probs)
    alive, joined, restored, eventful = _replay_occupancy(trace, size,
                                                          epochs)
    last_change = max([e for e in range(epochs) if e == 0 or eventful[e]],
                      default=0)

    # the α fold and the masked stack are functions of the live set alone:
    # each runs once per distinct occupancy
    fold_cache: Dict[bytes, float] = {}
    mask_cache: Dict[bytes, np.ndarray] = {}

    def masked_stack(mask: np.ndarray) -> np.ndarray:
        key = mask.astype(np.uint8).tobytes()
        if key not in mask_cache:
            mask_cache[key] = masked_laplacian_expectation(Ls, mask)
        return mask_cache[key]

    def fold_alpha(mask: np.ndarray) -> float:
        key = mask.astype(np.uint8).tobytes()
        if key not in fold_cache:
            # the runtime's own fold: the α scored is the α executed
            a, _, _ = refold_mixing(Ls, probs, alpha0, mask)
            fold_cache[key] = float(a)
        return fold_cache[key]

    policies = _policy_grid(hysteresis)
    eye = np.eye(size)
    for pol in policies:
        curves = np.zeros((trials, epochs), np.float64)
        alpha_by_epoch = np.zeros(epochs, np.float64)
        for trial in range(trials):
            rng = np.random.default_rng(seed * 7919 + trial)
            flags = sample_flags(probs, epochs * steps_per_epoch,
                                 seed=seed * 7919 + trial)
            x = rng.standard_normal((size, dim))
            x -= x.mean(axis=0, keepdims=True)
            cur_alpha = alpha0
            pending_since: Optional[int] = (
                0 if alive[0].sum() < size else None)
            for e in range(epochs):
                changed = bool(eventful[e])
                if changed or (e == 0 and pending_since == 0):
                    if changed:
                        pending_since = e
                    # bootstrap the (re)entering rows before the epoch
                    # runs: "mean" overwrites every entrant with the
                    # donors' average, "restore" keeps rejoined rows at
                    # their frozen values and means only fresh joins
                    mean_in = (np.clip(joined[e] + restored[e], 0, 1)
                               if pol["bootstrap"] == "mean" else joined[e])
                    donors = (alive[e] * (1.0 - joined[e])
                              * (1.0 - restored[e]))
                    if mean_in.any() and donors.sum() >= 1:
                        dmean = x[donors > 0].mean(axis=0)
                        x = np.where(mean_in[:, None] > 0, dmean[None, :], x)
                if pending_since is not None and \
                        e - pending_since >= pol["hysteresis"]:
                    cur_alpha = fold_alpha(alive[e])
                    pending_since = None
                if trial == 0:
                    alpha_by_epoch[e] = cur_alpha
                # a 0/1 mask: the expectation is the realized masking
                mLs = masked_stack(alive[e])
                for t in range(e * steps_per_epoch, (e + 1) * steps_per_epoch):
                    W = eye - cur_alpha * np.tensordot(
                        flags[t].astype(np.float64), mLs, axes=1)
                    x = W @ x
                curves[trial, e] = masked_consensus_error(x, alive[e])
        log_curve = np.log(np.maximum(curves, 1e-300)).mean(axis=0)
        post = log_curve[last_change:]
        pol["error_curve"] = [float(v) for v in np.exp(log_curve)]
        pol["alpha_by_epoch"] = [float(v) for v in alpha_by_epoch]
        pol["score"] = float(np.exp(post.mean()))
        pol["final_error"] = float(math.exp(log_curve[-1]))

    policies.sort(key=lambda p: (p["score"], p["hysteresis"],
                                 p["bootstrap"]))
    return {
        "pool": {"num_workers": int(size), "budget": float(budget),
                 "seed": int(seed), "alpha": float(alpha0),
                 "rho": float(rho0),
                 "probs": [float(p) for p in probs]},
        "policies": policies,
        "sim": {"epochs": epochs, "steps_per_epoch": int(steps_per_epoch),
                "trials": int(trials), "dim": int(dim),
                "last_change_epoch": int(last_change),
                "trace": trace.to_json()},
    }


def elasticity_artifact(report: Dict, graph_spec: Dict,
                        target: float = 1e-3):
    """A :func:`score_elasticity_policies` report as a
    ``matcha_tpu.plan/1`` artifact.

    Every candidate shares the pool schedule (policies change the response
    to churn, not the schedule), so planlint's numeric checks apply as
    they are; the policy and its scores ride as extra keys, and the score
    lands in ``predicted_seconds_to_target``, the field PL008 ranks by.
    """
    from ..plan.artifact import PlanArtifact
    from ..plan.spectral import steps_to_consensus

    pool = report["pool"]
    base = {
        **graph_spec,
        "num_workers": pool["num_workers"],
        "budget": pool["budget"],
        "seed": pool["seed"],
        "matcha": True,
        "alpha": pool["alpha"],
        "rho": pool["rho"],
        "probs": list(pool["probs"]),
        "steps_to_target": (None if pool["rho"] >= 1.0
                            else steps_to_consensus(pool["rho"], target)),
        "expected_comm_fraction": float(np.mean(pool["probs"])),
    }
    candidates = []
    for pol in report["policies"]:
        candidates.append({
            **base,
            "predicted_seconds_to_target": pol["score"],
            "policy": {"replan": pol["replan"],
                       "hysteresis": pol["hysteresis"],
                       "bootstrap": pol["bootstrap"]},
            "elasticity": {"score": pol["score"],
                           "final_error": pol["final_error"],
                           "error_curve": pol["error_curve"],
                           "alpha_by_epoch": pol["alpha_by_epoch"]},
        })
    return PlanArtifact(
        chosen=dict(candidates[0]),
        candidates=candidates,
        target_consensus=float(target),
        num_chips=1,
        cost_model={"kind": "elasticity", "sim": report["sim"]},
    )
