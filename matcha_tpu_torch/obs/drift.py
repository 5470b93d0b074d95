"""Live planner-drift detection: the realized contraction against the
plan's ρ.

Port of ``matcha_tpu/obs/drift.py`` (:47-298): ``compose_predicted_rho``,
``DriftMonitor`` and ``drift_report``, host numpy with the same
arithmetic, on the port's ``plan/spectral.py`` and ``schedule/solvers.py``.

The planner claims that the schedule contracts the squared consensus error
by at most ρ a gossip step (the RMS by √ρ), composed from the offline bound
and the staleness, bf16-wire and fault corrections.  The monitor checks the
claim epoch by epoch against the telemetry stream.  Training is not pure
gossip: every SGD step injects disagreement, so the measured curve decays
to a floor, and near the floor the per-epoch factor says nothing about ρ.
An epoch pair is **checked** only when the previous epoch's disagreement
sits above ``slack ×`` the running floor estimate (a low quantile of the
series so far), or when the series never left its start (max ≤
``rise_tol × d₀`` and the value still ≥ ``start_frac × d₀``) while the
plan promised contraction: a curve born high that never decayed is the
wrong-α signature, which the quantile guard alone cannot see.  A run that
starts at its floor (a resume with a fresh monitor) looks the same: raise
``drift_tolerance`` there.

A ``drift`` event is journaled after ``patience`` consecutive checked
epochs whose factor exceeds ``predicted_factor·(1+tolerance)``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np

__all__ = ["compose_predicted_rho", "DriftMonitor", "drift_report"]


def compose_predicted_rho(
    laplacians: np.ndarray,
    probs: np.ndarray,
    alpha: float,
    overlap: str = "off",
    wire_dtype=None,
    worker_alive: Optional[np.ndarray] = None,
    link_up: Optional[np.ndarray] = None,
    staleness=1,
    local_steps: int = 1,
) -> Dict[str, float]:
    """The plan's full ρ composition for a running config, with provenance.

    Exactly the stack ``plan_torch.py rho`` reports: the degraded solver
    inputs (fault plan expectations) feed the staleness/wire-adjusted
    bound, so one number accounts for everything the executor is known to
    do to the schedule.  ``staleness`` (an int or ``{delay: prob}``
    distribution) and ``local_steps`` compose the bounded-staleness
    pipeline's delayed-recurrence inflation and the local-step exponent
    into the same number (``plan.spectral.stale_contraction_rho``) — the
    drift monitor then falsifies the *async* contract live, exactly as it
    does the eager one.  Returns ``{"rho", "rho_base", "wire_eps",
    "floor_rel", "staleness", "local_steps"}`` — ``rho`` is the composed
    bound the drift monitor compares against, ``rho_base`` the fault-free
    eager f32 bound, ``floor_rel`` the bf16 consensus floor relative to
    parameter RMS (0 for f32 wire).
    """
    from ..plan.spectral import (
        degraded_solver_inputs,
        normalize_staleness,
        stale_contraction_rho,
        wire_disagreement_floor,
        wire_quantization_eps,
    )
    from ..schedule.solvers import contraction_rho

    Ls = np.asarray(laplacians, np.float64)
    p = np.asarray(probs, np.float64)
    base = float(contraction_rho(Ls, p, float(alpha))) \
        if Ls.shape[-1] >= 2 else 1.0
    dLs, dp = degraded_solver_inputs(Ls, p, worker_alive, link_up)
    composed = float(stale_contraction_rho(dLs, dp, float(alpha),
                                           overlap=overlap,
                                           wire_dtype=wire_dtype,
                                           staleness=staleness,
                                           local_steps=local_steps))
    delays = normalize_staleness(staleness)
    return {
        "rho": composed,
        "rho_base": base,
        "wire_eps": float(wire_quantization_eps(wire_dtype)),
        "floor_rel": float(wire_disagreement_floor(wire_dtype)),
        # JSON-safe staleness record: the point-mass int, or the
        # distribution with stringified delay keys
        "staleness": (max(delays) if len(delays) == 1
                      else {str(d): pr for d, pr in delays.items()}),
        "local_steps": int(local_steps),
    }


class DriftMonitor:
    """Online per-epoch contraction check against a predicted ρ.

    ``observe(epoch, disagreement)`` returns a drift event payload once
    ``patience`` consecutive checked epochs exceed the tolerance band,
    then re-arms (a persistent drift fires again after another
    ``patience`` out-of-band epochs).  Unchecked epochs freeze the streak
    (they are evidence of nothing, either way).
    """

    def __init__(self, rho: float, steps_per_epoch: int,
                 tolerance: float = 0.25, patience: int = 2,
                 floor_quantile: float = 0.25, slack: float = 1.5,
                 rise_tol: float = 1.3, start_frac: float = 0.5):
        if not steps_per_epoch >= 1:
            raise ValueError("steps_per_epoch must be >= 1")
        if not tolerance > 0:
            raise ValueError("tolerance must be > 0")
        if not patience >= 1:
            raise ValueError("patience must be >= 1")
        self.rho = float(rho)
        self.steps_per_epoch = int(steps_per_epoch)
        # ρ bounds the *squared* error per gossip step ⇒ RMS per epoch
        # contracts by ≤ ρ^(steps/2); ρ ≥ 1 predicts nothing (factor 1)
        self.predicted_factor = (
            self.rho ** (self.steps_per_epoch / 2.0) if self.rho < 1 else 1.0)
        self.tolerance = float(tolerance)
        self.patience = int(patience)
        self.floor_quantile = float(floor_quantile)
        self.slack = float(slack)
        self.rise_tol = float(rise_tol)
        self.start_frac = float(start_frac)
        self.series: List[float] = []
        self.epochs: List[int] = []
        self.streak = 0
        self.checked_total = 0
        self.violations_total = 0

    @property
    def band(self) -> float:
        """The factor above which a checked epoch counts as out-of-band."""
        return self.predicted_factor * (1.0 + self.tolerance)

    def _checked(self, prev: float) -> bool:
        d = np.asarray(self.series, np.float64)
        finite = d[np.isfinite(d)]
        if finite.size < 2 or not np.isfinite(prev) or prev <= 0:
            return False
        floor = float(np.quantile(finite, self.floor_quantile))
        if prev >= self.slack * floor:
            return True
        d0 = float(finite[0])
        never_rose = float(finite.max()) <= self.rise_tol * max(d0, 1e-300)
        return never_rose and prev >= self.start_frac * d0

    def observe(self, epoch: int, disagreement: float) -> Optional[dict]:
        d = float(disagreement)
        prev = self.series[-1] if self.series else None
        self.series.append(d)
        self.epochs.append(int(epoch))
        if prev is None or not np.isfinite(d):
            return None
        factor = d / max(prev, 1e-300)
        if not self._checked(prev):
            return None  # injection-dominated regime: streak frozen
        self.checked_total += 1
        if factor > self.band:
            self.streak += 1
            self.violations_total += 1
        else:
            self.streak = 0
        if self.streak < self.patience:
            return None
        self.streak = 0  # re-arm: a persistent drift keeps journaling
        return {
            "epoch": int(epoch),
            "predicted_factor": self.predicted_factor,
            "measured_factor": float(factor),
            "tolerance": self.tolerance,
            "streak": self.patience,
            "rho": self.rho,
            "steps_per_epoch": self.steps_per_epoch,
            "disagreement": d,
        }


def drift_report(
    events: List[dict],
    rho: Optional[float] = None,
    tolerance: Optional[float] = None,
    patience: Optional[int] = None,
    steps_per_epoch: Optional[int] = None,
) -> Dict:
    """Replay the drift analysis over a journal (``obs_tpu.py drift``
    reads the port's journals with the JAX package's copy).

    Defaults come from the run's own ``run_start`` event (the composed ρ
    the loop monitored against); any argument overrides — ``--rho`` is the
    what-if knob ("would this run have satisfied *that* plan?").  The
    measured series is the per-epoch telemetry ``disagreement_mean``
    (falling back to the ``epoch`` events' value, which is the same
    number through a different path).  Returns a report dict; ``trips``
    are the replayed detections, ``journaled`` the ``drift`` events the
    live monitor actually wrote.
    """
    from .journal import epoch_series

    start = next((e for e in events if e.get("kind") == "run_start"), None)
    predicted = (start or {}).get("predicted", {})
    explicit_rho = rho is not None
    if rho is None:
        rho = predicted.get("rho")
    if steps_per_epoch is None:
        steps_per_epoch = predicted.get("steps_per_epoch")
    if tolerance is None:
        tolerance = predicted.get("tolerance", 0.25)
    if patience is None:
        patience = predicted.get("patience", 2)
    epochs, series = epoch_series(events, "telemetry", "disagreement_mean")
    if not epochs:
        epochs, series = epoch_series(events, "epoch", "disagreement")
    if rho is None or steps_per_epoch is None:
        raise ValueError(
            "journal has no run_start prediction and no --rho/--steps-per-"
            "epoch override — nothing to compare the measured series to")
    if len(epochs) < 2:
        raise ValueError("need >= 2 journaled epochs to measure contraction")
    # mid-run α re-derivations (fault recovery) and config-changed
    # resumes re-based the LIVE monitor's prediction; the replay must
    # re-base at the same epochs or its verdict diverges from what the
    # run was actually held to.  An explicit rho override is a what-if
    # and wins over everything.
    # `membership` re-plans (elastic join/leave/rejoin) re-base the
    # live monitor exactly like fault-recovery α re-derivations — deferred
    # (hysteresis) membership events carry an empty `predicted` and are
    # skipped here, matching the live monitor, which did not re-base either.
    # `control` hot-swaps (the JAX serve plane) carry the re-based prediction
    # on their applied events for exactly this replay.
    rebases = [] if explicit_rho else sorted(
        ((int(e["epoch"]), e["predicted"]) for e in events
         if e.get("kind") in ("alpha_rederived", "resume", "membership",
                              "control")
         and isinstance(e.get("predicted"), dict)
         and e["predicted"].get("rho") is not None
         and "epoch" in e),
        key=lambda pair: pair[0])
    monitor = DriftMonitor(float(rho), int(steps_per_epoch),
                           tolerance=float(tolerance), patience=int(patience))
    trips = []
    rebased_count = checked = violations = 0
    for ep, d in zip(epochs, series):
        while rebases and rebases[0][0] <= ep:
            _, pred = rebases.pop(0)
            rho = float(pred["rho"])
            # a re-base replaces the monitor but not the run's ledger:
            # checked/violation counts accumulate across plan segments
            checked += monitor.checked_total
            violations += monitor.violations_total
            rebased_count += 1
            monitor = DriftMonitor(rho, int(steps_per_epoch),
                                   tolerance=float(tolerance),
                                   patience=int(patience))
        ev = monitor.observe(ep, float(d) if d is not None else math.nan)
        if ev is not None:
            trips.append(ev)
    checked += monitor.checked_total
    violations += monitor.violations_total
    d = np.asarray(series, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        factors = (d[1:] / np.maximum(d[:-1], 1e-300)).tolist()
    journaled = [e for e in events if e.get("kind") == "drift"]
    return {
        # rho/band describe the plan the LAST segment was scored against;
        # `rebases` says how many plan segments the replay walked
        "rho": float(rho),
        "steps_per_epoch": int(steps_per_epoch),
        "predicted_factor": monitor.predicted_factor,
        "band": monitor.band,
        "tolerance": float(tolerance),
        "patience": int(patience),
        "epochs": epochs,
        "disagreement": [float(v) for v in d],
        "measured_factors": [float(f) for f in factors],
        "checked_epochs": checked,
        "violations": violations,
        "rebases": rebased_count,
        "trips": trips,
        "journaled": journaled,
        # an explicit rho override is a pure what-if: its verdict is the
        # REPLAY's alone — the live events were scored against a different
        # plan and must not veto the answer (they are still listed)
        "consistent": not trips and (explicit_rho or not journaled),
    }
