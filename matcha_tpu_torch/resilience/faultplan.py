"""Declarative runtime fault plans: deterministic chaos for the training step.

Port of ``matcha_tpu/resilience/faultplan.py`` (numpy, :62-278): a
``FaultPlan`` is a list of declarative events (who fails, how, over which
step range) that compiles, as the gossip schedule does, into static arrays
the train step indexes by its cursor.  The same plan and seed give the
same fault stream, bit for bit, on both packages.

Event kinds
-----------
``dead``        worker ``w`` is gone for ``[start, stop)``: its exchanges
                become self-loops (alive mask 0), and at ``stop`` it
                revives: the step heals its parameters from the mean of its
                alive peers and resets its momentum.
``straggler``   worker ``w`` reaches its peers only every ``period``-th step
                of ``[start, stop)``; never healed.
``nan``         worker ``w`` emits non-finite parameters over ``[start,
                stop)`` (default one step); the step detects the row,
                quarantines it from gossip and heals it.
``link_down``   matching ``m`` (or all when ``m`` is None) is severed for
                ``[start, stop)``.
``flaky_link``  matching ``m`` (or all) drops i.i.d. with ``drop_prob``
                over ``[start, stop)``.

The compiled ``RuntimeFaults`` knows its own expectation
(``expected_alive()``, ``expected_link_up()``), which the α re-derivation
(``resolve_degraded_alpha``) consumes.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence, Tuple, Union

import numpy as np

__all__ = [
    "FAULT_KINDS",
    "FaultEvent",
    "FaultPlan",
    "RuntimeFaults",
    "load_fault_plan",
    "resolve_degraded_alpha",
]

FAULT_KINDS = ("dead", "straggler", "nan", "link_down", "flaky_link")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One declarative fault over the step range ``[start, stop)``.

    ``stop=None`` means "one step" for ``nan`` and "until the horizon" for
    every other kind (a dead worker that never revives, a permanently flaky
    link).  Ranges beyond the horizon are clipped at compile.
    """

    kind: str
    start: int
    stop: Optional[int] = None
    worker: Optional[int] = None     # dead | straggler | nan
    matching: Optional[int] = None   # link_down | flaky_link (None = all)
    period: int = 2                  # straggler: alive every period-th step
    drop_prob: float = 0.0           # flaky_link
    seed: int = 0                    # flaky_link

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"have {FAULT_KINDS}")
        if self.start < 0:
            raise ValueError(f"start must be >= 0, got {self.start}")
        if self.stop is not None and self.stop <= self.start:
            raise ValueError(f"empty range [{self.start}, {self.stop})")
        if self.kind in ("dead", "straggler", "nan") and self.worker is None:
            raise ValueError(f"{self.kind} event needs a worker index")
        if self.kind == "straggler" and self.period < 2:
            raise ValueError("straggler period must be >= 2 (period 1 is "
                             "full participation — no fault)")
        if self.kind == "flaky_link" and not 0.0 <= self.drop_prob <= 1.0:
            raise ValueError(f"drop_prob must be in [0,1], got {self.drop_prob}")

    def window(self, horizon: int) -> Tuple[int, int]:
        default_stop = self.start + 1 if self.kind == "nan" else horizon
        stop = default_stop if self.stop is None else self.stop
        return min(self.start, horizon), min(stop, horizon)


@dataclasses.dataclass(frozen=True)
class RuntimeFaults:
    """The compiled fault stream: static arrays the train step indexes at t.

    ``alive``      f32[T, N]  — gossip participation mask (dead ∧ straggler)
    ``revive``     f32[T, N]  — 1 at a dead→alive transition: heal this row
    ``nan_inject`` f32[T, N]  — poison this row's parameters this step
    ``link_up``    f32[T, M]  — multiplies the activation flags
    ``dead_alive`` f32[T, N]  — the ``dead``-events-only mask: which rows the
                   divergence detector may exempt (they WILL be healed at
                   revival).  Stragglers are not in it — they are never
                   healed, so their state must stay finite like anyone's.
    """

    alive: np.ndarray
    revive: np.ndarray
    nan_inject: np.ndarray
    link_up: np.ndarray
    dead_alive: np.ndarray

    @property
    def iterations(self) -> int:
        return int(self.alive.shape[0])

    @property
    def num_workers(self) -> int:
        return int(self.alive.shape[1])

    def any_faults(self) -> bool:
        return bool((self.alive != 1).any() or (self.nan_inject != 0).any()
                    or (self.link_up != 1).any())

    def expected_alive(self) -> np.ndarray:
        """f64[N] — each worker's alive fraction over the horizon (the
        alive-mask expectation the degraded-ρ predictor uses)."""
        return np.asarray(self.alive, np.float64).mean(axis=0)

    def expected_link_up(self) -> np.ndarray:
        """f64[M] — per-matching survival fraction of the link faults."""
        return np.asarray(self.link_up, np.float64).mean(axis=0)

    def without_nan_in(self, start: int, stop: int) -> "RuntimeFaults":
        """Mark nan injections in ``[start, stop)`` consumed (cleared).

        Recovery calls this after rolling back past a poisoned window: the
        chaos event *happened* — replaying the steps must not re-fire it, or
        a bounded retry budget can never succeed against its own plan."""
        nan = np.array(self.nan_inject, copy=True)
        nan[start:stop] = 0.0
        return dataclasses.replace(self, nan_inject=nan)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An ordered collection of :class:`FaultEvent`, JSON-round-trippable."""

    events: Tuple[FaultEvent, ...]
    name: str = "faultplan"

    def compile(self, iterations: int, num_workers: int,
                num_matchings: int) -> RuntimeFaults:
        """Expand the events into the static per-step fault arrays."""
        T, N, M = int(iterations), int(num_workers), int(num_matchings)
        dead_alive = np.ones((T, N), np.float32)   # dead events only
        straggle = np.ones((T, N), np.float32)
        nan_inject = np.zeros((T, N), np.float32)
        link_up = np.ones((T, M), np.float32)
        for ev in self.events:
            lo, hi = ev.window(T)
            if hi <= lo:
                continue
            if ev.kind in ("dead", "straggler", "nan") and not (
                    0 <= ev.worker < N):
                raise ValueError(
                    f"{ev.kind} worker {ev.worker} out of range [0, {N})")
            if ev.kind in ("link_down", "flaky_link") and ev.matching is not None \
                    and not 0 <= ev.matching < M:
                raise ValueError(
                    f"{ev.kind} matching {ev.matching} out of range [0, {M})")
            if ev.kind == "dead":
                dead_alive[lo:hi, ev.worker] = 0.0
            elif ev.kind == "straggler":
                t = np.arange(lo, hi)
                straggle[lo:hi, ev.worker] = (
                    (t - lo) % ev.period == 0).astype(np.float32)
            elif ev.kind == "nan":
                nan_inject[lo:hi, ev.worker] = 1.0
            elif ev.kind == "link_down":
                cols = slice(None) if ev.matching is None else ev.matching
                link_up[lo:hi, cols] = 0.0
            elif ev.kind == "flaky_link":
                rng = np.random.default_rng(ev.seed)
                cols = slice(None) if ev.matching is None else [ev.matching]
                shape = (hi - lo, M if ev.matching is None else 1)
                keep = (rng.random(shape) >= ev.drop_prob).astype(np.float32)
                link_up[lo:hi, cols] = np.minimum(link_up[lo:hi, cols], keep)
        # revive = dead→alive transitions of *dead* events only: stragglers
        # rejoin with their own (real, merely under-mixed) state and must
        # not be overwritten by the heal
        prev = np.vstack([dead_alive[:1], dead_alive[:-1]])
        revive = ((dead_alive == 1.0) & (prev == 0.0)).astype(np.float32)
        revive[0] = 0.0
        return RuntimeFaults(alive=dead_alive * straggle, revive=revive,
                             nan_inject=nan_inject, link_up=link_up,
                             dead_alive=dead_alive)

    # ----- JSON ------------------------------------------------------------

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "events": [
                {k: v for k, v in dataclasses.asdict(ev).items()
                 if v is not None}
                for ev in self.events
            ],
        }

    @staticmethod
    def from_json(obj: dict) -> "FaultPlan":
        events = tuple(FaultEvent(**e) for e in obj.get("events", []))
        return FaultPlan(events=events, name=obj.get("name", "faultplan"))


def load_fault_plan(
    spec: Union[str, dict, FaultPlan, Sequence[FaultEvent]],
) -> FaultPlan:
    """Coerce any accepted spelling of a fault plan into a :class:`FaultPlan`:
    a JSON file path (the ``--fault-plan`` CLI form), a parsed dict, a list
    of events, or an already-built plan."""
    if isinstance(spec, FaultPlan):
        return spec
    if isinstance(spec, str):
        with open(spec) as f:
            return FaultPlan.from_json(json.load(f))
    if isinstance(spec, dict):
        return FaultPlan.from_json(spec)
    return FaultPlan(events=tuple(spec))


def resolve_degraded_alpha(schedule, faults: RuntimeFaults,
                           worker_alive=None):
    """Re-solve the mixing weight α for a degraded fleet.

    The solver inputs are the *expected* masked Laplacians (edges scaled by
    both endpoints' alive fractions, permanently-dead workers projected out
    — see ``plan.spectral.degraded_solver_inputs``) and the link-degraded
    activation probabilities ``p_j · E[link_up_j]`` — the runtime
    generalization of ``schedule.faults.effective_activation_probs``,
    finally wired into ``solve_mixing_weight`` at run time rather than only
    in offline studies.

    ``worker_alive`` composes an additional availability on top of the
    fault plan's expectation (elastic membership's pool occupancy: a vacant
    slot is dead to the mixing whatever the fault plan thought of it).

    Returns ``(alpha, rho, p_eff)``; with fewer than two (even fractional)
    survivors the original α is kept (there is no consensus to optimize).
    """
    from ..plan.spectral import degraded_solver_inputs
    from ..schedule.solvers import solve_mixing_weight

    alive = np.asarray(faults.expected_alive(), np.float64)
    if worker_alive is not None:
        alive = alive * np.asarray(worker_alive, np.float64)
    Ls, p_eff = degraded_solver_inputs(
        schedule.laplacians(), schedule.probs,
        worker_alive=alive,
        link_up=faults.expected_link_up())
    if Ls.shape[-1] < 2:
        return float(schedule.alpha), 1.0, p_eff
    alpha, rho = solve_mixing_weight(Ls, p_eff)
    return float(alpha), float(rho), p_eff
