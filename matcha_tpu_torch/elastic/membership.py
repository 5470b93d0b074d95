"""Elastic membership, host half: join, leave and rejoin at epoch boundaries.

Port of ``matcha_tpu/elastic/membership.py`` (numpy, :65-489).  Live
workers map onto a fixed pool of ``N`` slots: a vacant slot is a frozen,
gossip-masked row, never a removed one, so no tensor changes shape when
the membership does.  The membership changes only at the epoch boundary,
where the loop already reads the device once; the step sees the pool mask
and the re-derived α scale as values (``elastic.runtime.Membership``).
Re-planning is cheap because MATCHA's matchings persist: a change only
re-folds the expected mixing over the new live set
(``Schedule.refold_for``), which yields the new α and predicted ρ.

The state machine per pool slot::

        occupied ──leave──▶ vacant (its rows kept, frozen)
        vacant   ──join───▶ occupied (rows bootstrapped from the donor mean)
        vacant   ──rejoin─▶ occupied (own rows restored if the slot was not
                                      recycled and they are still finite;
                                      else bootstrap)

Momentum, the communicator's carry and in-flight deltas are reset on every
(re)entry.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

__all__ = [
    "MEMBERSHIP_KINDS",
    "MembershipEvent",
    "MembershipTrace",
    "MembershipView",
    "MembershipTransition",
    "ElasticController",
    "load_membership_trace",
]

MEMBERSHIP_KINDS = ("leave", "join", "rejoin")


@dataclasses.dataclass(frozen=True)
class MembershipEvent:
    """One declared membership change, applied at epoch ``epoch``'s boundary.

    ``worker`` is an external identity (a string id), not a pool slot: the
    view owns the id→slot mapping, so a trace survives slot reuse.  Integer
    ids are accepted and normalized to the default ``"w{i}"`` naming.
    """

    kind: str
    epoch: int
    worker: str

    def __post_init__(self):
        if self.kind not in MEMBERSHIP_KINDS:
            raise ValueError(f"unknown membership kind {self.kind!r}; "
                             f"have {MEMBERSHIP_KINDS}")
        if self.epoch < 0:
            raise ValueError(f"epoch must be >= 0, got {self.epoch}")
        if isinstance(self.worker, (int, np.integer)):
            object.__setattr__(self, "worker", f"w{int(self.worker)}")
        if not isinstance(self.worker, str) or not self.worker:
            raise ValueError(f"worker must be a non-empty id, got "
                             f"{self.worker!r}")

    def to_json(self) -> dict:
        return {"kind": self.kind, "epoch": int(self.epoch),
                "worker": self.worker}


@dataclasses.dataclass(frozen=True)
class MembershipTrace:
    """An ordered, JSON-round-trippable churn declaration — the membership
    twin of ``resilience.FaultPlan`` (``train_torch.py --membership-trace``).

    ``initial``: the worker ids occupying the pool at epoch 0, in slot
    order; fewer ids than pool slots leaves the tail slots *vacant* —
    spare capacity later joins grow into (a full pool can only churn by
    recycling a leaver's slot, which forfeits that leaver's restore-own
    rows).  ``None`` = fully occupied with the default ``w0..w{N-1}``."""

    events: Tuple[MembershipEvent, ...]
    name: str = "membership"
    initial: Optional[Tuple[str, ...]] = None

    def horizon(self) -> int:
        """Last epoch any event touches (-1 for an empty trace)."""
        return max((ev.epoch for ev in self.events), default=-1)

    def at_epoch(self, epoch: int) -> List[MembershipEvent]:
        return [ev for ev in self.events if ev.epoch == int(epoch)]

    def to_json(self) -> dict:
        out = {"name": self.name,
               "events": [ev.to_json() for ev in self.events]}
        if self.initial is not None:
            out["initial"] = list(self.initial)
        return out

    @staticmethod
    def from_json(obj: dict) -> "MembershipTrace":
        events = tuple(MembershipEvent(**e) for e in obj.get("events", []))
        initial = obj.get("initial")
        return MembershipTrace(events=events,
                               name=obj.get("name", "membership"),
                               initial=None if initial is None
                               else tuple(initial))

    def start_view(self, pool_size: int) -> "MembershipView":
        """The epoch-0 view this trace declares over a ``pool_size`` pool."""
        return MembershipView.start(pool_size, self.initial)


def load_membership_trace(
    spec: Union[str, dict, MembershipTrace, Sequence[MembershipEvent]],
) -> MembershipTrace:
    """Coerce any accepted spelling — a JSON file path (the CLI form), a
    parsed dict, an event list, an already-built trace, or any object
    with the source interface (``start_view`` + ``at_epoch``)."""
    if isinstance(spec, MembershipTrace):
        return spec
    if hasattr(spec, "start_view") and hasattr(spec, "at_epoch"):
        return spec  # a live (or custom) membership source: pass through
    if isinstance(spec, str):
        with open(spec) as f:
            return MembershipTrace.from_json(json.load(f))
    if isinstance(spec, dict):
        return MembershipTrace.from_json(spec)
    return MembershipTrace(events=tuple(spec))


@dataclasses.dataclass
class MembershipView:
    """Host-side reconciler: who occupies which slot of the static pool.

    ``occupants[s]`` is the worker id held by slot ``s`` (``None`` =
    vacant).  ``owners[s]`` remembers the *last* occupant even after a
    leave — a rejoin whose old slot is still vacant re-enters there and may
    restore its own quarantined rows; if the slot was recycled by a fresh
    join, the rejoiner is placed like any new worker and bootstraps from
    the survivor mean (its rows are gone).
    """

    pool_size: int
    occupants: List[Optional[str]]
    owners: List[Optional[str]]

    @staticmethod
    def full(pool_size: int, ids: Optional[Sequence[str]] = None
             ) -> "MembershipView":
        if ids is None:
            ids = [f"w{i}" for i in range(pool_size)]
        ids = list(ids)
        if len(ids) != pool_size or len(set(ids)) != pool_size:
            raise ValueError(f"need {pool_size} distinct worker ids, got "
                             f"{ids}")
        return MembershipView(pool_size=int(pool_size), occupants=list(ids),
                              owners=list(ids))

    @staticmethod
    def start(pool_size: int, initial: Optional[Sequence[str]] = None
              ) -> "MembershipView":
        """Epoch-0 occupancy: ``initial`` ids fill the leading slots, the
        remainder start vacant and unowned (spare capacity).  ``None`` is
        the fully-occupied default."""
        if initial is None:
            return MembershipView.full(pool_size)
        ids = list(initial)
        if len(ids) > pool_size or len(set(ids)) != len(ids):
            raise ValueError(f"initial membership needs <= {pool_size} "
                             f"distinct worker ids, got {ids}")
        if len(ids) < 2:
            raise ValueError(f"initial membership needs >= 2 live workers "
                             f"(got {len(ids)}) — no consensus process "
                             f"otherwise")
        pad: List[Optional[str]] = [None] * (pool_size - len(ids))
        return MembershipView(pool_size=int(pool_size),
                              occupants=ids + pad, owners=ids + pad)

    # ------------------------------------------------------------------ state
    def alive_mask(self) -> np.ndarray:
        """f32[N_pool] — 1 where the slot is occupied."""
        return np.asarray([0.0 if o is None else 1.0
                           for o in self.occupants], np.float32)

    def live_count(self) -> int:
        return sum(o is not None for o in self.occupants)

    def slot_of(self, worker: str) -> Optional[int]:
        try:
            return self.occupants.index(worker)
        except ValueError:
            return None

    # ------------------------------------------------------------- transitions
    def apply(self, events: Sequence[MembershipEvent]
              ) -> Tuple[np.ndarray, np.ndarray]:
        """Apply one boundary's events in order.

        Returns ``(joined, restored)`` — f32[N_pool] slot masks: ``joined``
        slots enter with *no usable history* (fresh join, or a rejoin whose
        slot was recycled) and must bootstrap from the survivor mean;
        ``restored`` slots are rejoins into their own untouched slot, whose
        quarantined rows *may* be restored (the step still falls back to
        the mean if the row went non-finite while vacant).  A worker id may
        not be double-joined; the pool may not be driven below two live
        workers (no consensus process remains to rejoin into).
        """
        joined = np.zeros(self.pool_size, np.float32)
        restored = np.zeros(self.pool_size, np.float32)
        for ev in events:
            if ev.kind == "leave":
                slot = self.slot_of(ev.worker)
                if slot is None:
                    raise ValueError(f"leave: worker {ev.worker!r} is not a "
                                     f"member (epoch {ev.epoch})")
                if self.live_count() <= 2:
                    raise ValueError(
                        f"leave of {ev.worker!r} at epoch {ev.epoch} would "
                        f"drop the pool below 2 live workers — no consensus "
                        f"process would remain")
                self.occupants[slot] = None
                # owners[slot] stays ev.worker: the rejoin key
            else:  # join | rejoin
                if self.slot_of(ev.worker) is not None:
                    raise ValueError(f"{ev.kind}: worker {ev.worker!r} is "
                                     f"already a member (epoch {ev.epoch})")
                own = None
                if ev.kind == "rejoin":
                    for s, owner in enumerate(self.owners):
                        if owner == ev.worker and self.occupants[s] is None:
                            own = s
                            break
                if own is not None:
                    slot = own
                    restored[slot] = 1.0
                    joined[slot] = 0.0
                else:
                    vacant = [s for s, o in enumerate(self.occupants)
                              if o is None]
                    if not vacant:
                        raise ValueError(
                            f"{ev.kind}: pool is full ({self.pool_size} "
                            f"slots) — cannot place {ev.worker!r} at epoch "
                            f"{ev.epoch}; declare spare capacity via the "
                            f"trace's 'initial' list")
                    # never-owned slots first: recycling a leaver's slot
                    # forfeits its restore-own rows, so spare capacity is
                    # spent before history is.  Lowest index within each
                    # class keeps placement deterministic — the resume
                    # replayer and the offline scorer must reproduce it.
                    unowned = [s for s in vacant if self.owners[s] is None]
                    slot = (unowned or vacant)[0]
                    joined[slot] = 1.0
                    restored[slot] = 0.0
                self.occupants[slot] = ev.worker
                self.owners[slot] = ev.worker
        return joined, restored

    # ------------------------------------------------------------------- JSON
    def to_json(self) -> dict:
        return {"pool_size": int(self.pool_size),
                "occupants": list(self.occupants),
                "owners": list(self.owners)}

    @staticmethod
    def from_json(obj: dict) -> "MembershipView":
        return MembershipView(pool_size=int(obj["pool_size"]),
                              occupants=list(obj["occupants"]),
                              owners=list(obj["owners"]))


@dataclasses.dataclass(frozen=True)
class MembershipTransition:
    """Everything one boundary reconciliation produced — what the train loop
    applies to the device state and journals as a ``membership`` event."""

    epoch: int
    trigger: Tuple[dict, ...]        # the events, JSON form
    old_alive: np.ndarray            # f32[N_pool] before
    new_alive: np.ndarray            # f32[N_pool] after
    joined: np.ndarray               # f32[N_pool] — bootstrap from mean
    restored: np.ndarray             # f32[N_pool] — restore own if finite
    alpha: float                     # executed mixing weight after this epoch
    rho: Optional[float]             # predicted contraction for the live set
    #                                  (None while hysteresis defers the very
    #                                  first fold — nothing was ever solved)
    alpha_scale: float               # alpha / schedule-built alpha
    replanned: bool                  # False while hysteresis defers the fold


class ElasticController:
    """The host half of elastic membership: replays the trace at epoch
    boundaries, re-folds the schedule over each new live set, and carries
    the hysteresis state — deterministic, so a resumed run reconstructs the
    exact same (view, α, scale) by replaying ``advance`` up to the restored
    epoch (byte-identical resume is a test, not a hope).

    ``hysteresis``: epochs the membership must stay unchanged before α is
    re-derived (0 = eager re-plan at the change boundary).  The alive mask
    always applies immediately — masking is correctness, α is optimization
    — so a deferred re-plan runs the old α over the new live set.
    """

    def __init__(self, trace: MembershipTrace, num_workers: int,
                 hysteresis: int = 0, bootstrap: str = "mean"):
        if hysteresis < 0:
            raise ValueError(f"hysteresis must be >= 0, got {hysteresis}")
        if bootstrap not in ("mean", "restore"):
            raise ValueError(f"bootstrap must be 'mean' or 'restore', got "
                             f"{bootstrap!r}")
        self.trace = trace
        self.view = trace.start_view(num_workers)
        self.hysteresis = int(hysteresis)
        #: "restore" lets a rejoiner keep its own quarantined rows;
        #: "mean" bootstraps every (re)entry from the survivor mean
        self.bootstrap = bootstrap
        self.alpha_scale = 1.0
        self.alpha: Optional[float] = None   # None until first re-plan
        self.rho: Optional[float] = None
        # a partially-occupied start is itself a re-plan trigger: the
        # schedule's α was solved for the full pool, not the initial set
        self._pending_since: Optional[int] = (
            0 if self.view.live_count() < self.view.pool_size else None)
        self._applied_through = -1  # idempotence: rollback retries re-enter

    def alive_mask(self) -> np.ndarray:
        return self.view.alive_mask()

    def advance(self, epoch: int, schedule) -> Optional[MembershipTransition]:
        """Reconcile the boundary of ``epoch``; ``None`` = nothing changed.

        Idempotent per epoch: the rollback-recovery path re-enters the loop
        top for a retried epoch, and the transition must not re-apply (the
        bootstrap already happened and is part of the retry's snapshot).
        """
        epoch = int(epoch)
        if epoch <= self._applied_through:
            return None
        self._applied_through = epoch
        events = self.trace.at_epoch(epoch)
        old_alive = self.view.alive_mask()
        joined = restored = None
        if events:
            joined, restored = self.view.apply(events)
            if self.bootstrap == "mean":
                # policy "mean": rejoins bootstrap like fresh joins
                joined = np.clip(joined + restored, 0.0, 1.0)
                restored = np.zeros_like(restored)
            self._pending_since = epoch
        if self._pending_since is None:
            return None
        if epoch - self._pending_since < self.hysteresis:
            if not events:
                return None  # still deferring, nothing new to journal
            # masked immediately, fold deferred: journal the change with the
            # *current* α so the record never claims a re-plan that didn't run
            return self._transition(epoch, events, old_alive, joined,
                                    restored, schedule, replanned=False)
        self._pending_since = None
        return self._transition(epoch, events, old_alive, joined, restored,
                                schedule, replanned=True)

    def _transition(self, epoch, events, old_alive, joined, restored,
                    schedule, replanned: bool) -> MembershipTransition:
        n = self.view.pool_size
        if replanned:
            alpha, rho, _ = schedule.refold_for(self.view.alive_mask())
            self.alpha, self.rho = float(alpha), float(rho)
            base = float(schedule.alpha)
            self.alpha_scale = self.alpha / base if base else 1.0
        else:
            # deferred: the executed α is whatever ran before this change
            self.alpha = (float(schedule.alpha) * self.alpha_scale
                          if self.alpha is None else self.alpha)
        return MembershipTransition(
            epoch=int(epoch),
            trigger=tuple(ev.to_json() for ev in events),
            old_alive=old_alive,
            new_alive=self.view.alive_mask(),
            joined=np.zeros(n, np.float32) if joined is None else joined,
            restored=(np.zeros(n, np.float32) if restored is None
                      else restored),
            alpha=float(self.alpha),
            # None (not NaN) when hysteresis deferred before anything was
            # ever folded: json.dumps writes NaN as a non-RFC token that
            # strict parsers (jq, JS) reject — the journal must stay
            # machine-readable everywhere
            rho=None if self.rho is None else float(self.rho),
            alpha_scale=float(self.alpha_scale),
            replanned=bool(replanned),
        )

    def replay_to(self, start_epoch: int, schedule
                  ) -> List[MembershipTransition]:
        """Re-derive the controller state a run that checkpointed after
        epoch ``start_epoch − 1`` had: advance through every earlier
        boundary without touching device state.  Returns the transitions
        (the caller journals nothing — they already happened in the run
        being resumed); the final view/α/scale are what resume primes the
        restored state with."""
        out = []
        for e in range(int(start_epoch)):
            t = self.advance(e, schedule)
            if t is not None:
                out.append(t)
        return out

    def reconcile_restored(self, saved_view: Optional[dict]
                           ) -> Tuple[np.ndarray, np.ndarray]:
        """Map a restored checkpoint's occupancy onto this controller's.

        ``saved_view`` is the checkpoint's membership sidecar (``None`` for
        pre-elastic checkpoints = fully-occupied pool).  Returns
        ``(joined, restored)`` slot masks for the rows whose checkpointed
        content does not serve the current occupant: a slot alive now whose
        saved occupant was someone else (or nobody) must bootstrap; a slot
        whose saved occupant is the *owner* but was vacant at save time may
        restore its quarantined rows (the save froze them).  Grow (more
        live now than at save) and shrink (fewer) both reduce to this
        per-slot rule — the pool shape never changes, only occupancy.
        """
        n = self.view.pool_size
        saved = (MembershipView.from_json(saved_view) if saved_view
                 else MembershipView.full(n))
        if saved.pool_size != n:
            raise ValueError(
                f"checkpoint was taken with pool_size={saved.pool_size}, "
                f"resuming with num_workers={n}: the static pool shape is "
                f"the compiled-program contract and cannot be remapped — "
                f"re-run with the original pool size (occupancy may differ "
                f"freely)")
        joined = np.zeros(n, np.float32)
        restored = np.zeros(n, np.float32)
        for s in range(n):
            now = self.view.occupants[s]
            if now is None:
                continue  # vacant now: row stays quarantined, nothing to map
            if saved.occupants[s] == now:
                continue  # same worker, live at save: the row is its history
            if saved.owners[s] == now and self.bootstrap == "restore":
                restored[s] = 1.0  # its own quarantined row, frozen at save
            else:
                joined[s] = 1.0
        # a joined row bootstraps from the donor mean (live, not itself
        # (re)entering) — if NO donor remains, the surgery's quorum guard
        # would refuse the heal while momentum/carry still reset, silently
        # wiping fleet state.  That only happens when the checkpoint shares
        # no live workers with the current membership (e.g. a pre-elastic
        # sidecar-less checkpoint resumed under a trace with different
        # worker ids): a naming mismatch, not a churn — fail loudly.
        alive_now = self.view.alive_mask()
        donors = (alive_now > 0) & (joined == 0) & (restored == 0)
        if joined.any() and not donors.any():
            raise ValueError(
                "restored checkpoint shares no live workers with the "
                "current membership — every live slot would bootstrap from "
                "an empty donor set (checkpoint occupants "
                f"{[o for o in saved.occupants if o is not None]} vs live "
                f"{[o for o in self.view.occupants if o is not None]}); "
                "this is a worker-id mismatch, not churn — align the "
                "trace's worker ids with the checkpoint's membership "
                "sidecar (pre-elastic checkpoints are named w0..w{N-1})")
        return joined, restored
