"""Liveness-driven membership: heartbeats in, join/leave/rejoin out.

Port of ``matcha_tpu/elastic/live.py``: :class:`LiveMembershipSource`
offers the interface of a declared trace (``start_view`` / ``at_epoch``)
to the :class:`ElasticController`, and derives its events from the health
plane's heartbeat files (:mod:`obs.health`):

* a member whose newest heartbeat is older than ``deadline`` seconds at
  the epoch-boundary poll **leaves**;
* a non-member heartbeating within the deadline **rejoins** if it was
  ever a member and **joins** otherwise.

Everything downstream (slot placement, hysteresis, the α re-fold, the
bootstrap, the journal) is the controller's.

Rules:

* One poll per epoch, cached: re-advancing a boundary (a rollback's
  retry, a resume's replay) replays the cached decision instead of
  reading the clock again.
* Workers are taken in sorted-id order.
* Leaves are clamped so that the live set never drops below ``min_live``
  (the overdue workers stay and leave once peers return); arrivals past
  the pool's capacity are deferred until a slot frees up.
* A worker never heard from is granted a grace window from the source's
  **first poll**; clock skew clamps ages to 0, and a future timestamp
  counts as fresh.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .membership import MembershipEvent, MembershipTrace, MembershipView

__all__ = ["LiveMembershipSource"]


class LiveMembershipSource:
    """Heartbeat-watching membership source.

    ``health_dir``: the shared heartbeat directory (a run's ``health/``,
    or any directory of per-host ``*.jsonl`` heartbeat files).
    ``deadline``: seconds without a heartbeat before a member is presumed
    gone.  ``initial``: the worker ids live at epoch 0 (the trace
    loader's ``initial`` contract — ``None`` = fully-occupied default).
    ``now_fn``: injectable clock (tests drive a fake one; production uses
    wall time).
    """

    def __init__(self, health_dir: str, deadline: float = 60.0,
                 initial: Optional[Sequence[str]] = None,
                 grace: Optional[float] = None,
                 now_fn: Optional[Callable[[], float]] = None,
                 min_live: int = 2, tail: int = 4, name: str = "live"):
        if not deadline > 0:
            raise ValueError(f"deadline must be > 0, got {deadline}")
        if min_live < 2:
            raise ValueError(f"min_live must be >= 2 (no consensus process "
                             f"below it), got {min_live}")
        self.health_dir = str(health_dir)
        self.deadline = float(deadline)
        self.grace = float(deadline if grace is None else grace)
        self.initial = None if initial is None else tuple(initial)
        self.min_live = int(min_live)
        self.tail = int(tail)
        self.name = str(name)
        self._now = now_fn or time.time
        self._pool_size: Optional[int] = None
        self._members: set = set()
        self._ever: set = set()
        self._first_poll: Optional[float] = None
        self._cache: Dict[int, Tuple[MembershipEvent, ...]] = {}

    # ------------------------------------------------ trace-loader interface
    def start_view(self, pool_size: int) -> MembershipView:
        """The epoch-0 view (the :class:`MembershipTrace` contract) — also
        primes the source's member mirror, which is what lets it emit only
        *transitions*."""
        view = MembershipView.start(pool_size, self.initial)
        self._pool_size = int(pool_size)
        self._members = {o for o in view.occupants if o is not None}
        self._ever = set(self._members)
        return view

    def at_epoch(self, epoch: int) -> List[MembershipEvent]:
        """This boundary's events — polled once, then replayed from cache
        (the idempotence resume replay and rollback retries rely on)."""
        epoch = int(epoch)
        if epoch not in self._cache:
            if self._pool_size is None:
                raise RuntimeError(
                    "LiveMembershipSource.at_epoch before start_view — the "
                    "controller owns the view; construct it first")
            self._cache[epoch] = tuple(self._poll(epoch))
        return list(self._cache[epoch])

    def horizon(self) -> int:
        """Last epoch any cached event touches (-1 before any) — a live
        source has no declared future."""
        return max((ev.epoch for evs in self._cache.values() for ev in evs),
                   default=-1)

    def seed_replay(self, journal_events: Sequence[dict],
                    upto_epoch: int) -> None:
        """Adopt a resumed run's journaled ``membership`` events as this
        source's historical poll decisions for epochs ``< upto_epoch``.

        The per-epoch cache is in-memory, so a fresh process replaying
        history would otherwise re-poll old boundaries against *today's*
        wall clock — a leaver whose host has since recovered would be
        silently resurrected, diverging from the checkpoint's membership
        sidecar and the drift monitor's re-bases.  The run journal is the
        cache's persisted copy (every applied poll journaled a
        ``membership`` event whose ``trigger`` is the poll's event list;
        a boundary with no record polled empty), so seeding from it makes
        ``replay_to`` replay the original run's decisions exactly.  Call
        after ``start_view`` (the controller's construction) and before
        ``replay_to``; polls from ``upto_epoch`` on are live again."""
        from ..obs.journal import latest_per_epoch

        latest = latest_per_epoch(journal_events, "membership")
        for epoch in range(int(upto_epoch)):
            rec = latest.get(epoch)
            evs = tuple(MembershipEvent(t["kind"], int(t.get("epoch", epoch)),
                                        t["worker"])
                        for t in (rec or {}).get("trigger", ()))
            self._cache[epoch] = evs
            for ev in evs:
                if ev.kind == "leave":
                    self._members.discard(ev.worker)
                else:
                    self._members.add(ev.worker)
                    self._ever.add(ev.worker)

    def as_trace(self) -> MembershipTrace:
        """The churn observed so far, as the *equivalent declared trace* —
        what the parity test replays and what a post-mortem can commit."""
        events = tuple(sorted(
            (ev for evs in self._cache.values() for ev in evs),
            key=lambda ev: (ev.epoch, ev.kind != "leave", ev.worker)))
        return MembershipTrace(events=events, name=self.name,
                               initial=self.initial)

    # --------------------------------------------------------------- polling
    def _last_seen(self) -> Dict[str, float]:
        from ..obs.health import read_heartbeats, worker_last_seen

        try:
            by_host = read_heartbeats(self.health_dir, tail=self.tail)
        except FileNotFoundError:
            by_host = {}
        return worker_last_seen(by_host)

    def _poll(self, epoch: int) -> List[MembershipEvent]:
        now = float(self._now())
        if self._first_poll is None:
            self._first_poll = now
        seen = self._last_seen()
        events: List[MembershipEvent] = []
        # leaves first (frees slots for same-boundary arrivals), sorted for
        # determinism, clamped at min_live — overdue members past the clamp
        # stay members and re-qualify at the next boundary
        live = set(self._members)
        for worker in sorted(self._members):
            last = seen.get(worker)
            if last is None:
                # never heartbeated: age runs from the first poll (grace)
                age, limit = now - self._first_poll, self.grace
            else:
                age, limit = max(now - last, 0.0), self.deadline
            if age > limit and len(live) > self.min_live:
                events.append(MembershipEvent("leave", epoch, worker))
                live.discard(worker)
        # arrivals: fresh heartbeats from non-members, rejoin before join
        # only by identity (ever-membership), capacity-deferred when full
        for worker in sorted(seen):
            if worker in live:
                continue
            if max(now - seen[worker], 0.0) > self.deadline:
                continue  # a stale stranger is not an arrival
            if len(live) >= self._pool_size:
                continue  # pool full: deferred until a slot frees up
            kind = "rejoin" if worker in self._ever else "join"
            events.append(MembershipEvent(kind, epoch, worker))
            live.add(worker)
            self._ever.add(worker)
        self._members = live
        return events
