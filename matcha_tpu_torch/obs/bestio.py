"""Best-effort observability IO: the fault-injectable fs seam and breaker.

Port of ``matcha_tpu/obs/bestio.py`` (:41-230).  The contract: **training
never blocks or dies on observability IO**.

* The **fs seam** — every observability write (the run journal, the
  per-host heartbeat files, the Recorder's CSVs and sidecars) opens and
  publishes files through :func:`get_fs` instead of the builtins.  In a
  run that is :class:`DirectFS`.  The chaos harness threads
  :class:`FaultyFS` under the same seam — through :func:`install_fs` in
  the process, or the ``MATCHA_CHAOS_FS`` environment variable across the
  supervisor's process boundary — to inject ENOSPC and hung or slow
  writes into the daemon without patching it.

* The **sink breaker** — :class:`BestEffortSink` wraps one observability
  write path in bounded retry + backoff with a per-attempt deadline.  A
  write that fails retries within the deadline and then trips the breaker:
  later writes are *dropped* for a cooldown window instead of retried
  inline.  A write that hangs is abandoned to its daemon thread, so the
  train loop stalls at most one deadline.  Every degrade/restore
  transition is reported through :meth:`BestEffortSink.drain` as a
  ``recovery`` journal payload (scope ``io``).

``wall_clock`` is the one clock the heartbeat emitter and the one-shot
journal appender stamp: ``time.time()`` in a run, skewed by
``MATCHA_CHAOS_CLOCK_SKEW`` seconds under the chaos harness (the
clock-skew injector).  The environment variables are the JAX package's,
so one spec arms either package's trainer.
"""

from __future__ import annotations

import errno
import json
import os
import threading
import time
from typing import Callable, List, Optional

__all__ = ["ENV_FS", "ENV_SKEW", "DirectFS", "FaultyFS", "get_fs",
           "install_fs", "wall_clock", "BestEffortSink"]

ENV_FS = "MATCHA_CHAOS_FS"
ENV_SKEW = "MATCHA_CHAOS_CLOCK_SKEW"


class DirectFS:
    """The production seam: builtins, nothing else."""

    def open(self, path: str, mode: str = "r"):
        return open(path, mode)

    def replace(self, src: str, dst: str) -> None:
        os.replace(src, dst)


class FaultyFS(DirectFS):
    """A seam that faults a window of matching operations.

    ``mode``: ``enospc`` raises ``OSError(ENOSPC)``; ``slow`` sleeps
    ``delay`` seconds per op (a hung sink is a slow one with a delay
    longer than anyone waits).  ``match`` is a path substring gate
    (``"health/"`` targets heartbeat files only); ``after`` matching ops
    pass clean before the window opens; ``count`` ops fault before the
    device heals (``-1`` = never heals).
    """

    def __init__(self, mode: str = "enospc", match: str = "",
                 after: int = 0, count: int = -1, delay: float = 0.0):
        if mode not in ("enospc", "slow"):
            raise ValueError(f"unknown FaultyFS mode {mode!r}")
        self.mode = mode
        self.match = str(match)
        self.after = int(after)
        self.count = int(count)
        self.delay = float(delay)
        self.ops = 0  # matching ops seen

    def _trip(self, path: str) -> None:
        if self.match and self.match not in str(path):
            return
        self.ops += 1
        n = self.ops - self.after  # 1-based position inside the window
        if n <= 0 or (self.count >= 0 and n > self.count):
            return
        if self.mode == "slow":
            time.sleep(self.delay)
            return
        raise OSError(errno.ENOSPC, f"chaos: no space left on device "
                                    f"(injected, op {self.ops})", path)

    def open(self, path: str, mode: str = "r"):
        if "w" in mode or "a" in mode or "x" in mode or "+" in mode:
            self._trip(path)
        return super().open(path, mode)

    def replace(self, src: str, dst: str) -> None:
        self._trip(dst)
        super().replace(src, dst)


_fs: Optional[DirectFS] = None


def get_fs() -> DirectFS:
    """The active fs seam — ``DirectFS`` unless the harness installed a
    faulty one (``install_fs``) or armed ``MATCHA_CHAOS_FS`` before this
    process first asked (the supervisor→trainer injection path).  A
    malformed spec falls back to ``DirectFS``: chaos never breaks a run."""
    global _fs
    if _fs is None:
        raw = os.environ.get(ENV_FS)
        if raw:
            try:
                _fs = FaultyFS(**json.loads(raw))
            except (ValueError, TypeError):
                _fs = DirectFS()
        else:
            _fs = DirectFS()
    return _fs


def install_fs(fs: Optional[DirectFS]) -> None:
    """Swap the seam in-process (the harness, tests); ``None`` re-reads
    the environment on next use."""
    global _fs
    _fs = fs


def wall_clock() -> float:
    """``time.time()`` plus the injected skew (0 in a run)."""
    try:
        skew = float(os.environ.get(ENV_SKEW) or 0.0)
    except ValueError:
        skew = 0.0
    return max(time.time() + skew, 0.0)


class BestEffortSink:
    """Bounded-retry, deadline-capped, breaker-guarded write wrapper.

    :meth:`write` never raises and never blocks longer than
    ``(retries + 1) * deadline`` plus the backoff sleeps; once degraded it
    returns immediately (dropping the write) until ``cooldown`` elapses or
    a probe write succeeds.  Degrade/restore transitions accumulate as
    ``recovery``-event payloads; callers drain and journal them.
    """

    def __init__(self, name: str, deadline: float = 5.0, retries: int = 1,
                 backoff: float = 0.1, cooldown: float = 30.0):
        self.name = str(name)
        self.deadline = float(deadline)
        self.retries = max(int(retries), 0)
        self.backoff = float(backoff)
        self.cooldown = float(cooldown)
        self.degraded = False
        self.dropped = 0
        self._until = 0.0
        self._hung: Optional[threading.Thread] = None
        self._events: List[dict] = []

    def _note(self, action: str, reason: str) -> None:
        self._events.append({"scope": "io", "action": action,
                             "sink": self.name, "reason": reason})

    def _degrade(self, reason: str) -> None:
        self._until = time.monotonic() + self.cooldown
        if not self.degraded:
            self.degraded = True
            self._note("degraded", reason)

    def write(self, fn: Callable[[], object]) -> bool:
        """Run one observability write; ``True`` iff it landed."""
        if self._hung is not None:
            if self._hung.is_alive():
                # a previous attempt is still stuck in the kernel: do not
                # stack a second stall on top of it — drop and stay loud
                self.dropped += 1
                self._degrade(f"{self.name}: previous write still hung "
                              f"past the {self.deadline:.1f}s deadline")
                return False
            self._hung = None
        if self.degraded and time.monotonic() < self._until:
            self.dropped += 1
            return False  # breaker open: drop until the cooldown probe
        outcome: dict = {}

        def _target():
            try:
                fn()
                outcome["ok"] = True
            # the best-effort contract: ANY observability-write failure
            # degrades loudly instead of killing the training process
            except Exception as e:  # noqa: BLE001
                outcome["error"] = repr(e)

        for attempt in range(self.retries + 1):
            worker = threading.Thread(
                target=_target, daemon=True,
                name=f"bestio-{self.name}")
            worker.start()
            worker.join(self.deadline)
            if worker.is_alive():
                self._hung = worker  # abandoned; skip fast while stuck
                self.dropped += 1
                self._degrade(f"{self.name}: write exceeded the "
                              f"{self.deadline:.1f}s deadline (hung IO)")
                return False
            if outcome.get("ok"):
                if self.degraded:
                    self.degraded = False
                    self._note("restored",
                               f"{self.name}: write succeeded again after "
                               f"{self.dropped} dropped write(s)")
                    self.dropped = 0
                return True
            if attempt < self.retries:
                time.sleep(self.backoff * (2 ** attempt))
                outcome = {}
        self.dropped += 1
        self._degrade(f"{self.name}: write failed after "
                      f"{self.retries + 1} attempt(s): "
                      f"{outcome.get('error')}")
        return False

    def drain(self) -> List[dict]:
        """Pop the pending degrade/restore payloads (scope ``io``)."""
        events, self._events = self._events, []
        return events
