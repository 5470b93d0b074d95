"""Chaos taps: seeded kill barriers inside the daemon's own code paths.

Port of ``matcha_tpu/chaos/taps.py`` (:1-103): the same spec, the same
barriers, the same environment variable, so one spec arms either
package's trainer.  The campaign's kill injector cannot kill a process
"mid-save" from the outside with any determinism: the window is
milliseconds wide and moves with start-up times.  Instead the code
carries four **taps** at exactly the barriers the campaign schedules
faults for:

* ``epoch_boundary``  — top of the train loop's epoch iteration;
* ``mid_save``        — inside ``save_checkpoint``, after the generation
  committed but before the digest/schedule sidecars land (the torn-save
  state: a step directory with no integrity sidecar);
* ``mid_promote``     — inside the promotion plane's atomic-JSON writer,
  after the tempfile is written but before ``os.replace`` publishes it
  (the torn-tempfile state: a stale ``.tmp`` next to a valid pointer);
* ``mid_control``     — inside the trainer harness, after a control
  document's value fields applied in memory but before the decision
  journals (the worst place to die: recovery must still never observe a
  half-applied document).

A tap is a **no-op unless armed**: ``maybe_kill`` reads
``MATCHA_CHAOS_KILL`` (JSON) once per process and costs one global-dict
check per call afterwards.  The armed spec names the barrier, which
occurrence fires (``count``), the signal, and a **marker file**: the tap
creates the marker *before* raising the signal, and refuses to fire when
the marker already exists — so a supervised relaunch of the same trainer
(same environment) runs the same barrier clean instead of crash-looping
into the restart budget.  The marker is what makes one scheduled fault
mean ONE fault across process lifetimes.

Spec format (all fields required except ``signal``)::

    MATCHA_CHAOS_KILL='{"barrier": "mid_save", "count": 1,
                        "signal": "KILL", "marker": "/tmp/t1/fired"}'
"""

from __future__ import annotations

import json
import os
import signal as _signal

__all__ = ["ENV_KILL", "BARRIERS", "maybe_kill", "reset"]

ENV_KILL = "MATCHA_CHAOS_KILL"

#: every barrier a kill spec may name — the taps below exist 1:1
BARRIERS = ("epoch_boundary", "mid_save", "mid_promote", "mid_control")

_UNPARSED = object()
_spec = _UNPARSED  # parsed-once cache: None = unarmed
_remaining = 0


def reset() -> None:
    """Re-read the environment on next call (tests / in-process reuse)."""
    global _spec, _remaining
    _spec = _UNPARSED
    _remaining = 0


def _load():
    global _spec, _remaining
    raw = os.environ.get(ENV_KILL)
    if not raw:
        _spec = None
        return
    try:
        spec = json.loads(raw)
        barrier = spec["barrier"]
        marker = spec["marker"]
    except (ValueError, TypeError, KeyError):
        _spec = None  # malformed spec: chaos must never break a real run
        return
    if barrier not in BARRIERS:
        _spec = None
        return
    _spec = {"barrier": barrier, "marker": marker,
             "signal": str(spec.get("signal", "KILL")).upper()}
    _remaining = max(int(spec.get("count", 1)), 1)


def maybe_kill(barrier: str) -> None:
    """Die here if an armed kill spec names this barrier (and has not
    already fired — the marker file is the cross-lifetime memory)."""
    global _remaining
    if _spec is _UNPARSED:
        _load()
    if _spec is None or _spec["barrier"] != barrier:
        return
    if os.path.exists(_spec["marker"]):
        return  # already fired in a previous lifetime: run clean now
    _remaining -= 1
    if _remaining > 0:
        return
    # marker BEFORE the signal: if the kill lands, the relaunch sees it;
    # exclusive-create so two racing processes cannot both fire
    try:
        fd = os.open(_spec["marker"], os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        os.close(fd)
    except OSError:
        return
    sig = getattr(_signal, f"SIG{_spec['signal']}", _signal.SIGKILL)
    os.kill(os.getpid(), sig)
