"""Versioned control documents.

Port of ``matcha_tpu/serve/control.py`` (:1-143): the same fields, the
same verdicts, the same ``RESTART_EXIT``.  The operator's side of the hot-swap seam: a single JSON file
(``control.json`` next to the run) written with the atomic-rename
protocol (temp file in the same directory, then ``os.replace``) so the
trainer can never read a half-written document.  Documents are
*versioned*: the trainer applies a document exactly once, at the first
epoch boundary after its ``version`` exceeds the last applied one, and
journals a v6 ``control`` event for every decision — applied or
rejected — with the reason.  An invalid document is rejected whole:
no field of it is applied (never half-applied), the run continues on
its current knobs, and the rejection is journaled.

Two scopes, by what the change can reach without a recompile:

* **value scope** (``VALUE_FIELDS``) — applied in place at the epoch
  boundary as ControlKnobs / drift-monitor updates: ``budget`` (the
  ``plan.resolve_budget_swap`` re-weight), ``local_steps`` (the traced
  ``local_every`` gate), ``drift_tolerance`` / ``drift_patience``.
* **restart scope** (``RESTART_FIELDS``) — baked into compiled shapes
  (the staleness ring's ``[K, N, D]``) or controller construction, so
  the trainer checkpoints, journals, and exits with ``RESTART_EXIT``;
  the supervisor merges the field and relaunches from the checkpoint
  without charging the crash budget: ``staleness``,
  ``membership_hysteresis``, ``membership_bootstrap``.

``stop: true`` is the clean-shutdown document: checkpoint, journal,
drain, exit 0.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

from ..utils.atomicio import atomic_publish

__all__ = [
    "CONTROL_BASENAME",
    "RESTART_EXIT",
    "RESTART_FIELDS",
    "VALUE_FIELDS",
    "journal_control",
    "load_control",
    "validate_control",
    "write_control",
]

CONTROL_BASENAME = "control.json"

#: the deliberate-restart exit code — the control plane's process
#: contract between trainer and supervisor: distinct from every error
#: exit the interpreter or the loop can produce, so the supervisor can
#: tell a requested relaunch (uncharged) from a crash (budget-charged)
RESTART_EXIT = 43

# field → (python type(s), human-readable constraint, predicate)
VALUE_FIELDS: Dict[str, tuple] = {
    "budget": ((int, float), "in [0, 1]", lambda v: 0 <= v <= 1),
    "local_steps": (int, ">= 1", lambda v: v >= 1),
    "drift_tolerance": ((int, float), "> 0", lambda v: v > 0),
    "drift_patience": (int, ">= 1", lambda v: v >= 1),
}
RESTART_FIELDS: Dict[str, tuple] = {
    "staleness": (int, ">= 1", lambda v: v >= 1),
    "membership_hysteresis": (int, ">= 0", lambda v: v >= 0),
    "membership_bootstrap": (str, "'mean' or 'restore'",
                             lambda v: v in ("mean", "restore")),
}
_META_FIELDS = ("version", "stop")


def validate_control(raw) -> List[str]:
    """Every problem with a parsed control document (empty = valid).

    Validation is all-or-nothing by design: one bad field rejects the
    whole document, so a typo can never apply half an intent.
    """
    if not isinstance(raw, dict):
        return [f"control document must be a JSON object, got "
                f"{type(raw).__name__}"]
    problems = []
    version = raw.get("version")
    if not isinstance(version, int) or isinstance(version, bool) \
            or version < 1:
        problems.append(f"version must be an int >= 1, got {version!r}")
    stop = raw.get("stop", False)
    if not isinstance(stop, bool):
        problems.append(f"stop must be a bool, got {stop!r}")
    known = dict(VALUE_FIELDS)
    known.update(RESTART_FIELDS)
    for key, value in raw.items():
        if key in _META_FIELDS:
            continue
        if key not in known:
            problems.append(f"unknown field {key!r}")
            continue
        types, constraint, ok = known[key]
        if not isinstance(value, types) or isinstance(value, bool):
            problems.append(f"{key} must be {constraint}, got {value!r}")
        elif not ok(value):
            problems.append(f"{key} must be {constraint}, got {value!r}")
    return problems


def load_control(path: str) -> Tuple[Optional[dict], List[str]]:
    """``(raw_or_None, problems)`` — raw is None only when no document
    exists; an unparseable file is a present-but-invalid document."""
    if not os.path.exists(path):
        return None, []
    try:
        with open(path) as f:
            raw = json.load(f)
    except (json.JSONDecodeError, OSError) as e:
        return {}, [f"unreadable control document: {e}"]
    return raw, validate_control(raw)


def write_control(path: str, doc: dict) -> None:
    """Publish a control document atomically through the one publish
    seam (``utils.atomicio.atomic_publish``)."""
    problems = validate_control(doc)
    if problems:
        raise ValueError("refusing to write an invalid control document: "
                         + "; ".join(problems))
    atomic_publish(path, json.dumps(doc, indent=2, sort_keys=True) + "\n",
                   prefix=".control.")


def journal_control(journal_path: str, *, action: str, applied: bool,
                    reason: str, epoch: int, **extra) -> None:
    """Journal one control decision (v6 ``control`` event) from the
    *supervisor* side — the trainer side rides ``recorder.log_event``.
    Only call between trainer lifetimes: the journal has one writer at a
    time by contract."""
    from ..obs.journal import append_journal_record

    append_journal_record(journal_path, "control", action=action,
                          applied=applied, reason=reason, epoch=epoch,
                          **extra)
