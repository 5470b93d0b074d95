"""The pinned invariant suite every chaos trial is judged against.

Port of ``matcha_tpu/chaos/invariants.py`` (:1-191): the same families,
the same expectations, the same violation strings.

A trial passes only when ALL invariants hold (``check_invariants``
returns an empty list).  The suite is deliberately family-aware: a kill
trial is *supposed* to charge exactly one restart, a durable-state trial
is supposed to charge zero (the in-process recovery ladder absorbs it),
and each family must leave its own recovery evidence in the journal —
recovery that leaves no record is indistinguishable from silent
corruption, which is the failure mode this whole subsystem exists to
kill.

The invariants:

1. **terminal-loud** — the run completed (rc 0) or aborted with an
   ``abort`` control event on the record; never a silent nonzero death.
2. **journal-valid** — the final journal parses strictly (no repair) and
   every event validates against the schema registry.
3. **restart accounting** — deliberate relaunches are never charged;
   each family's expected charge count is exact.
4. **recovery evidence** — the family's expected ``recovery`` event
   (scope/action) is present.
5. **control-whole** — every ``apply`` of one control version carries
   identical fields: a document is never observed half-applied.
6. **promotion-pointer** — when anything was promoted, the manifest
   verifies end-to-end (never dangles).
7. **twin fidelity** — when the trial has an uninterrupted twin, the
   final epoch row matches it exactly (float equality, not approx).
"""

from __future__ import annotations

import os
from typing import List, Optional

__all__ = ["EXPECTED_RESTARTS", "EXPECTED_RECOVERY", "final_epoch_row",
           "check_invariants"]

#: family → exact restarts the supervisor must charge
EXPECTED_RESTARTS = {
    "ckpt_bitflip": 0, "ckpt_missing_file": 0, "ckpt_stale_tmp": 0,
    "journal_torn_tail": 0, "journal_midstream": 0, "control_torn_tmp": 0,
    "kill_epoch_boundary": 1, "kill_mid_save": 1, "kill_mid_promote": 1,
    "kill_mid_control": 1,
    "io_enospc": 0, "io_slow": 0, "clock_skew": 0,
    "spec_torn_tmp": 0,
}

#: family → (scope, action) of the recovery event the journal must hold;
#: None = the family leaves no mandatory recovery record (it must simply
#: be survived cleanly)
EXPECTED_RECOVERY = {
    "ckpt_bitflip": ("checkpoint", "quarantine"),
    "ckpt_missing_file": ("checkpoint", "quarantine"),
    "ckpt_stale_tmp": None,
    "journal_torn_tail": ("journal", "repair"),
    "journal_midstream": ("journal", "salvage"),
    "control_torn_tmp": None,
    "kill_epoch_boundary": None, "kill_mid_save": None,
    "kill_mid_promote": None, "kill_mid_control": None,
    "io_enospc": ("io", "degraded"),
    "io_slow": ("io", "degraded"),
    "clock_skew": None,
    # the squatter must simply be sailed past (mkstemp publish): no
    # recovery record, no restart — the relaunch just works
    "spec_torn_tmp": None,
}


def final_epoch_row(events) -> Optional[tuple]:
    """The last epoch event's metric row — the twin-fidelity comparand
    (same shape the serve plane's crash-parity test pins)."""
    epochs = [e for e in events if e.get("kind") == "epoch"]
    if not epochs:
        return None
    last = max(epochs, key=lambda e: e["epoch"])
    return (last["epoch"], last["train_loss"], last["train_acc"],
            last["test_acc_mean"], last["disagreement"])


def check_invariants(trial: dict) -> List[str]:
    """Every violated invariant for one finished trial (empty = pass).

    ``trial`` is the dict ``campaign.run_trial`` builds: ``family``,
    ``rc``, ``restarts_used``, ``journal_path``, ``serving_dir``,
    ``twin_row`` (optional), ``expect_epochs``.
    """
    from ..obs.journal import read_journal, validate_event

    family = trial["family"]
    violations: List[str] = []

    # 2. journal-valid (parsed first: most later checks read the events)
    try:
        events = read_journal(trial["journal_path"])
    except (ValueError, OSError) as e:
        return [f"journal-valid: final journal unreadable without "
                f"repair: {e}"] + (
            [] if trial["rc"] == 0 else
            [f"terminal-loud: rc {trial['rc']} with unreadable journal"])
    for i, event in enumerate(events):
        problems = validate_event(event)
        if problems:
            violations.append(f"journal-valid: event {i} "
                              f"({event.get('kind')!r}): {problems[0]}")
            break

    # 1. terminal-loud
    aborted = any(e.get("kind") == "control" and e.get("action") == "abort"
                  for e in events)
    if trial["rc"] != 0 and not aborted:
        violations.append(f"terminal-loud: rc {trial['rc']} with no abort "
                          f"event on the record — a silent death")

    # completion: the configured final epoch must be on the record (an
    # aborted-loudly run fails restart accounting instead, below)
    row = final_epoch_row(events)
    if trial["rc"] == 0 and (row is None or
                             row[0] != trial["expect_epochs"] - 1):
        violations.append(
            f"terminal-loud: rc 0 but the final epoch on record is "
            f"{None if row is None else row[0]}, expected "
            f"{trial['expect_epochs'] - 1}")

    # 3. restart accounting (deliberate relaunches are journaled as
    # `relaunch`, crashes as `restart` — only the latter are charged)
    expected = EXPECTED_RESTARTS[family]
    if trial["restarts_used"] != expected:
        violations.append(
            f"restart-accounting: {family} charged "
            f"{trial['restarts_used']} restart(s), expected {expected}")
    relaunches = [e for e in events if e.get("kind") == "control"
                  and e.get("action") == "relaunch"]
    restarts = [e for e in events if e.get("kind") == "control"
                and e.get("action") == "restart"]
    if len(restarts) < trial["restarts_used"]:
        violations.append(
            f"restart-accounting: {trial['restarts_used']} restart(s) "
            f"charged but only {len(restarts)} journaled")
    del relaunches  # deliberate relaunches exist on the record; never charged

    # 4. recovery evidence
    want = EXPECTED_RECOVERY[family]
    if want is not None:
        scope, action = want
        hits = [e for e in events if e.get("kind") == "recovery"
                and e.get("scope") == scope and e.get("action") == action]
        if not hits:
            violations.append(
                f"recovery-evidence: {family} left no recovery event "
                f"(scope={scope!r}, action={action!r}) in the journal")

    if family == "control_torn_tmp":
        torn_version = (trial.get("evidence") or {}).get("version")
        ghost = [e for e in events if e.get("kind") == "control"
                 and e.get("version") == torn_version]
        if ghost:
            violations.append(
                f"recovery-evidence: the torn control tempfile (version "
                f"{torn_version}) was observed by the watcher — a torn "
                f"publish must be invisible")

    # 5. control-whole: one version, one set of applied fields — always
    by_version = {}
    for e in events:
        if e.get("kind") != "control" or e.get("action") != "apply":
            continue
        v = e.get("version")
        fields = e.get("fields")
        if v in by_version and by_version[v] != fields:
            violations.append(
                f"control-whole: version {v} applied with differing "
                f"fields: {by_version[v]!r} vs {fields!r}")
        by_version.setdefault(v, fields)

    # 6. promotion pointer never dangles
    serving = trial.get("serving_dir")
    if serving and os.path.exists(os.path.join(serving, "MANIFEST.json")):
        from ..serve.promote import PromotionTampered, verify_promoted

        try:
            verify_promoted(serving)
        except PromotionTampered as e:
            violations.append(f"promotion-pointer: {e}")

    # 7. twin fidelity
    twin = trial.get("twin_row")
    if twin is not None and row is not None and tuple(twin) != row:
        violations.append(
            f"twin-fidelity: final epoch row {row} differs from the "
            f"uninterrupted twin's {tuple(twin)}")
    return violations
