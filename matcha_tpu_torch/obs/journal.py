"""The unified run journal: a schema-versioned JSONL event stream.

Port of the writer side of ``matcha_tpu/obs/journal.py``: the schema
(``SCHEMA_VERSION``, the kind sets and ``REQUIRED_FIELDS``, :1-187), the
envelope (``make_event``, ``validate_event``), the incremental sink
(``Journal``), the readers the Recorder's resume needs (``read_journal``,
``salvage_journal``, ``count_journal_lines``), the readers of the health
plane and the drift monitor (``fmt_value`` :188, ``read_journal_tail``
:385, ``resolve_journal_path`` :433, ``epoch_series`` :467),
``latest_per_epoch`` and ``append_journal_record`` (:477).  The report
tools (``obs_tpu.py``) stay with the JAX package and read the port's
journals unchanged.

One file per run — ``events.jsonl`` next to the Recorder's CSVs.  One JSON
object per line, append-only.  Every event carries

* ``v``     — schema version (``SCHEMA_VERSION``),
* ``kind``  — one of ``EVENT_KINDS`` (unknown kinds are a validation
  error),
* ``t``     — seconds since the writing process's start (standalone
  appenders use absolute unix time).  A resumed run restarts the clock,
  so readers order by **line position**, never by ``t``,

plus kind-specific payload fields (``REQUIRED_FIELDS``).  A resumed run
appends after the pre-crash events verbatim; replayed epochs journal again,
and readers take the **last** event per epoch (:func:`latest_per_epoch`).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Iterable, List, Optional, Sequence

__all__ = ["SCHEMA_VERSION", "ACCEPTED_VERSIONS", "EVENT_KINDS",
           "FAULT_KINDS", "V2_KINDS", "V3_KINDS", "V4_KINDS", "V5_KINDS",
           "V6_KINDS", "V7_KINDS", "KIND_MIN_VERSION", "REQUIRED_FIELDS",
           "fmt_value", "make_event", "validate_event", "Journal",
           "read_journal", "salvage_journal", "read_journal_tail",
           "count_journal_lines", "resolve_journal_path",
           "latest_per_epoch", "epoch_series", "append_journal_record"]

#: v2 adds only new kinds — ``compile`` (the cost ledger's
#: program introspection) and ``profile`` (overlap-truth trace analysis).
#: v3 is additive again: ``heartbeat`` (the live health plane's
#: per-host liveness/progress record, mirrored from the per-host heartbeat
#: files under ``health/``) and ``anomaly`` (a streaming detector's verdict
#: with an attributed cause).  v4 adds ``attribution`` — the
#: link-level cost estimator's per-matching seconds fit (obs.attribution).
#: v5 adds ``backend`` — the gossip-backend selection record
#: ``gossip_backend="auto"`` resolves through (plan.cost
#: choose_gossip_backend: chosen backend, per-backend byte models, the
#: measured-vs-ceiling gate inputs), journaled so drift replay can score
#: the choice against what the run measured.  v6 adds the run
#: controller's plane (matcha_tpu.serve): ``control`` — one hot-swap
#: decision per control document (applied or rejected, with the reason and
#: the epoch boundary it landed on), and ``promotion`` — one checkpoint-
#: promotion pipeline decision (promote / rollback / retain with the
#: gating held-out metric).  Every pre-bump event validates verbatim under
#: the v6 reader — old journals stay first-class sources.
SCHEMA_VERSION = 7
ACCEPTED_VERSIONS = frozenset({1, 2, 3, 4, 5, 6, 7})

#: Every kind a journal may contain.  The five fault kinds keep their
#: historical ``faults.json`` names so the view stays a pure filter.
FAULT_KINDS = frozenset({
    "plan", "healed", "rollback", "alpha_rederived", "emergency_checkpoint",
})
#: Kinds introduced by schema v2 — invalid inside a v1 event (a v1 writer
#: cannot have produced them; seeing one means the envelope is lying).
#: ``membership`` joins additively: elastic join/leave/rejoin
#: reconciliations at epoch boundaries, carrying the re-derived α/ρ so
#: drift replay re-bases exactly where the live monitor did.
V2_KINDS = frozenset({"compile", "profile", "membership"})
#: Kinds introduced by schema v3 — invalid inside a v1/v2 event
#: for the same reason.  ``heartbeat`` carries per-host progress + the
#: per-worker stats the anomaly detectors read; ``anomaly`` carries one
#: detector verdict (subject + attributed cause).
V3_KINDS = frozenset({"heartbeat", "anomaly"})
#: Kinds introduced by schema v4 — ``attribution`` carries one
#: run of the per-matching cost estimator: the ridge fit of journaled
#: per-epoch comm seconds against the reconstructed activation design
#: matrix, with its identifiability verdict (obs.attribution).
V4_KINDS = frozenset({"attribution"})
#: Kinds introduced by schema v5 — ``backend`` carries one
#: gossip-backend auto-selection record (requested/chosen/reason + the
#: per-backend stream-byte entries and gate inputs from plan.cost).
V5_KINDS = frozenset({"backend"})
#: Kinds introduced by schema v6 — the run controller's plane:
#: ``control`` journals every hot-swap decision (an applied or rejected
#: control document at an epoch boundary), ``promotion`` every checkpoint
#: promotion / rollback the serving pipeline makes.
V6_KINDS = frozenset({"control", "promotion"})
#: Kinds introduced by schema v7 — ``recovery`` journals one
#: durable-state recovery action: a corrupt checkpoint generation
#: quarantined (scope ``checkpoint``), a torn/corrupt journal repaired or
#: salvaged (scope ``journal``), an observability sink degraded to
#: best-effort or restored (scope ``io``), a restart-budget credit
#: refilled after sustained progress (scope ``budget``).  Recovery that
#: does not journal is recovery that silently rewrites history — the
#: chaos harness's invariants reject exactly that.
V7_KINDS = frozenset({"recovery"})
#: Minimum envelope version per kind — the generalized "a vK kind claiming
#: an earlier v is a lying envelope" rule.
KIND_MIN_VERSION: Dict[str, int] = {
    **{k: 2 for k in V2_KINDS}, **{k: 3 for k in V3_KINDS},
    **{k: 4 for k in V4_KINDS}, **{k: 5 for k in V5_KINDS},
    **{k: 6 for k in V6_KINDS}, **{k: 7 for k in V7_KINDS}}
EVENT_KINDS = frozenset({
    "run_start", "resume", "epoch", "telemetry", "drift", "checkpoint",
    "retrace", "bench",
}) | FAULT_KINDS | V2_KINDS | V3_KINDS | V4_KINDS | V5_KINDS | V6_KINDS \
    | V7_KINDS

#: Kind-specific payload keys an event must carry to validate.  Kinds not
#: listed need only the envelope (v / kind / t).
REQUIRED_FIELDS: Dict[str, frozenset] = {
    "run_start": frozenset({"config", "predicted"}),
    "epoch": frozenset({"epoch", "epoch_time", "comp_time", "comm_time",
                        "train_loss", "disagreement"}),
    "telemetry": frozenset({"epoch", "steps", "disagreement_mean",
                            "disagreement_last", "wire_bytes",
                            "matchings_mean", "alive_mean"}),
    "drift": frozenset({"epoch", "predicted_factor", "measured_factor",
                        "tolerance", "streak"}),
    "checkpoint": frozenset({"epoch", "path"}),
    "retrace": frozenset({"label", "traces"}),
    "bench": frozenset({"record"}),
    # v2: one per distinct compiled program (obs.costs.CostLedger) — the
    # extracted cost/footprint ledger the roofline consumes
    "compile": frozenset({"label", "fingerprint", "compile_seconds",
                          "flops", "hbm_bytes", "peak_bytes"}),
    # v2: one per parsed profiler trace (obs.xprof) — executed-kernel
    # phase attribution and the comm/comp overlap fraction
    "profile": frozenset({"source", "comm_seconds", "compute_seconds",
                          "overlap_seconds", "overlap_fraction"}),
    # v2: one per elastic-membership reconciliation — the old and
    # new live sets, what triggered the change, and the α/ρ the schedule
    # was re-folded to (``replanned`` False while hysteresis defers the
    # fold; ``predicted`` carries the re-based composition for drift replay)
    "membership": frozenset({"epoch", "old_alive", "new_alive", "trigger",
                             "alpha", "rho", "replanned"}),
    # v3: one per host per epoch boundary (obs.health) — step
    # progress, step-time EWMA, the comm/compute split, peak footprint from
    # the cost ledger, and the per-worker stats the detectors consume
    # (``workers`` maps worker id -> {slot, participation, disagreement})
    "heartbeat": frozenset({"host", "epoch", "step", "step_time",
                            "step_time_ewma", "comp_time", "comm_time",
                            "peak_bytes", "workers"}),
    # v3: one per detector verdict (obs.anomaly) — ``subject`` is the
    # worker or host being accused, ``cause`` the attributed failure mode
    "anomaly": frozenset({"epoch", "subject", "cause", "value",
                          "threshold"}),
    # v4: one per estimator run (obs.attribution) — the
    # per-matching seconds fit.  ``per_matching_seconds`` carries null for
    # unidentifiable matchings (``identifiable`` is the per-matching mask);
    # ``source`` names where the comm series came from (journal epochs,
    # heartbeats, or a planted scenario)
    "attribution": frozenset({"epochs_used", "matchings", "identifiable",
                              "base_seconds", "per_matching_seconds",
                              "source"}),
    # v5: one per gossip-backend resolution (communicator.decen
    # resolve_gossip_backend) — what `auto` chose and why, with the
    # planner's per-backend byte models when the selection actually ran
    "backend": frozenset({"requested", "chosen", "reason"}),
    # v6: one per control-document decision (serve.control) —
    # ``action`` names what the doc asked for (budget / local_steps /
    # staleness / stop / ...), ``applied`` whether it took effect, and
    # ``reason`` why (validation failure text, or the applied summary).
    # Rejected docs journal too: "never half-applied" is only auditable
    # if the refusal is on the record.
    "control": frozenset({"action", "applied", "reason", "epoch"}),
    # v6: one per promotion-pipeline decision (serve.promote) —
    # ``action`` is promote / rollback / retain, ``metric`` the held-out
    # eval value that gated it.
    "promotion": frozenset({"action", "epoch", "metric"}),
    # v7: one per durable-state recovery action — ``scope``
    # names the plane (checkpoint / journal / io / budget), ``action``
    # what was done (quarantine / repair / salvage / degraded / restored /
    # refill), ``reason`` why, in words.  Payload extras ride per scope
    # (the quarantined path, the salvaged line count, the sink name) but
    # the pinned triple is what every auditor can rely on.
    "recovery": frozenset({"scope", "action", "reason"}),
}


def fmt_value(v, digits: int = 4) -> str:
    """Table-cell formatter of the health and drift renderers: ``None``
    renders ``-``, floats general-format."""
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.{digits}g}"
    return str(v)


def make_event(kind: str, t: float, **fields) -> dict:
    """Envelope + payload.  ``t`` is the journal's run-relative clock."""
    return {"v": SCHEMA_VERSION, "kind": kind, "t": float(t), **fields}


def validate_event(event: dict) -> List[str]:
    """Schema check; returns human-readable problems (empty = valid)."""
    problems: List[str] = []
    if not isinstance(event, dict):
        return [f"event is {type(event).__name__}, not an object"]
    v = event.get("v")
    if v not in ACCEPTED_VERSIONS:
        problems.append(f"v={v!r} (want one of {sorted(ACCEPTED_VERSIONS)})")
    kind = event.get("kind")
    if kind not in EVENT_KINDS:
        problems.append(f"unknown kind {kind!r}")
    elif isinstance(v, int) and v < KIND_MIN_VERSION.get(kind, 1):
        problems.append(f"{kind} is a v{KIND_MIN_VERSION.get(kind, 1)} "
                        f"kind but event claims v={v}")
    t = event.get("t")
    if not isinstance(t, (int, float)) or not t >= 0:
        problems.append(f"t={t!r} is not a non-negative number")
    missing = REQUIRED_FIELDS.get(kind, frozenset()) - set(event)
    if missing:
        problems.append(f"{kind} event missing {sorted(missing)}")
    return problems


def _dump_line(event: dict) -> str:
    return json.dumps(event, sort_keys=True, separators=(",", ":")) + "\n"


class Journal:
    """Incremental JSONL sink over an in-memory event list.

    The Recorder owns the list and calls :meth:`flush` at its save cadence;
    only events past the high-water mark are appended (O(new) per flush,
    the same contract as the append-only CSVs).  ``rewrite=True`` truncates
    first — a *fresh* run into a reused folder must not extend a previous
    run's journal, exactly like the CSV truncation; a *resumed* run flushes
    without rewrite so the pre-crash history survives verbatim.
    """

    def __init__(self, path: str):
        self.path = path
        self._flushed = 0

    def mark_flushed(self, count: int) -> None:
        """Pre-crash events reloaded from disk are already on disk."""
        self._flushed = int(count)

    def flush(self, events: Sequence[dict], rewrite: bool = False) -> int:
        """Write pending events; returns how many lines were written.
        IO goes through the ``obs.bestio`` fs seam."""
        from .bestio import get_fs

        fs = get_fs()
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        if rewrite:
            self._flushed = 0
        pending = list(events[self._flushed:])
        if rewrite or not os.path.exists(self.path):
            # truncate + full write: atomic via the blessed publish seam
            # so a crash mid-dump cannot leave half a journal where a
            # whole one existed
            from ..utils.atomicio import atomic_publish

            def _dump_all(f, events=tuple(events)):
                for e in events:
                    f.write(_dump_line(e))
            atomic_publish(self.path, _dump_all, prefix=".events.")
        elif pending:
            with fs.open(self.path, "a") as f:
                for e in pending:
                    f.write(_dump_line(e))
        self._flushed = len(events)
        return len(pending) if not rewrite else len(events)


def read_journal(path: str, repair: bool = False) -> List[dict]:
    """Parse a journal file; loud on malformed lines (line number named).

    ``repair=True`` tolerates exactly one failure mode: a malformed
    **final** line — the partial tail a crash mid-append leaves behind
    (the append path cannot be atomic the way the rewrite path is).  The
    truncated tail is dropped and the parsed prefix returned; a malformed
    line anywhere *else* is real corruption and still raises.  A caller
    that repairs must not blindly append after the broken tail (the file
    would then be broken mid-stream forever) — ``Recorder.load_previous``
    schedules a full rewrite when the parsed count disagrees with the
    file (see there).
    """
    events: List[dict] = []
    lines = []
    # binary read + per-line decode: a line a bad disk filled with
    # non-UTF-8 bytes is a malformed *line* (same contract as bad JSON),
    # never a reader crash that takes the whole parseable file with it
    with open(path, "rb") as f:
        for lineno, raw in enumerate(f, 1):
            if raw.strip():
                lines.append((lineno, raw.strip()))
    for i, (lineno, line) in enumerate(lines):
        try:
            events.append(json.loads(line.decode("utf-8")))
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            if repair and i == len(lines) - 1:
                break  # crash-truncated tail: drop it, keep the prefix
            raise ValueError(f"{path}:{lineno}: malformed journal line "
                             f"({e})") from e
    return events


def salvage_journal(path: str) -> tuple:
    """Salvage-prefix-and-quarantine for a journal corrupt **mid-stream**
    (the case ``read_journal(repair=True)`` deliberately still raises on).

    Returns ``(events, quarantine_path, problem)``: the valid prefix up to
    the first malformed line, the path the damaged original was renamed
    aside to (``events.jsonl.corrupt-N`` — evidence, never deleted), and a
    one-line description of what was wrong.  ``quarantine_path`` is
    ``None`` when the file parses clean (nothing to salvage; events are
    the whole file, tail-repaired).

    The contract this exists for: a resumed lifetime must not *brick* on
    a journal a previous crash (or a bad disk) corrupted — it salvages
    the readable history, moves the damaged file out of the append path,
    journals a ``recovery`` event (the caller's job — Recorder.load_previous
    does), and rewrites the stream whole.  Silent truncation without the
    quarantine would be indistinguishable from history rewriting, which
    is exactly what the chaos invariants reject.
    """
    events: List[dict] = []
    problem = None
    with open(path, "rb") as f:
        lines = [(no, raw.strip()) for no, raw in enumerate(f, 1)
                 if raw.strip()]
    for i, (lineno, line) in enumerate(lines):
        try:
            events.append(json.loads(line.decode("utf-8")))
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            if i == len(lines) - 1:
                problem = (f"line {lineno}: crash-truncated tail "
                           f"dropped ({e})")
                return events, None, problem
            problem = (f"line {lineno}: mid-stream corruption ({e}); "
                       f"salvaged the {len(events)}-event prefix")
            break
    if problem is None:
        return events, None, None
    n = 1
    while os.path.exists(f"{path}.corrupt-{n}"):
        n += 1
    quarantine = f"{path}.corrupt-{n}"
    os.replace(path, quarantine)
    return events, quarantine, problem


def _tail_lines(f, n: int, block: int) -> List[bytes]:
    """Last ``n`` non-empty lines of an opened binary file, reading only
    tail blocks.  The stop condition counts *usable* lines: non-empty,
    and not the first fragment of the window (a partial line when the
    window starts mid-file), so blank lines cost extra block reads but
    never shrink the result below the ``n`` lines the file holds."""
    if n <= 0:
        return []
    f.seek(0, os.SEEK_END)
    pos = f.tell()
    data = b""
    while True:
        lines = data.split(b"\n")
        usable = lines[1:] if pos > 0 else lines
        nonempty = [ln for ln in usable if ln.strip()]
        if pos == 0 or len(nonempty) >= n:
            return nonempty[-n:]
        step = min(block, pos)
        pos -= step
        f.seek(pos)
        data = f.read(step) + data


def read_journal_tail(path: str, n: int, block: int = 65536) -> List[dict]:
    """The last ``n`` events of a journal by a bounded reverse read:
    O(tail bytes), not O(run length).

    A malformed **final** line (the partial tail of a crash, or of a
    writer appending right now) is dropped; a malformed line anywhere
    earlier in the window raises: it is corruption, not a torn append."""
    if n <= 0:
        return []
    events: List[dict] = []
    with open(path, "rb") as f:
        # one line of slack: a dropped partial tail still leaves n events
        lines = _tail_lines(f, n + 1, block)
    for i, raw in enumerate(lines):
        try:
            events.append(json.loads(raw.decode("utf-8")))
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            if i == len(lines) - 1:
                break
            raise ValueError(
                f"{path}: malformed journal line in tail window ({e})"
            ) from e
    return events[-n:]


def count_journal_lines(path: str) -> int:
    """Non-blank line count of a journal, torn-tail tolerant.

    The cheap "how many records made it to disk" probe (recorder
    flush-accounting, tests).  Reads in **binary**: a crash mid-append can
    leave a non-UTF-8 partial tail, and a text-mode count would raise
    UnicodeDecodeError on exactly the file this probe exists to size up.
    A torn tail still counts as one line — callers compare against an
    expected floor, not an exact decode."""
    count = 0
    with open(path, "rb") as f:
        for line in f:
            if line.strip():
                count += 1
    return count


def latest_per_epoch(events: Iterable[dict], kind: str,
                     key=None) -> Dict:
    """``{epoch: event}`` keeping the **last** event per epoch — the replay
    rule for resumed runs (the journal is append-only; a re-run epoch's
    newer event supersedes the stale one).

    ``key``: optional extractor widening the dedup key beyond the epoch —
    kinds that legitimately journal several distinct events per epoch
    (an ``anomaly`` per subject×cause, a ``heartbeat`` per host) dedupe
    per ``(epoch, key(event))`` so a crash-resume's replayed copies
    collapse while genuinely distinct events survive."""
    out: Dict = {}
    for e in events:
        if e.get("kind") == kind and "epoch" in e:
            k = int(e["epoch"]) if key is None else (int(e["epoch"]),
                                                     key(e))
            out[k] = e
    return out


def resolve_journal_path(source: str) -> str:
    """A run directory (holding ``events.jsonl``) or a journal file path."""
    if os.path.isdir(source):
        path = os.path.join(source, "events.jsonl")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"{source} holds no events.jsonl — was the run saved with "
                f"telemetry on (TrainConfig.save / --save)?")
        return path
    if not os.path.exists(source):
        raise FileNotFoundError(f"no journal at {source}")
    return source


def epoch_series(events: Iterable[dict], kind: str, field: str,
                 default: Optional[float] = None):
    """``(epochs, values)`` for one field of one kind, the last event per
    epoch, sorted by epoch: what the drift replay reads."""
    latest = latest_per_epoch(events, kind)
    epochs = sorted(latest)
    values = [latest[e].get(field, default) for e in epochs]
    return epochs, values


def append_journal_record(path: str, kind: str, **fields) -> dict:
    """One-shot appender for standalone emitters (``bench.py --journal``,
    one-off stamps): no Recorder, no run clock — ``t`` is absolute unix
    time (``time.time()``), monotone within the file like any
    run journal.  IO rides the ``obs.bestio`` fs seam.  Returns the event
    written."""
    from .bestio import get_fs

    event = make_event(kind, time.time(), **fields)
    problems = validate_event(event)
    if problems:
        raise ValueError(f"refusing to journal invalid event: {problems}")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with get_fs().open(path, "a") as f:
        f.write(_dump_line(event))
    return event
