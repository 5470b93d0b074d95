"""Per-run metric recording: the reference CSVs and the run journal.

Port of ``matcha_tpu/train/recorder.py`` (``Recorder``, :73), with the same
files under ``{savePath}/{name}_{model}/``: per-worker series
``dsgd-lr{lr}-budget{budget}-r{rank}-{kind}.log`` for the eight
``SERIES`` (the reference's seven and ``disagreement``), ``ExpDescription``
(the config), ``faults.json`` (a view of the journal's fault events) and
``events.jsonl`` (the journal, ``obs.journal``).

The CSVs are written **append-only**: each ``save`` emits only the rows
added since the last flush, falling back to a full rewrite exactly when the
in-memory series and the disk file may disagree (the first save of a run
into a possibly stale folder, and the first save after a resume reload).
The bytes are identical to one full ``np.savetxt``.

Resume: ``load_previous`` reads the on-disk series back, truncated to the
restored epoch, so a resumed run extends the CSVs instead of overwriting
the earlier history, and reloads the journal verbatim (append-only:
replayed epochs append newer events, readers take the last per epoch).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Dict, List

import numpy as np

from ..obs.bestio import BestEffortSink, get_fs
from ..obs.journal import (FAULT_KINDS, Journal, count_journal_lines,
                           make_event, read_journal, salvage_journal)
from ..utils.atomicio import atomic_publish

__all__ = ["Recorder"]

SERIES = ("recordtime", "time", "comptime", "commtime", "acc", "losses", "tacc", "disagreement")

# np.savetxt's default single-column format — the append path must write
# byte-identical lines to what a full savetxt would have produced
_FMT = "%.18e"


def _json_safe(value):
    """JSON-strict payloads: non-finite floats become null (json.dumps would
    emit the nonstandard ``NaN`` token otherwise), numpy scalars unwrap."""
    if isinstance(value, dict):
        return {k: _json_safe(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_json_safe(v) for v in value]
    if isinstance(value, (np.generic,)):
        value = value.item()
    if isinstance(value, float) and not math.isfinite(value):
        return None
    return value


class Recorder:
    def __init__(self, config, num_workers: int):
        self.config = config
        self.num_workers = num_workers
        self.data: Dict[str, List] = {k: [] for k in SERIES}
        #: the unified journal — every structured event of the run, in order
        self.events: List[dict] = []
        self.start = time.time()
        self.folder = os.path.join(
            config.savePath, f"{config.name}_{config.model}"
        )
        self.journal = Journal(os.path.join(self.folder, "events.jsonl"))
        # append-only CSV bookkeeping: rows already on disk, and whether the
        # next save must fully rewrite (fresh run into a reused folder /
        # post-resume truncation — the two cases disk and memory can differ)
        self._flushed_epochs = 0
        self._csv_rewrite = True
        self._journal_rewrite = True
        # best-effort IO contract (obs.bestio): a save that hangs or
        # hits ENOSPC degrades loudly instead of stalling/killing training
        self._sink = BestEffortSink("recorder", deadline=10.0)
        #: host seconds of each ``save`` call, in order
        self.flush_seconds: List[float] = []

    # ------------------------------------------------------------- journal
    def log_event(self, kind: str, **detail) -> dict:
        """Append one event to the unified journal (``obs.journal`` schema:
        ``v``/``kind``/``t`` envelope + payload).  Everything flows through
        here — faults, telemetry flushes, epoch rows, drift trips — so the
        journal is the one ordered record of the run."""
        event = make_event(kind, time.time() - self.start,
                           **_json_safe(detail))
        self.events.append(event)
        return event

    def log_fault(self, kind: str, **detail):
        """Append a fault-ledger event (kind ∈ ``obs.journal.FAULT_KINDS``)
        — journal event first, ``faults.json`` is derived at save time."""
        self.log_event(kind, **detail)

    @property
    def faults(self) -> List[dict]:
        """The historical fault-ledger view of the journal: fault-kind
        events reshaped to ``{"kind", "recordtime", **detail}`` — what
        ``faults.json`` holds and ``plan verify`` consumes."""
        view = []
        for e in self.events:
            if e.get("kind") not in FAULT_KINDS:
                continue
            entry = {k: v for k, v in e.items() if k not in ("v", "t")}
            entry["recordtime"] = e.get("t", 0.0)
            view.append(entry)
        return view

    # -------------------------------------------------------------- series
    def add_epoch(
        self,
        epoch_time: float,
        comp_time: float,
        comm_time: float,
        train_acc,  # [N] or scalar
        train_loss,
        test_acc,
        disagreement: float,
    ):
        epoch = self.epochs_recorded
        self.data["recordtime"].append(time.time() - self.start)
        self.data["time"].append(epoch_time)
        self.data["comptime"].append(comp_time)
        self.data["commtime"].append(comm_time)
        self.data["acc"].append(np.asarray(train_acc))
        self.data["losses"].append(np.asarray(train_loss))
        self.data["tacc"].append(np.asarray(test_acc))
        self.data["disagreement"].append(disagreement)
        self.log_event(
            "epoch", epoch=epoch, epoch_time=float(epoch_time),
            comp_time=float(comp_time), comm_time=float(comm_time),
            train_loss=float(np.mean(np.asarray(train_loss))),
            train_acc=float(np.mean(np.asarray(train_acc))),
            test_acc_mean=float(np.nanmean(np.asarray(test_acc, np.float64)))
            if np.asarray(test_acc).size else float("nan"),
            disagreement=float(disagreement),
        )

    @property
    def epochs_recorded(self) -> int:
        return len(self.data["time"])

    # -------------------------------------------------------------- resume
    def load_previous(self, epochs: int) -> int:
        """Reload up to ``epochs`` rows of a previous run's CSVs from disk.

        The resume path calls this with the restored epoch count so that the
        next ``save`` *extends* the on-disk series instead of overwriting
        them with only the post-resume rows — without it, a crash-resume
        silently decouples the CSV row index from the epoch number (and a
        resume from an older checkpoint double-appends the replayed epochs).
        The in-memory series always come back with exactly ``epochs`` rows:
        whatever the CSVs hold (the flush cadence is every 10 epochs, so
        they may lag a newer checkpoint) padded with NaN rows up to the
        restored epoch.  Row index == epoch is the invariant every consumer
        (plan verify's per-epoch factors, the sweep curves) relies on — a
        silent 10-row file under a 15-epoch resume would shift every later
        epoch by 5; an explicit NaN gap cannot be misread.  Returns the
        number of rows actually read from disk (0 when no logs exist).
        ``recordtime`` values are kept verbatim from the original run (they
        are offsets from *that* run's start; documented, not rewritten).

        The journal (and through it the fault ledger) is not a per-epoch
        series: pre-crash events are reloaded **verbatim** — so a resumed
        chaos run's journal keeps the full rollback/heal history — and
        post-resume events append after them.  Replayed epochs journal
        fresh ``epoch``/``telemetry`` events; readers take the last per
        epoch (``obs.journal.latest_per_epoch``).  A resume therefore
        never rewrites the journal file, only extends it.  Runs that
        predate the journal are upgraded in place: a bare ``faults.json``
        is lifted into journal events so the view round-trips.
        """
        jpath = self.journal.path
        if os.path.exists(jpath):
            # repair=True drops a crash-truncated final line; when that
            # happened the on-disk file is longer than the parsed prefix,
            # and appending after the broken tail would corrupt the stream
            # mid-file — schedule a full rewrite from memory instead
            try:
                self.events = read_journal(jpath, repair=True)
                # binary-tolerant count: a crash mid-append can leave a
                # non-UTF-8 tail that a text-mode iteration would choke on
                disk_lines = count_journal_lines(jpath)
            except ValueError:
                # mid-stream corruption: repair cannot drop an interior
                # line without rewriting history — salvage the clean
                # prefix, quarantine the damaged file, rebuild from memory
                events, qpath, problem = salvage_journal(jpath)
                self.events = events
                disk_lines = -1  # force the rewrite branch below
                self.journal.mark_flushed(0)
                self.log_event("recovery", scope="journal",
                               action="salvage", reason=problem,
                               quarantined=qpath)
            if disk_lines == len(self.events):
                self.journal.mark_flushed(len(self.events))
                self._journal_rewrite = False
            else:
                self._journal_rewrite = True
                if disk_lines > len(self.events):
                    # torn tail: repair dropped the crash-truncated final
                    # line(s).  Journal the repair — a dropped tail that
                    # is not journaled is history silently rewritten.
                    self.log_event(
                        "recovery", scope="journal", action="repair",
                        reason=f"crash-truncated tail: dropped "
                               f"{disk_lines - len(self.events)} "
                               f"unparseable line(s) on resume")
        else:
            ledger = os.path.join(self.folder, "faults.json")
            if os.path.exists(ledger):
                with open(ledger) as f:
                    for e in json.load(f).get("events", []):
                        entry = dict(e)
                        t = entry.pop("recordtime", 0.0)
                        self.events.append(
                            make_event(entry.pop("kind"), t or 0.0, **entry))
        cfg = self.config
        rows: Dict[str, List] = {k: [] for k in SERIES}
        loaded = 0
        complete = True
        for kind in SERIES:
            per_rank = []
            for rank in range(self.num_workers):
                path = os.path.join(
                    self.folder,
                    f"dsgd-lr{cfg.lr}-budget{cfg.budget}-r{rank}-{kind}.log")
                if not os.path.exists(path):
                    complete = False
                    break
                if os.path.getsize(path):
                    per_rank.append(np.loadtxt(path, delimiter=",",
                                               ndmin=1))
                else:
                    # a pre-first-epoch flush leaves zero-row CSVs;
                    # loadtxt warns on them, an empty series is the fact
                    per_rank.append(np.zeros(0))
            if not complete:
                break
            n = min(epochs, min(len(s) for s in per_rank))
            loaded = n if kind == SERIES[0] else min(loaded, n)
            stacked = np.stack([s[:n] for s in per_rank], axis=1)  # [n, N]
            if kind in ("acc", "losses", "tacc"):
                rows[kind] = [stacked[e] for e in range(n)]
            else:  # scalar series: every rank holds the same value
                rows[kind] = [float(stacked[e, 0]) for e in range(n)]
        if not complete:
            loaded, rows = 0, {k: [] for k in SERIES}
        nan_row = np.full(self.num_workers, np.nan)
        for kind in SERIES:
            pad = float("nan") if kind not in ("acc", "losses", "tacc") \
                else nan_row
            rows[kind] = rows[kind][:loaded] + [pad] * (epochs - loaded)
        self.data = rows
        # disk may hold more rows than we kept (resume from an older
        # checkpoint truncates) — the first post-resume save must rewrite
        self._flushed_epochs = 0
        self._csv_rewrite = True
        return int(loaded)

    # ---------------------------------------------------------------- save
    def _series_for_worker(self, kind: str, rank: int,
                           start: int = 0) -> np.ndarray:
        rows = []
        for v in self.data[kind][start:]:
            arr = np.asarray(v)
            rows.append(float(arr[rank]) if arr.ndim else float(arr))
        return np.asarray(rows)

    def save(self) -> bool:
        """Flush — best-effort: the write runs behind ``BestEffortSink``'s
        deadline + breaker, so a hung or ENOSPC'd telemetry disk degrades
        loudly (``recovery`` events, scope ``io``) instead of stalling or
        killing the training process.  Returns ``True`` iff it landed."""
        t0 = time.perf_counter()
        ok = self._sink.write(self._save_now)
        self.flush_seconds.append(time.perf_counter() - t0)
        for ev in self._sink.drain():
            self.log_event("recovery", scope="io", action=ev["action"],
                           reason=ev["reason"], sink=ev["sink"])
        return ok

    def _save_now(self):
        """The actual flush: CSV rows added since the last save
        (append-only), the ExpDescription, the ``faults.json`` view, and
        the journal — every write through the fs seam (``obs.bestio``)."""
        fs = get_fs()
        os.makedirs(self.folder, exist_ok=True)
        cfg = self.config
        total = self.epochs_recorded
        rewrite = self._csv_rewrite or total < self._flushed_epochs
        start = 0 if rewrite else self._flushed_epochs
        for rank in range(self.num_workers):
            prefix = f"dsgd-lr{cfg.lr}-budget{cfg.budget}-r{rank}-"
            for kind in SERIES:
                path = os.path.join(self.folder, prefix + kind + ".log")
                new_rows = self._series_for_worker(kind, rank, start=start)
                if rewrite or not os.path.exists(path):
                    with fs.open(path, "w") as f:
                        np.savetxt(f, new_rows, delimiter=",", fmt=_FMT)
                elif len(new_rows):
                    # byte-identical to what the full savetxt would append:
                    # same fmt, one value per line, trailing newline
                    with fs.open(path, "a") as f:
                        for v in new_rows:
                            f.write((_FMT % v) + "\n")
        self._flushed_epochs = total
        self._csv_rewrite = False
        desc = os.path.join(self.folder, "ExpDescription")
        with fs.open(desc, "w") as f:
            f.write(f"{cfg.name} {cfg.description}\n")
            for field in dataclasses.fields(cfg):
                f.write(f"{field.name}: {getattr(cfg, field.name)}\n")
        path = os.path.join(self.folder, "faults.json")
        faults = self.faults
        if faults:
            # atomic like the checkpoint sidecar: a crash mid-dump must not
            # leave truncated JSON for the verifier to choke on
            atomic_publish(path, json.dumps({"events": faults}, indent=1),
                           prefix=".faults.")
        elif os.path.exists(path):
            # a fault-free rerun into the same folder must not leave a
            # previous run's ledger behind: plan-verify would silently score
            # this run against the stale degraded rho
            os.remove(path)
        self.journal.flush(self.events, rewrite=self._journal_rewrite)
        self._journal_rewrite = False
