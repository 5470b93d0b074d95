"""The live health plane: one heartbeat file per host.

Port of the writer and reader half of ``matcha_tpu/obs/health.py``:
``heartbeat_path`` (:49), ``HeartbeatEmitter`` (:53, with
``drain_recovery``), ``read_heartbeats`` (:115), ``worker_last_seen``
(:135), ``_resolve_health_dir`` (:151), and the fleet readers
``fleet_status``, ``fleet_verdict`` and ``render_watch`` (:170-316) that
``obs_torch.py watch`` prints.

* **No device read.**  The emitter runs at the loop's epoch boundary on
  values already on the host: the telemetry flush (which rides the
  epoch's one read), the comm-split timer, the allocator's peak.
  ``step`` is host arithmetic.
* **Per-host files, append-only.**  ``health/<host>.jsonl`` beside the
  run's ``events.jsonl``; each host appends to its own file, and readers
  list the directory.  Records are journal ``heartbeat`` events with an
  **absolute** unix ``t`` (liveness is a wall-clock question; the run
  journal's copy keeps the run-relative clock).
* **Torn lines.**  A reader may meet a writer mid-append; the bounded
  reverse reader (:func:`journal.read_journal_tail`) drops a trailing
  partial line.
"""

from __future__ import annotations

import glob
import os
import time
from typing import Dict, List, Optional

import numpy as np

from .anomaly import AnomalyDetector, liveness
from .attribution import critical_path_report
from .bestio import BestEffortSink
from .journal import append_journal_record, fmt_value, read_journal_tail

__all__ = ["HeartbeatEmitter", "heartbeat_path", "read_heartbeats",
           "worker_last_seen", "fleet_status", "fleet_verdict",
           "render_watch"]


def heartbeat_path(health_dir: str, host: str) -> str:
    return os.path.join(health_dir, f"{host}.jsonl")


class HeartbeatEmitter:
    """Append one heartbeat per epoch to this host's file.

    ``beat`` builds the payload (the step-time EWMA updated on the host),
    appends it with the absolute wall time through a best-effort sink, and
    returns it so that the caller can mirror it into the run journal."""

    def __init__(self, health_dir: str, host: str = "host0",
                 ewma_alpha: float = 0.3):
        if not 0.0 < ewma_alpha <= 1.0:
            raise ValueError(f"ewma_alpha must be in (0, 1], got {ewma_alpha}")
        self.health_dir = str(health_dir)
        self.host = str(host)
        self.path = heartbeat_path(self.health_dir, self.host)
        self.ewma_alpha = float(ewma_alpha)
        self._ewma: Optional[float] = None
        # a heartbeat disk that hangs or fills must never stall or kill the
        # training process it reports on
        self._sink = BestEffortSink(f"heartbeat:{self.host}", deadline=2.0)

    def beat(self, epoch: int, step: int, steps: float, epoch_time: float,
             comm_time: float, workers: Dict[str, dict],
             peak_bytes: Optional[float] = None) -> dict:
        """One epoch's heartbeat.  ``workers`` maps worker id →
        ``{"slot", "participation", "disagreement"}`` (member slots only: a
        vacant pool slot is nobody's worker)."""
        step_time = float(epoch_time) / max(float(steps), 1.0)
        a = self.ewma_alpha
        self._ewma = (step_time if self._ewma is None
                      else a * step_time + (1.0 - a) * self._ewma)
        comm = min(float(comm_time), float(epoch_time))
        payload = {
            "host": self.host,
            "epoch": int(epoch),
            "step": int(step),
            "steps": float(steps),
            "step_time": step_time,
            "step_time_ewma": float(self._ewma),
            "comp_time": float(epoch_time) - comm,
            "comm_time": comm,
            "peak_bytes": (None if peak_bytes is None
                           else float(peak_bytes)),
            "workers": {str(w): {k: (None if v is None else
                                     (int(v) if k == "slot" else float(v)))
                                 for k, v in stats.items()}
                        for w, stats in workers.items()},
        }
        self._sink.write(
            lambda: append_journal_record(self.path, "heartbeat", **payload))
        return payload

    def drain_recovery(self) -> List[dict]:
        """Pop the sink's degrade/restore payloads (scope ``io``): the loop
        journals each as a ``recovery`` event, so a watcher learns that the
        heartbeat file went quiet on purpose, not that the run died."""
        return self._sink.drain()


def read_heartbeats(health_dir: str, tail: int = 8) -> Dict[str, List[dict]]:
    """``{host: [records]}``, the last ``tail`` records of every per-host
    file, oldest first, by the bounded reverse reader.

    ``events.jsonl`` is never a heartbeat file: the run journal mirrors
    heartbeats on the run-relative clock, which read as liveness evidence
    would convict every worker of an absence as long as the unix epoch."""
    out: Dict[str, List[dict]] = {}
    for path in sorted(glob.glob(os.path.join(health_dir, "*.jsonl"))):
        if os.path.basename(path) == "events.jsonl":
            continue
        host = os.path.splitext(os.path.basename(path))[0]
        records = [e for e in read_journal_tail(path, tail)
                   if e.get("kind") == "heartbeat"]
        if records:
            out[host] = records
    return out


def worker_last_seen(records_by_host: Dict[str, List[dict]]
                     ) -> Dict[str, float]:
    """``{worker: last_seen_t}``, the newest absolute time of a heartbeat
    that lists the worker.  A worker its host stopped listing keeps its
    frozen last-seen, which the liveness deadline turns into a leave."""
    seen: Dict[str, float] = {}
    for records in records_by_host.values():
        for rec in records:
            t = float(rec.get("t", 0.0))
            for worker in (rec.get("workers") or {}):
                if t >= seen.get(worker, -np.inf):
                    seen[worker] = t
    return seen


def _resolve_health_dir(source: str) -> str:
    """A run directory (holding ``health/``) or the health directory itself.

    A directory whose only journal is a run ``events.jsonl`` is a run
    directory without heartbeats, not a heartbeat directory: its
    run-relative clocks must never be read as liveness evidence."""
    nested = os.path.join(source, "health")
    if os.path.isdir(nested):
        return nested
    if os.path.isdir(source) and any(
            os.path.basename(p) != "events.jsonl"
            for p in glob.glob(os.path.join(source, "*.jsonl"))):
        return source
    raise FileNotFoundError(
        f"{source} holds no health/ heartbeat directory — was the run "
        f"saved with health on (TrainConfig.save + health / --save)?")


def fleet_status(source: str, now: Optional[float] = None,
                 deadline: float = 60.0, tail: int = 8,
                 detector: Optional[AnomalyDetector] = None) -> dict:
    """Digest the fleet's heartbeat files into the watch table.

    Re-runs the streaming detectors over each host's tail window (the
    same pure-host code the train loop journals with — replaying records
    reaches the same verdicts) and adds the one check only a reader can
    make: deadline-missed liveness against ``now``.  Returns a dict with
    per-worker ``rows``, per-host digests, and ``flagged`` — the
    ``watch --once`` exit-1 verdict.
    """
    health_dir = _resolve_health_dir(source)
    now = time.time() if now is None else float(now)
    by_host = read_heartbeats(health_dir, tail=tail)
    if not by_host:
        raise FileNotFoundError(f"{health_dir} holds no heartbeat records")
    detector = detector or AnomalyDetector()
    # latest verdict per (subject, cause) across the tail window: a
    # straggler flagged at epoch 3 stays on the table even if the chaos
    # window closed before the newest beat
    anomalies: Dict[tuple, dict] = {}
    hosts: Dict[str, dict] = {}
    for host, records in by_host.items():
        for rec in records:
            for a in detector.observe(rec):
                anomalies[(a["subject"], a["cause"])] = a
        newest = records[-1]
        hosts[host] = {
            "host": host,
            "last_seen": float(newest.get("t", 0.0)),
            "epoch": int(newest.get("epoch", -1)),
            "step": int(newest.get("step", 0)),
            "step_time_ewma": float(newest.get("step_time_ewma") or 0.0),
            "steps_per_sec": (1.0 / float(newest["step_time_ewma"])
                              if newest.get("step_time_ewma") else 0.0),
            "workers": newest.get("workers") or {},
        }
    for host, age in liveness(
            {h: d["last_seen"] for h, d in hosts.items()}, now,
            deadline).items():
        a = {"epoch": hosts[host]["epoch"], "subject": host,
             "cause": "deadline_missed", "value": age,
             "threshold": float(deadline)}
        anomalies[(host, "deadline_missed")] = a
        # a dark host's workers are presumed down with it
        for worker in hosts[host]["workers"]:
            anomalies[(worker, "deadline_missed")] = {**a, "subject": worker}
    # degraded-telemetry detection: when heartbeat writes
    # are being dropped (ENOSPC / hung disk), the per-host files go quiet
    # while the run is fine — the run journal's `recovery` events (scope
    # `io`) are the loud record.  Surface the newest state per sink so the
    # watch degrades loudly instead of lying about liveness.
    run_journal = os.path.join(os.path.dirname(health_dir), "events.jsonl")
    if os.path.exists(run_journal):
        sink_state: Dict[str, dict] = {}  # newest io-recovery event per sink
        for e in read_journal_tail(run_journal, 64):
            if e.get("kind") == "recovery" and e.get("scope") == "io":
                sink_state[str(e.get("sink"))] = e
        for sink, e in sorted(sink_state.items()):
            if e.get("action") != "degraded":
                continue  # restored: the sink is healthy again
            a = {"epoch": int(e.get("epoch", -1)), "subject": sink,
                 "cause": "telemetry_degraded", "value": 1.0,
                 "threshold": 0.0}
            anomalies[(sink, "telemetry_degraded")] = a
    rates = [d["steps_per_sec"] for d in hosts.values()
             if d["steps_per_sec"] > 0]
    median_rate = float(np.median(rates)) if rates else 0.0
    # critical-path tax over the tail window: each epoch
    # barrier waits for its slowest host, so that host is charged the
    # epoch's (max − median) seconds — the wall-clock a balanced fleet
    # would have saved.  Single-host fleets tax 0 by construction.  One
    # source of truth: the attribution plane's barrier attribution over
    # the same heartbeat shape, so `watch` and `attribute` can never
    # disagree about who gated an epoch.
    crit_tax = critical_path_report((), heartbeats_by_host=by_host
                                    )["tax_by_host"]
    for host, d in hosts.items():
        d["crit_tax_s"] = crit_tax.get(host, 0.0)
    last_seen = worker_last_seen(by_host)
    rows = []
    for host, d in sorted(hosts.items()):
        for worker, stats in sorted(d["workers"].items(),
                                    key=lambda kv: (kv[1].get("slot") or 0,
                                                    kv[0])):
            # a dark host's deadline_missed already fanned out to each of
            # its workers above, so the worker key alone is complete
            flags = sorted(cause for (subj, cause) in anomalies
                           if subj == worker)
            rows.append({
                "worker": worker,
                "host": host,
                "slot": stats.get("slot"),
                "alive": "deadline_missed" not in flags
                         and "dead" not in flags,
                "last_seen_age": max(now - last_seen.get(worker, 0.0), 0.0),
                "participation": stats.get("participation"),
                "disagreement": stats.get("disagreement"),
                "steps_per_sec": d["steps_per_sec"],
                "rate_vs_median": (d["steps_per_sec"] / median_rate
                                   if median_rate > 0 else None),
                "crit_tax_s": d["crit_tax_s"],
                "flags": flags,
            })
    return {
        "health_dir": health_dir,
        "now": now,
        "deadline": float(deadline),
        "hosts": hosts,
        "rows": rows,
        "anomalies": sorted(anomalies.values(),
                            key=lambda a: (a["epoch"], a["subject"],
                                           a["cause"])),
        "flagged": bool(anomalies),
    }


def fleet_verdict(source: str, now: Optional[float] = None,
                  deadline: float = 60.0, tail: int = 8,
                  detector: Optional[AnomalyDetector] = None
                  ) -> tuple:
    """``(exit_code, status_or_None)`` — THE fleet health verdict.

    The one place the ``watch --once`` exit-code contract lives
    (``obs_torch.py watch``):

    * ``0`` — heartbeats exist and nothing is flagged (``status`` carried),
    * ``1`` — heartbeats exist and something is flagged (``status``
      carried, read ``status["anomalies"]`` for the findings),
    * ``2`` — no heartbeat evidence at all (missing health dir or empty
      files; ``status`` is ``None``).
    """
    try:
        status = fleet_status(source, now=now, deadline=deadline, tail=tail,
                              detector=detector)
    except FileNotFoundError:
        return 2, None
    return (1 if status["flagged"] else 0), status


def _fmt(v, digits: int = 3) -> str:
    return fmt_value(v, digits)  # watch tables default to 3 digits


def render_watch(status: dict, markdown: bool = False) -> str:
    """The fleet-status table (``obs_torch.py watch``), terminal or
    markdown."""
    head = (f"fleet health: {status['health_dir']} "
            f"({len(status['hosts'])} host(s), {len(status['rows'])} "
            f"worker(s), deadline {status['deadline']:.0f}s)")
    verdict = ("HEALTHY" if not status["flagged"] else
               f"ANOMALOUS ({len(status['anomalies'])} finding(s))")
    cols = ("worker", "host", "alive", "seen[s]", "rate/med", "partic",
            "disagree", "crit[s]", "flags")

    def cells(r):
        return (r["worker"], r["host"], "yes" if r["alive"] else "NO",
                _fmt(r["last_seen_age"]), _fmt(r["rate_vs_median"]),
                _fmt(r["participation"]), _fmt(r["disagreement"]),
                _fmt(r.get("crit_tax_s")),
                ",".join(r["flags"]) or "-")

    if markdown:
        lines = [f"# Fleet health — {os.path.basename(status['health_dir'].rstrip('/'))}",
                 "", f"- {head}", f"- verdict: **{verdict}**", "",
                 "| " + " | ".join(cols) + " |",
                 "|" + "|".join("---" for _ in cols) + "|"]
        lines += ["| " + " | ".join(str(c) for c in cells(r)) + " |"
                  for r in status["rows"]]
        if status["anomalies"]:
            lines += ["", "## Anomalies", ""]
            lines += [f"- `e{a['epoch']}` **{a['subject']}** {a['cause']} "
                      f"(value {_fmt(a['value'])}, threshold "
                      f"{_fmt(a['threshold'])})"
                      for a in status["anomalies"]]
        return "\n".join(lines) + "\n"
    widths = [max(len(c), *(len(str(x)) for x in
                            (tuple(cells(r))[i] for r in status["rows"])))
              if status["rows"] else len(c) for i, c in enumerate(cols)]
    lines = [head,
             " ".join(c.ljust(w) for c, w in zip(cols, widths))]
    for r in status["rows"]:
        lines.append(" ".join(str(c).ljust(w)
                              for c, w in zip(cells(r), widths)))
    for a in status["anomalies"]:
        lines.append(f"ANOMALY e{a['epoch']} {a['subject']}: {a['cause']} "
                     f"(value {_fmt(a['value'])} vs threshold "
                     f"{_fmt(a['threshold'])})")
    lines.append(f"verdict: {verdict}")
    return "\n".join(lines)
