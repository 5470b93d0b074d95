"""The live health plane: one heartbeat file per host.

Port of the writer and reader half of ``matcha_tpu/obs/health.py``:
``heartbeat_path`` (:49), ``HeartbeatEmitter`` (:53, with
``drain_recovery``), ``read_heartbeats`` (:115), ``worker_last_seen``
(:135) and ``_resolve_health_dir`` (:151).  The fleet readers
(``fleet_status``, ``fleet_verdict``, ``render_watch``) need the
attribution plane and are not ported yet (``ROADMAP.md``); the JAX
package's ``obs_tpu.py watch`` reads the port's heartbeat files.

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
from typing import Dict, List, Optional

import numpy as np

from .bestio import BestEffortSink
from .journal import append_journal_record, read_journal_tail

__all__ = ["HeartbeatEmitter", "heartbeat_path", "read_heartbeats",
           "worker_last_seen"]


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
