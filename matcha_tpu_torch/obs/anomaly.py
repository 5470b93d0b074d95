"""Streaming anomaly detection over heartbeat records: host code only.

Port of ``matcha_tpu/obs/anomaly.py``: ``ANOMALY_CAUSES``, ``mad_zscores``,
``liveness`` and ``AnomalyDetector``, numpy with the same arithmetic.  The
detectors read the heartbeat stream (:mod:`obs.health`) while the run goes
on and return ``anomaly`` payloads with an attributed cause; they read
values the epoch's one read already brought to the host, so they add no
device read.

* **participation** — each heartbeat carries every member worker's alive
  fraction over the epoch.  A member whose fraction is ~0 is ``dead``;
  one below 1 is a ``straggler`` (a fault plan's straggler takes part
  every period-th step).
* **disagreement outlier** — the robust z-score (median / MAD, scaled
  by 1.4826) of each worker's deviation from consensus against the
  fleet's.
* **step/comm-time spike** — the robust z-score of this heartbeat's step
  time (and comm time) against the host's own history.
* **deadline missed** — :func:`liveness`: a host (and every worker it
  carries) whose newest heartbeat is older than the deadline is presumed
  down; the live membership source (:mod:`elastic.live`) reads it too.

Causes are a pinned vocabulary (``ANOMALY_CAUSES``), the JAX package's.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["ANOMALY_CAUSES", "mad_zscores", "AnomalyDetector", "liveness"]

#: The attributed-cause vocabulary `anomaly` events draw from.
ANOMALY_CAUSES = (
    "dead",                  # participation ~ 0 while a member
    "straggler",             # participation persistently < 1
    "disagreement_outlier",  # per-worker deviation far from the fleet's
    "step_time_spike",       # host step-time >> its own history
    "comm_time_spike",       # host comm-time >> its own history
    "deadline_missed",       # no heartbeat within the liveness deadline
    "telemetry_degraded",    # an observability sink is dropping writes
)

#: MAD → σ under normality; the conventional robust-z consistency constant.
_MAD_SCALE = 1.4826


def mad_zscores(values: Sequence[float]) -> np.ndarray:
    """Robust z-scores: ``(x − median) / (1.4826 · MAD)``.

    A zero MAD (half the sample identical — common for tiny fleets) falls
    back to the mean absolute deviation, and a zero MeanAD (all values
    identical) yields all-zero scores instead of a 0/0 — a constant series
    has no outliers, not NaN outliers."""
    x = np.asarray(values, np.float64)
    med = np.median(x)
    mad = np.median(np.abs(x - med))
    scale = _MAD_SCALE * mad
    if scale <= 0:
        scale = float(np.mean(np.abs(x - med)))
    if scale <= 0:
        return np.zeros_like(x)
    return (x - med) / scale


def liveness(last_seen: Dict[str, float], now: float,
             deadline: float) -> Dict[str, float]:
    """``{subject: age}`` for every subject whose newest record is older
    than ``deadline`` seconds.  Future timestamps (clock skew across a
    shared FS) clamp to age 0 — skew must not kill a live host."""
    out: Dict[str, float] = {}
    for subject, t in last_seen.items():
        age = max(now - float(t), 0.0)
        if age > deadline:
            out[subject] = age
    return out


class AnomalyDetector:
    """Streaming detectors over one host-ordered heartbeat stream.

    ``observe(record)`` consumes one heartbeat (the payload dict the
    emitter built — envelope fields are ignored) and returns the anomaly
    payloads it convicts, each ready to journal as an ``anomaly`` event:
    ``{"epoch", "subject", "cause", "value", "threshold", "zscore"?}``.
    Detection state is per-host history (step/comm-time series) plus
    nothing else — replaying the same records yields the same verdicts,
    which is what lets a watcher re-run the detectors over a heartbeat
    tail and reach the train loop's exact conclusions.

    Thresholds: ``dead_below``/``straggler_below`` bound the participation
    fractions; ``z_threshold`` the robust z for the statistical detectors,
    each additionally guarded by a relative floor (``rel_floor`` × median)
    so a tightly-clustered healthy fleet's tiny MAD cannot manufacture
    outliers out of noise.
    """

    def __init__(self, dead_below: float = 0.05,
                 straggler_below: float = 0.9,
                 z_threshold: float = 4.0, rel_floor: float = 1.5,
                 min_history: int = 4, history: int = 64):
        if not 0.0 <= dead_below < straggler_below <= 1.0:
            raise ValueError(
                f"need 0 <= dead_below < straggler_below <= 1, got "
                f"{dead_below}/{straggler_below}")
        if z_threshold <= 0 or rel_floor < 1.0:
            raise ValueError("z_threshold must be > 0 and rel_floor >= 1")
        self.dead_below = float(dead_below)
        self.straggler_below = float(straggler_below)
        self.z_threshold = float(z_threshold)
        self.rel_floor = float(rel_floor)
        self.min_history = int(min_history)
        self.history = int(history)
        self._times: Dict[str, Dict[str, List[float]]] = {}

    # ------------------------------------------------------------ detectors
    def _participation(self, record: dict) -> List[dict]:
        out = []
        epoch = int(record.get("epoch", -1))
        for worker, stats in sorted((record.get("workers") or {}).items()):
            p = stats.get("participation")
            if p is None:
                continue
            p = float(p)
            if p <= self.dead_below:
                out.append({"epoch": epoch, "subject": worker,
                            "cause": "dead", "value": p,
                            "threshold": self.dead_below})
            elif p < self.straggler_below:
                out.append({"epoch": epoch, "subject": worker,
                            "cause": "straggler", "value": p,
                            "threshold": self.straggler_below})
        return out

    def _disagreement(self, record: dict) -> List[dict]:
        workers = sorted((record.get("workers") or {}).items())
        pairs = [(w, float(s["disagreement"])) for w, s in workers
                 if s.get("disagreement") is not None
                 and np.isfinite(s.get("disagreement"))]
        if len(pairs) < self.min_history:
            return []
        values = [d for _, d in pairs]
        z = mad_zscores(values)
        med = float(np.median(values))
        out = []
        for (worker, d), score in zip(pairs, z):
            # one-sided: only divergence is a failure (a worker closer to
            # consensus than its peers is just... converged)
            if score > self.z_threshold and d > self.rel_floor * med:
                out.append({"epoch": int(record.get("epoch", -1)),
                            "subject": worker,
                            "cause": "disagreement_outlier", "value": d,
                            "threshold": self.rel_floor * med,
                            "zscore": float(score)})
        return out

    def _time_spikes(self, record: dict) -> List[dict]:
        host = str(record.get("host", "?"))
        series = self._times.setdefault(host, {"step_time": [],
                                               "comm_time": []})
        out = []
        for field, cause in (("step_time", "step_time_spike"),
                             ("comm_time", "comm_time_spike")):
            v = record.get(field)
            past = series[field]
            if v is not None and np.isfinite(v):
                # scored against the history BEFORE this record joins it —
                # a spike must not dilute the baseline that convicts it
                if len(past) >= self.min_history:
                    med = float(np.median(past))
                    score = float(mad_zscores(past + [float(v)])[-1])
                    if score > self.z_threshold \
                            and float(v) > self.rel_floor * med:
                        out.append({"epoch": int(record.get("epoch", -1)),
                                    "subject": host, "cause": cause,
                                    "value": float(v),
                                    "threshold": self.rel_floor * med,
                                    "zscore": score})
                past.append(float(v))
                del past[:-self.history]
        return out

    def observe(self, record: dict) -> List[dict]:
        """All verdicts for one heartbeat, most severe cause first."""
        return (self._participation(record) + self._disagreement(record)
                + self._time_spikes(record))
