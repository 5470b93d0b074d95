"""Observability of the port, as ``matcha_tpu.obs`` lays it out:

* :mod:`telemetry` — the in-step accumulator on the device (disagreement,
  wire bytes, matchings, alive workers, heals, the staleness ring's ages,
  the per-worker rows), read once an epoch in the loop's one read;
* :mod:`journal` — the schema-versioned ``events.jsonl`` every run writes,
  and the readers the planes below need;
* :mod:`drift` — the live planner-drift monitor: the measured per-epoch
  contraction against the plan's composed ρ;
* :mod:`health` — one heartbeat file per host under ``{run}/health/``;
* :mod:`anomaly` — streaming detectors over those heartbeats (dead,
  straggler, disagreement outlier, time spike, deadline missed);
* :mod:`bestio` — the fs seam and the best-effort sink every
  observability write rides.

The report tools (``obs_tpu.py``), the cost ledger, the trace parser and
the attribution plane stay with the JAX package, which reads the port's
journals and heartbeat files unchanged.
"""

from .anomaly import ANOMALY_CAUSES, AnomalyDetector, liveness, mad_zscores
from .bestio import BestEffortSink, get_fs, install_fs
from .drift import DriftMonitor, compose_predicted_rho, drift_report
from .health import (
    HeartbeatEmitter,
    heartbeat_path,
    read_heartbeats,
    worker_last_seen,
)
from .journal import (
    EVENT_KINDS,
    FAULT_KINDS,
    SCHEMA_VERSION,
    Journal,
    append_journal_record,
    count_journal_lines,
    epoch_series,
    make_event,
    read_journal,
    read_journal_tail,
    resolve_journal_path,
    salvage_journal,
    validate_event,
)
from .telemetry import (
    Telemetry,
    TelemetrySpec,
    make_telemetry_spec,
    telemetry_flush,
    telemetry_step,
)

__all__ = [
    "ANOMALY_CAUSES",
    "AnomalyDetector",
    "BestEffortSink",
    "DriftMonitor",
    "EVENT_KINDS",
    "FAULT_KINDS",
    "HeartbeatEmitter",
    "Journal",
    "SCHEMA_VERSION",
    "Telemetry",
    "TelemetrySpec",
    "append_journal_record",
    "compose_predicted_rho",
    "count_journal_lines",
    "drift_report",
    "epoch_series",
    "get_fs",
    "heartbeat_path",
    "install_fs",
    "liveness",
    "mad_zscores",
    "make_event",
    "make_telemetry_spec",
    "read_heartbeats",
    "read_journal",
    "read_journal_tail",
    "resolve_journal_path",
    "salvage_journal",
    "telemetry_flush",
    "telemetry_step",
    "validate_event",
    "worker_last_seen",
]
