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
  observability write rides;
* :mod:`costs` — program costs, the cost ledger (one ``compile`` event per
  distinct program of a run) and the roofline on the H100's peaks;
* :mod:`xprof` — an executed ``torch.profiler`` trace's kernel rows
  attributed to the step's phases, and the comm/comp overlap;
* :mod:`attribution` — measured per-matching link costs and the critical
  path from a journal;
* :mod:`report`, :mod:`timeline` and the fleet readers of :mod:`health` —
  the journal's readers.

``obs_torch.py`` renders a run's journal (summary / tail / drift /
compare), the performance artifacts (roofline / capacity / profile), the
fleet status (watch / health) and the attribution plane (attribute /
timeline), with no JAX installed.  The chaos harness's clock skew
(``wall_clock``) comes with ``chaos/``.
"""

from .anomaly import ANOMALY_CAUSES, AnomalyDetector, liveness, mad_zscores
from .attribution import (
    LINK_COSTS_FORMAT,
    attribute_run,
    critical_path_report,
    link_costs_artifact,
    render_attribution,
)
from .bestio import BestEffortSink, get_fs, install_fs
from .costs import (
    CostLedger,
    analyze_program,
    capacity_report,
    chip_peaks,
    roofline_report,
)
from .drift import DriftMonitor, compose_predicted_rho, drift_report
from .health import (
    HeartbeatEmitter,
    fleet_status,
    fleet_verdict,
    heartbeat_path,
    read_heartbeats,
    render_watch,
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
from .timeline import build_timeline, timeline_for_run, validate_trace
from .xprof import TraceParseError, overlap_report, profile_report

__all__ = [
    "ANOMALY_CAUSES",
    "AnomalyDetector",
    "BestEffortSink",
    "CostLedger",
    "DriftMonitor",
    "EVENT_KINDS",
    "FAULT_KINDS",
    "HeartbeatEmitter",
    "Journal",
    "LINK_COSTS_FORMAT",
    "SCHEMA_VERSION",
    "Telemetry",
    "TelemetrySpec",
    "TraceParseError",
    "analyze_program",
    "append_journal_record",
    "attribute_run",
    "build_timeline",
    "capacity_report",
    "chip_peaks",
    "compose_predicted_rho",
    "count_journal_lines",
    "critical_path_report",
    "drift_report",
    "epoch_series",
    "fleet_status",
    "fleet_verdict",
    "get_fs",
    "heartbeat_path",
    "install_fs",
    "link_costs_artifact",
    "liveness",
    "mad_zscores",
    "make_event",
    "make_telemetry_spec",
    "overlap_report",
    "profile_report",
    "read_heartbeats",
    "read_journal",
    "read_journal_tail",
    "render_attribution",
    "render_watch",
    "resolve_journal_path",
    "roofline_report",
    "salvage_journal",
    "telemetry_flush",
    "telemetry_step",
    "timeline_for_run",
    "validate_event",
    "validate_trace",
    "worker_last_seen",
]
