"""The run controller: train as a service.

Port of ``matcha_tpu/serve``.  Three planes over the training loop, none
of which rebuilds its step:

``controller`` / ``trainer``
    The supervisor daemon and the trainer lifetime it launches: crash →
    resume from journal + checkpoint under a bounded restart budget with
    decorrelated backoff; deliberate restarts (restart-scope control
    fields) relaunch without charging it.  Every supervision decision is
    a v6 ``control`` journal event.

``control`` / ``runtime``
    The hot-swap plane: versioned atomic-rename control documents applied
    at epoch boundaries — a budget re-solve (``plan.resolve_budget_swap``),
    the local-step cadence, the drift bounds — as the ``ControlKnobs``
    value riding ``TrainState.control``, which the step reads (the flag
    row K1 gets, and its launch pattern).

``promote`` / ``endpoint``
    The serving plane: periodic held-out eval of the consensus-mean
    snapshot, promotion to a serving directory under a signed manifest
    (content hash + config fingerprint + journal offset + metrics),
    rollback on metric regression; plus the stdlib HTTP endpoint
    (``/healthz`` — the ``obs_torch.py watch --once`` verdict,
    ``/status``, ``/promoted`` — verified on every read).

``serve_torch.py`` is the CLI: ``run`` starts the daemon (controller +
endpoint), ``control`` publishes a document, ``verify`` checks a serving
directory's manifest end-to-end.  The chaos harness (``chaos/``,
``chaos_torch.py``) runs seeded fault campaigns against this daemon.
"""

from .control import (
    CONTROL_BASENAME,
    RESTART_EXIT,
    RESTART_FIELDS,
    VALUE_FIELDS,
    journal_control,
    load_control,
    validate_control,
    write_control,
)
from .controller import Controller, ServeConfig
from .endpoint import ServeEndpoint
from .promote import (
    MANIFEST_BASENAME,
    MANIFEST_FORMAT,
    PromotionTampered,
    config_fingerprint,
    consensus_metrics,
    current_manifest,
    decide_promotion,
    prune_serving,
    snapshot_consensus,
    verify_promoted,
    write_candidate,
)
from .runtime import ControlKnobs, control_arrays


def __getattr__(name):
    # TrainerHarness lives in the `-m matcha_tpu_torch.serve.trainer` entry
    # module: importing it eagerly here would put the runpy target in
    # sys.modules before execution (RuntimeWarning in every subprocess
    # launch) — resolve it on first attribute access instead
    if name == "TrainerHarness":
        from .trainer import TrainerHarness

        return TrainerHarness
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__all__ = [
    "CONTROL_BASENAME",
    "ControlKnobs",
    "Controller",
    "MANIFEST_BASENAME",
    "MANIFEST_FORMAT",
    "PromotionTampered",
    "RESTART_EXIT",
    "RESTART_FIELDS",
    "ServeConfig",
    "ServeEndpoint",
    "TrainerHarness",
    "VALUE_FIELDS",
    "config_fingerprint",
    "consensus_metrics",
    "control_arrays",
    "current_manifest",
    "decide_promotion",
    "journal_control",
    "load_control",
    "prune_serving",
    "snapshot_consensus",
    "validate_control",
    "verify_promoted",
    "write_candidate",
]
