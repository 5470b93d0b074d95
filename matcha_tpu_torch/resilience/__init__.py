"""Runtime resilience: survive worker and link failures instead of aborting.

Port of ``matcha_tpu.resilience``: declarative fault plans compiled into
static per-step arrays (``faultplan``), and the self-healing arithmetic the
train step runs under them (``runtime``).  ``train/loop.py`` adds the
rollback recovery on top.
"""

from .faultplan import (
    FAULT_KINDS,
    FaultEvent,
    FaultPlan,
    RuntimeFaults,
    load_fault_plan,
    resolve_degraded_alpha,
)
from .runtime import (
    begin_mix_quarantined,
    finite_rows,
    gossip_quarantined,
    heal_and_mask,
    heal_worker_stat_rows,
    inject_nan_rows,
    mask_worker_rows,
    state_finite_rows,
)

__all__ = [
    "FAULT_KINDS",
    "FaultEvent",
    "FaultPlan",
    "RuntimeFaults",
    "begin_mix_quarantined",
    "finite_rows",
    "gossip_quarantined",
    "heal_and_mask",
    "heal_worker_stat_rows",
    "inject_nan_rows",
    "load_fault_plan",
    "mask_worker_rows",
    "resolve_degraded_alpha",
    "state_finite_rows",
]
