"""Elastic membership: join, leave and rejoin over a static pool of worker
slots.  Port of ``matcha_tpu.elastic``: the host half (``membership``:
declarative churn traces, the slot reconciler, the epoch-boundary
controller) and the device half (``runtime``: the step's membership input,
the freeze of vacant slots and the (re)join bootstrap) and the offline
policy scorer (``policy``, imported as ``elastic.policy``).  The live
membership source is not ported yet (``ROADMAP.md``)."""

from .membership import (
    MEMBERSHIP_KINDS,
    ElasticController,
    MembershipEvent,
    MembershipTrace,
    MembershipTransition,
    MembershipView,
    load_membership_trace,
)
from .runtime import (
    Membership,
    freeze_worker_rows,
    make_bootstrap_fn,
    membership_arrays,
    vacant_rows,
)

__all__ = [
    "MEMBERSHIP_KINDS",
    "ElasticController",
    "Membership",
    "MembershipEvent",
    "MembershipTrace",
    "MembershipTransition",
    "MembershipView",
    "freeze_worker_rows",
    "load_membership_trace",
    "make_bootstrap_fn",
    "membership_arrays",
    "vacant_rows",
]
