"""Gossip primitives on worker-stacked ``[N, ...]`` tensors.  Port of the
slice-1 surface of ``matcha_tpu.parallel``: the wire-dtype seam, the gather
oracle, the centralized collectives and the permutation-form kernel."""

from .collectives import (
    allreduce_mean,
    broadcast_worker0,
    masked_allreduce_mean,
    masked_mean_rows,
    worker_disagreement,
)
from .gossip import gossip_mix, resolve_wire_dtype
from .perm_gossip import (
    LAUNCHES,
    involution_tables,
    perm_gossip_plain,
    perm_gossip_run,
    reset_launch_counts,
)

__all__ = [
    "LAUNCHES",
    "allreduce_mean",
    "broadcast_worker0",
    "gossip_mix",
    "involution_tables",
    "masked_allreduce_mean",
    "masked_mean_rows",
    "perm_gossip_plain",
    "perm_gossip_run",
    "reset_launch_counts",
    "resolve_wire_dtype",
    "worker_disagreement",
]
