"""Gossip primitives on worker-stacked ``[N, ...]`` tensors.  Port of the
single-card surface of ``matcha_tpu.parallel``: the wire-dtype and
precision seams, the gather oracle and its skipping twin, the per-matching
byte account, the dense backend, the centralized collectives, the
permutation-form kernel, the fused W-stack kernel, and the folded plan's
card-offset accounting that the planner's cost model reads."""

from .collectives import (
    allreduce_mean,
    broadcast_worker0,
    masked_allreduce_mean,
    masked_mean_rows,
    worker_deviation_rows,
    worker_disagreement,
)
from .folded import FoldedPlan, build_folded_plan
from .fused_gossip import (
    build_mixing_stack,
    canonical_chunk,
    compose_mixing_stack,
    fused_gossip_plain,
    fused_gossip_run,
)
from .gossip import (
    dense_gossip_fn,
    gossip_mix,
    gossip_mix_dense,
    gossip_mix_skip,
    masked_laplacians,
    matching_wire_bytes,
    mxu_precision,
    resolve_wire_dtype,
)
from .perm_gossip import (
    LAUNCHES,
    involution_tables,
    perm_gossip_plain,
    perm_gossip_run,
    reset_launch_counts,
)

__all__ = [
    "FoldedPlan",
    "LAUNCHES",
    "allreduce_mean",
    "broadcast_worker0",
    "build_folded_plan",
    "build_mixing_stack",
    "canonical_chunk",
    "compose_mixing_stack",
    "dense_gossip_fn",
    "fused_gossip_plain",
    "fused_gossip_run",
    "gossip_mix",
    "gossip_mix_dense",
    "gossip_mix_skip",
    "involution_tables",
    "masked_allreduce_mean",
    "masked_laplacians",
    "masked_mean_rows",
    "matching_wire_bytes",
    "mxu_precision",
    "perm_gossip_plain",
    "perm_gossip_run",
    "reset_launch_counts",
    "resolve_wire_dtype",
    "worker_deviation_rows",
    "worker_disagreement",
]
