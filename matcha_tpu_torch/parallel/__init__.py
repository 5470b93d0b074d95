"""Gossip primitives on worker-stacked ``[N, ...]`` tensors.  Port of the
single-card surface of ``matcha_tpu.parallel``: the wire-dtype and
precision seams, the gather oracle and its skipping twin, the per-matching
byte account, the dense backend, the centralized collectives, the
permutation-form kernel, the fused W-stack kernel, and the worker mesh with
the folded plan and its executor (workers card-major across cards), also
across processes (``multihost``: one process a card over
``torch.distributed``)."""

from .collectives import (
    allreduce_mean,
    broadcast_worker0,
    folded_allreduce_mean,
    masked_allreduce_mean,
    masked_mean_rows,
    worker_deviation,
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
    gossip_mix_folded,
    gossip_mix_skip,
    masked_laplacians,
    matching_wire_bytes,
    mxu_precision,
    resolve_wire_dtype,
    shard_map_gossip_fn,
)
from .mesh import (
    WORKER_AXIS,
    MeshDevice,
    WorkerBlocks,
    WorkerMesh,
    block_of,
    fold_dims,
    gather_workers,
    replicated,
    shard_workers,
    split_like,
    worker_mesh,
)
from .multihost import (
    dcn_aware_worker_order,
    global_worker_mesh,
    initialize_multihost,
)
from .perm_gossip import (
    LAUNCHES,
    involution_tables,
    perm_gossip_plain,
    perm_gossip_run,
    reset_launch_counts,
)

__all__ = [
    "WORKER_AXIS",
    "FoldedPlan",
    "LAUNCHES",
    "MeshDevice",
    "allreduce_mean",
    "broadcast_worker0",
    "build_folded_plan",
    "build_mixing_stack",
    "canonical_chunk",
    "compose_mixing_stack",
    "dcn_aware_worker_order",
    "WorkerBlocks",
    "WorkerMesh",
    "block_of",
    "dense_gossip_fn",
    "fold_dims",
    "folded_allreduce_mean",
    "fused_gossip_plain",
    "fused_gossip_run",
    "gather_workers",
    "global_worker_mesh",
    "gossip_mix",
    "gossip_mix_dense",
    "gossip_mix_folded",
    "gossip_mix_skip",
    "initialize_multihost",
    "involution_tables",
    "masked_allreduce_mean",
    "masked_laplacians",
    "masked_mean_rows",
    "matching_wire_bytes",
    "mxu_precision",
    "perm_gossip_plain",
    "perm_gossip_run",
    "replicated",
    "reset_launch_counts",
    "resolve_wire_dtype",
    "shard_map_gossip_fn",
    "shard_workers",
    "split_like",
    "worker_deviation",
    "worker_deviation_rows",
    "worker_disagreement",
    "worker_mesh",
]
