"""Worker-stack layout operations and the gossip-message compressors.
Port of ``matcha_tpu.ops``."""

from .compress import (
    COMPRESSOR_NAMES,
    DETERMINISTIC_COMPRESSORS,
    batched_random_k,
    batched_top_k,
    batched_top_k_approx,
    batched_top_k_q8,
    dense_from_sparse,
    quantize_stochastic,
    scatter_rows,
    select_compressor,
    top_k_ratio_size,
)
from .flatten import WorkerFlattener, make_flattener, tree_order

__all__ = [
    "COMPRESSOR_NAMES",
    "DETERMINISTIC_COMPRESSORS",
    "WorkerFlattener",
    "batched_random_k",
    "batched_top_k",
    "batched_top_k_approx",
    "batched_top_k_q8",
    "dense_from_sparse",
    "make_flattener",
    "quantize_stochastic",
    "scatter_rows",
    "select_compressor",
    "top_k_ratio_size",
    "tree_order",
]
