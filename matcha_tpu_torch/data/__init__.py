"""Data layer: partitioning across virtual workers, datasets and
worker-batched loading.  Port of ``matcha_tpu.data`` (numpy copy)."""

from .datasets import (
    Dataset,
    NORMALIZATION,
    WorkerBatches,
    augment_crop_flip,
    load_npz,
    normalize,
    normalized_zero,
    synthetic_classification,
    synthetic_images,
)
from .partition import (
    partition_fractions,
    partition_indices,
    partition_label_skew,
    partition_uniform,
)

__all__ = [
    "Dataset",
    "NORMALIZATION",
    "WorkerBatches",
    "augment_crop_flip",
    "load_npz",
    "normalize",
    "normalized_zero",
    "partition_fractions",
    "partition_indices",
    "partition_label_skew",
    "partition_uniform",
    "synthetic_classification",
    "synthetic_images",
]
