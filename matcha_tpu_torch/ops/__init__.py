"""Worker-stack layout operations.  Port of ``matcha_tpu.ops.flatten``."""

from .flatten import WorkerFlattener, make_flattener, tree_order

__all__ = ["WorkerFlattener", "make_flattener", "tree_order"]
