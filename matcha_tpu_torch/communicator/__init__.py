"""Communicators: the consensus transform of each training step.  Port of
``matcha_tpu.communicator`` (CHOCO with its batched backend only)."""

import warnings

from .base import Communicator
from .centralized import make_centralized, make_none
from .choco import make_choco
from .decen import make_decen

__all__ = ["Communicator", "make_centralized", "make_choco", "make_decen",
           "make_none", "select_communicator"]


def select_communicator(
    name: str,
    schedule=None,
    *,
    ratio: float = 0.9,
    consensus_lr: float = 0.1,
    backend: str = "auto",
    compressor: str = "top_k",
    seed: int = 0,
    device=None,
    block_d: int | None = None,
    w_window: int = 1,
    wire_dtype=None,
) -> Communicator:
    """Registry keyed by the reference's algorithm names, after
    ``matcha_tpu/communicator/__init__.py:21``: ``decen`` (D-PSGD/MATCHA,
    through :func:`make_decen` with ``backend``, ``device``, ``block_d``,
    ``w_window``), ``choco`` (CHOCO-SGD, through :func:`make_choco` with
    ``ratio``, ``consensus_lr``, ``compressor`` and ``seed``; the gossip
    backends ``auto``, ``dense``, ``fused``, ``gather`` and ``perm`` all
    mean its batched form, and ``skip`` is refused), ``centralized`` (the AllReduce
    baseline) and ``none``.  ``wire_dtype`` narrows the exchange of every
    communicator but ``none``, which exchanges nothing."""
    if name == "decen":
        return make_decen(schedule, backend, device=device, block_d=block_d,
                          w_window=w_window, wire_dtype=wire_dtype)
    if block_d is not None or w_window != 1:
        warnings.warn(
            f"block_d/w_window tune the decen kernels and have no effect on "
            f"communicator '{name}' — the flags are being ignored",
            stacklevel=2,
        )
    if name == "choco":
        if backend == "skip":
            raise ValueError(
                "choco has no 'skip' backend (its exchange is already "
                "sparse); use communicator='decen' with backend='skip'")
        choco_backend = backend if backend in ("auto", "shard_map") \
            else "batched"
        return make_choco(schedule, ratio=ratio, consensus_lr=consensus_lr,
                          backend=choco_backend, compressor=compressor,
                          seed=seed, wire_dtype=wire_dtype, device=device)
    if name == "centralized":
        return make_centralized(wire_dtype=wire_dtype)
    if name == "none":
        return make_none()
    raise KeyError(f"unknown communicator '{name}'")
