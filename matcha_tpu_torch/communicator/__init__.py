"""Communicators: the consensus transform of each training step.  Port of
``matcha_tpu.communicator``."""

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
    mesh=None,
    block_d: int | None = None,
    w_window: int = 1,
    wire_dtype=None,
) -> Communicator:
    """Registry keyed by the reference's algorithm names, after
    ``matcha_tpu/communicator/__init__.py:21``: ``decen`` (D-PSGD/MATCHA,
    through :func:`make_decen` with ``backend``, ``device``, ``mesh``,
    ``block_d``, ``w_window``), ``choco`` (CHOCO-SGD, through
    :func:`make_choco` with ``ratio``, ``consensus_lr``, ``compressor``
    and ``seed``; ``auto`` is its folded ``shard_map`` form on a ``mesh``
    of more than one device and its batched form elsewhere, as in JAX
    (:63), ``shard_map`` the folded form, the gossip backends ``dense``,
    ``fused``, ``gather`` and ``perm`` its batched form, and ``skip`` is
    refused), ``centralized`` (the AllReduce baseline; on a mesh its state
    is folded and the mean is formed across the cards) and ``none``.
    ``wire_dtype`` narrows the exchange of every communicator but
    ``none``, which exchanges nothing."""
    if name == "decen":
        return make_decen(schedule, backend, device=device, mesh=mesh,
                          block_d=block_d, w_window=w_window,
                          wire_dtype=wire_dtype)
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
                          seed=seed, wire_dtype=wire_dtype, device=device,
                          mesh=mesh)
    if name == "centralized":
        return make_centralized(wire_dtype=wire_dtype)
    if name == "none":
        return make_none()
    raise KeyError(f"unknown communicator '{name}'")
