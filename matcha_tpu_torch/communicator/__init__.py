"""Communicators: the consensus transform of each training step.  Port of
``matcha_tpu.communicator`` without CHOCO (``ROADMAP.md``)."""

import warnings

from .base import Communicator
from .centralized import make_centralized, make_none
from .decen import make_decen

__all__ = ["Communicator", "make_centralized", "make_decen", "make_none",
           "select_communicator"]


def select_communicator(
    name: str,
    schedule=None,
    *,
    backend: str = "perm",
    device=None,
    block_d: int | None = None,
    w_window: int = 1,
    wire_dtype=None,
) -> Communicator:
    """Registry keyed by the reference's algorithm names, after
    ``matcha_tpu/communicator/__init__.py:21``: ``decen`` (D-PSGD/MATCHA,
    through :func:`make_decen` with ``backend``, ``device``, ``block_d``,
    ``w_window``), ``centralized`` (the AllReduce baseline) and ``none``.
    ``wire_dtype`` narrows the exchange of ``decen`` and ``centralized``
    (``none`` exchanges nothing).  ``choco`` is not ported yet."""
    if name == "decen":
        return make_decen(schedule, backend, device=device, block_d=block_d,
                          w_window=w_window, wire_dtype=wire_dtype)
    if block_d is not None or w_window != 1:
        warnings.warn(
            f"block_d/w_window tune the decen kernels and have no effect on "
            f"communicator '{name}' — the flags are being ignored",
            stacklevel=2,
        )
    if name == "centralized":
        return make_centralized(wire_dtype=wire_dtype)
    if name == "none":
        return make_none()
    if name == "choco":
        raise NotImplementedError(
            "communicator 'choco' is not ported yet (ROADMAP.md, Queue 1: "
            "CHOCO)")
    raise KeyError(f"unknown communicator '{name}'")
