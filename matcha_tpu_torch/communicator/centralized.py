"""Centralized (AllReduce) communicator and the no-communication baseline.

Port of ``matcha_tpu/communicator/centralized.py``: ``make_centralized``
(:26), the survey's AllReduce baseline, and ``make_none`` (:56), the
ablation.  On the worker axis an AllReduce-average is a mean over rows;
on a worker mesh (a folded ``WorkerBlocks`` state) it is
``parallel.folded_allreduce_mean``, each card's column sum gathered on
card 0 and the mean sent back; on a mesh that spans processes every
process sums all C column sums in card order, bitwise the one-process
mean.
"""

from __future__ import annotations

import torch

from ..parallel import (
    WorkerBlocks,
    allreduce_mean,
    folded_allreduce_mean,
    masked_allreduce_mean,
    masked_mean_rows,
    resolve_wire_dtype,
)
from .base import Communicator

__all__ = ["make_centralized", "make_none"]


def make_centralized(wire_dtype=None) -> Communicator:
    """Every worker's row replaced by the mean of all rows.

    With a survivor mask, the average runs over alive rows only and dead
    rows are left untouched (quarantined).  ``wire_dtype``: the averaged
    operand is quantized to the wire dtype first (what each worker puts on
    the wire); the mean is accumulated in f32, and quarantined rows keep
    their *unquantized* values — the wire narrows the exchange, never the
    master state.  A folded ``flat`` (``WorkerBlocks``, a worker mesh)
    takes the same steps card by card, the mean formed across the cards
    in another order than one card's sum (f32 rounding apart)."""
    wire = resolve_wire_dtype(wire_dtype)

    def init(flat: torch.Tensor):
        return ()

    def step(flat: torch.Tensor, carry, flags_t, alive=None):
        if isinstance(flat, WorkerBlocks):
            operand = (None if wire is None else WorkerBlocks(
                (b.to(wire).to(b.dtype) for b in flat), flat.mesh))
            return folded_allreduce_mean(flat, alive, operand), carry
        flat_w = flat if wire is None else flat.to(wire).to(flat.dtype)
        if alive is None:
            return allreduce_mean(flat_w), carry
        if wire is None:
            return masked_allreduce_mean(flat, alive), carry
        mean = masked_mean_rows(flat_w, alive)
        w = alive.reshape((alive.shape[0],) + (1,) * (flat.ndim - 1))
        return torch.where(w > 0, mean.expand_as(flat), flat), carry

    name = "centralized" if wire is None else "centralized[wire=bfloat16]"
    return Communicator(name=name, init=init, step=step)


def make_none() -> Communicator:
    """Fully local training (no consensus): the ablation baseline."""

    def init(flat: torch.Tensor):
        return ()

    def step(flat: torch.Tensor, carry, flags_t, alive=None):
        return flat, carry

    return Communicator(name="none", init=init, step=step)
