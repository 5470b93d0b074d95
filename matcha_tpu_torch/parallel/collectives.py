"""Centralized collectives over the worker axis.

Port of ``matcha_tpu/parallel/collectives.py`` (:20-97): on a ``[N, ...]``
worker tensor the global average is a mean over the leading axis.  On a
worker mesh (a ``WorkerBlocks``) :func:`folded_allreduce_mean` forms it
across the cards, and :func:`masked_mean_rows` takes one too.  On a mesh
that spans processes each process forms its cards' partial sums, every
process receives all C of them (``multihost.all_cards``) and sums them in
card order, as the one-process functions sum them on card 0: the result
has their bits (``all_reduce``, whose order is unspecified, is not
used).
"""

from __future__ import annotations

import torch

from .mesh import WorkerBlocks, split_like
from .multihost import all_cards

__all__ = ["allreduce_mean", "broadcast_worker0", "folded_allreduce_mean",
           "masked_mean_rows", "masked_allreduce_mean", "worker_deviation",
           "worker_deviation_rows", "worker_disagreement"]


def _rows(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return mask.reshape((mask.shape[0],) + (1,) * (x.ndim - 1)).to(x.dtype)


def _card_parts(blocks: WorkerBlocks, parts: list) -> list:
    """Every card's part on ``blocks.device``, in card order: ``parts``
    (one per block held here) moved there, and on a mesh that spans
    processes the other processes' parts received."""
    first = blocks.device
    if blocks.mesh is None:
        return [p.to(first) for p in parts]
    return all_cards(blocks.mesh, dict(zip(blocks.cards, parts)), first)


def allreduce_mean(x: torch.Tensor) -> torch.Tensor:
    """Every worker's row replaced by the global average (AllReduce/size)."""
    return x.mean(dim=0, keepdim=True).expand_as(x).clone()


def masked_mean_rows(x, alive: torch.Tensor) -> torch.Tensor:
    """Mean of the rows where ``alive > 0``.  Masked rows are excluded with
    ``where``, not a multiply (``0·NaN = NaN`` would leak a quarantined
    row); no survivors at all gives the zero vector.

    ``x`` a ``WorkerBlocks`` (``alive``: ``f32[N]`` on any device): from
    per-card partials, each card's masked column sum moved to card 0 and
    summed there, the mean on card 0.  Between real cards that moves C
    rows, not N; the sum runs in another order than the one-tensor
    function's, so the two agree to f32 rounding."""
    if isinstance(x, WorkerBlocks):
        first = x.device
        alive = torch.as_tensor(alive, dtype=torch.float32)
        parts = []
        for g, b in zip(split_like(alive, x), x):
            w = _rows(g, b)
            parts.append((w * torch.where(w > 0, b, torch.zeros_like(b)))
                         .sum(dim=0))
        return torch.stack(_card_parts(x, parts)).sum(dim=0) / torch.clamp(
            alive.to(first).sum(), min=1.0)
    w = _rows(alive, x)
    kept = torch.where(w > 0, x, torch.zeros_like(x))
    return (w * kept).sum(dim=0) / torch.clamp(alive.sum(), min=1.0)


def masked_allreduce_mean(x: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """AllReduce-average over the alive rows only; dead rows keep their own
    values."""
    mean = masked_mean_rows(x, alive)
    return torch.where(_rows(alive, x) > 0, mean.expand_as(x), x)


def folded_allreduce_mean(blocks: WorkerBlocks, alive=None,
                          operand: WorkerBlocks = None) -> WorkerBlocks:
    """:func:`allreduce_mean` (with ``alive``, :func:`masked_allreduce_mean`)
    of a folded ``[N, ...]`` state: each card's column sum of ``operand``
    (default: ``blocks``; the wire's quantized image, say) goes to card 0,
    the mean comes back to every card, and each card writes it into its
    rows (with ``alive``, into its alive rows, the others keeping their
    values in ``blocks``).  Between real cards that moves ``2·C`` rows,
    not ``N``.  The sum runs in another order than the one-tensor
    function's (per card, then over the cards), so the two agree to f32
    rounding, not bitwise.  ``alive``: ``f32[N]`` on any device."""
    operand = blocks if operand is None else operand
    if alive is None:
        total = torch.stack(_card_parts(operand,
                                        [o.sum(dim=0) for o in operand]))
        mean = total.sum(dim=0) / (len(total) * blocks[0].shape[0])
        return WorkerBlocks((mean.to(b.device).expand_as(b).clone()
                             for b in blocks), blocks.mesh)
    mean = masked_mean_rows(operand, alive)
    gates = split_like(torch.as_tensor(alive, dtype=torch.float32), blocks)
    return WorkerBlocks(
        (torch.where(_rows(g, b) > 0, mean.to(b.device).expand_as(b), b)
         for g, b in zip(gates, blocks)), blocks.mesh)


def broadcast_worker0(x: torch.Tensor) -> torch.Tensor:
    """Every worker's row replaced by worker 0's."""
    return x[0:1].expand_as(x).clone()


def worker_disagreement(x: torch.Tensor, alive=None) -> torch.Tensor:
    """RMS distance of worker rows from consensus: ``‖x − x̄‖ / √(N·D)``.

    With ``alive`` the mean and the RMS are both restricted to the alive
    rows."""
    if alive is None:
        centered = x - x.mean(dim=0, keepdim=True)
        return torch.sqrt(torch.mean(centered * centered))
    w = _rows(alive, x)
    centered = torch.where(w > 0, x - masked_mean_rows(x, alive)[None],
                           torch.zeros_like(x))
    denom = torch.clamp(alive.sum(), min=1.0) * (x.numel() // x.shape[0])
    return torch.sqrt(torch.sum(centered * centered) / denom)


def worker_deviation_rows(x: torch.Tensor, alive=None) -> torch.Tensor:
    """Per-worker RMS distance from consensus, ``f32[N]``: row i's
    ``‖x_i − x̄‖ / √D``, the per-worker decomposition of
    :func:`worker_disagreement`.  With ``alive`` the consensus point is
    the survivor mean and quarantined rows report 0."""
    return worker_deviation(x, alive)[0]


def worker_deviation(x: torch.Tensor, alive=None):
    """``(worker_deviation_rows, disagreement)`` from one pass over ``x``:
    the scalar is the alive-weighted RMS of the rows, which is
    :func:`worker_disagreement` summed in another order (the training
    step's telemetry reads both)."""
    if alive is None:
        centered = x - x.mean(dim=0, keepdim=True)
    else:
        w = _rows(alive, x)
        centered = torch.where(w > 0, x - masked_mean_rows(x, alive)[None],
                               torch.zeros_like(x))
    sq = torch.mean((centered * centered).reshape(x.shape[0], -1), dim=1)
    if alive is None:
        return torch.sqrt(sq), torch.sqrt(sq.mean())
    return torch.sqrt(sq), torch.sqrt(sq.sum()
                                      / torch.clamp(alive.sum(), min=1.0))
