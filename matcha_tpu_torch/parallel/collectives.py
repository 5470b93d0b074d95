"""Centralized collectives over the worker axis.

Port of ``matcha_tpu/parallel/collectives.py`` (:20-80): on a ``[N, ...]``
worker tensor the global average is a mean over the leading axis.
"""

from __future__ import annotations

import torch

__all__ = ["allreduce_mean", "broadcast_worker0", "masked_mean_rows",
           "masked_allreduce_mean", "worker_disagreement"]


def _rows(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return mask.reshape((mask.shape[0],) + (1,) * (x.ndim - 1)).to(x.dtype)


def allreduce_mean(x: torch.Tensor) -> torch.Tensor:
    """Every worker's row replaced by the global average (AllReduce/size)."""
    return x.mean(dim=0, keepdim=True).expand_as(x).clone()


def masked_mean_rows(x: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """Mean of the rows where ``alive > 0``.  Masked rows are excluded with
    ``where``, not a multiply (``0·NaN = NaN`` would leak a quarantined
    row); no survivors at all gives the zero vector."""
    w = _rows(alive, x)
    kept = torch.where(w > 0, x, torch.zeros_like(x))
    return (w * kept).sum(dim=0) / torch.clamp(alive.sum(), min=1.0)


def masked_allreduce_mean(x: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """AllReduce-average over the alive rows only; dead rows keep their own
    values."""
    mean = masked_mean_rows(x, alive)
    return torch.where(_rows(alive, x) > 0, mean.expand_as(x), x)


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
