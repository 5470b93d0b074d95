"""The device rule of the port's entry points."""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "synchronize"]


def resolve_device(device=None) -> torch.device:
    """``None`` means the card: entry points run on CUDA unless the caller
    asks for the CPU.  Raises ``RuntimeError`` when CUDA is asked for (or
    defaulted to) on a host without it — never a quiet CPU run."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; pass device='cpu' to run "
            "the port's plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"the port runs on 'cuda' or 'cpu', got {dev}")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the card's queued work before a host clock read (CUDA
    launches return before the work is done); a no-op on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
