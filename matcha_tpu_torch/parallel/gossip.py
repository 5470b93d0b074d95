"""Gossip averaging on a worker-stacked ``[N, ...]`` tensor.

Port of ``matcha_tpu/parallel/gossip.py``: the wire-dtype seam
(``resolve_wire_dtype``, :78) and the gather oracle (``gossip_mix``, :138).
One gossip step with matchings ``π_j`` (involutions over workers, fixed
points = unmatched) and per-step weights ``w_j = α·flag_j``:

    x_i ← x_i + Σ_j w_j · (x_{π_j(i)} − x_i)

An optional ``alive: f32[N]`` survivor mask realizes an edge only when both
endpoints live (its delta is scaled by ``alive_i · alive_{π_j(i)}``), so
every realized mixing matrix stays doubly stochastic over the survivors.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["gossip_mix", "resolve_wire_dtype"]


def resolve_wire_dtype(wire_dtype):
    """Normalize the wire-dtype knob to ``None`` (exact f32 program) or the
    torch dtype the exchange casts to at the gossip boundary.

    ``"f32"``/``None``/``torch.float32`` mean no cast anywhere; ``"bf16"``
    quantizes every exchanged value to bfloat16 while the state and the
    delta accumulation stay f32.
    """
    if wire_dtype is None:
        return None
    if isinstance(wire_dtype, str):
        if wire_dtype in ("f32", "float32"):
            return None
        if wire_dtype in ("bf16", "bfloat16"):
            return torch.bfloat16
        raise ValueError(f"unknown wire_dtype '{wire_dtype}' (f32|bf16)")
    if not isinstance(wire_dtype, torch.dtype):
        raise ValueError(f"unknown wire_dtype {wire_dtype!r} (f32|bf16 or a "
                         f"torch dtype)")
    return None if wire_dtype == torch.float32 else wire_dtype


def _rows(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Broadcast a per-row ``[R]`` mask over the trailing dims of ``[R, ...]``."""
    return mask.reshape(mask.shape + (1,) * (x.ndim - 1))


def gossip_mix(x: torch.Tensor, perms, weights, alive=None,
               wire_dtype=None) -> torch.Tensor:
    """``x_i + Σ_j weights[j]·(x[π_j(i)] − x_i)`` over the leading axis.

    ``perms``: ``int[M, N]`` partner tables (numpy); ``weights``: ``[M]``
    (a tensor on ``x``'s device, typically ``alpha * flags[t]``).  With a
    narrow ``wire_dtype`` the exchanged values are quantized once, before
    the gathers, and both endpoints form the delta from the quantized
    values, so pairwise cancellation (exact worker-mean preservation)
    survives the narrow wire.  Same operation order as the JAX oracle.
    """
    perms = np.asarray(perms)
    if perms.ndim != 2 or perms.shape[1] != x.shape[0]:
        raise ValueError(f"perms {perms.shape} incompatible with x "
                         f"{tuple(x.shape)}")
    wire = resolve_wire_dtype(wire_dtype)
    xw = x if wire is None else x.to(wire).to(x.dtype)
    index = torch.as_tensor(perms, dtype=torch.long, device=x.device)
    rows = np.arange(perms.shape[1])
    acc = torch.zeros_like(x)
    for j in range(perms.shape[0]):
        if np.array_equal(perms[j], rows):
            continue  # empty matching: zero delta regardless of flag
        delta = xw.index_select(0, index[j]) - xw
        if alive is not None:
            delta = _rows(alive * alive.index_select(0, index[j]), delta) * delta
        acc = acc + weights[j] * delta
    return x + acc
