"""Decentralized gossip communicator (D-PSGD / MATCHA hot path).

Port of ``matcha_tpu/communicator/decen.py``: ``make_decen`` (:77) with the
two backends of this slice,

* ``"perm"``   — the permutation-form CUDA kernel for every phase: the
                 per-step training mix is a T=1 launch, ``run`` chains are
                 one launch for the whole flag stream (``parallel.
                 perm_gossip_run``);
* ``"gather"`` — the per-matching gather oracle (``parallel.gossip_mix``).

The other backends of the JAX package (``dense``, ``fused``, ``skip``,
``shard_map`` and ``auto``, whose choice needs the planner's cost model)
are not ported yet and raise.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel import (
    gossip_mix,
    involution_tables,
    perm_gossip_run,
    resolve_wire_dtype,
)
from ..schedule import Schedule
from ..utils import resolve_device
from .base import Communicator

__all__ = ["make_decen"]

PORTED_BACKENDS = ("perm", "gather")


def make_decen(
    schedule: Schedule,
    backend: str = "perm",
    *,
    device=None,
    block_d: int | None = None,
    w_window: int = 1,
    wire_dtype=None,
) -> Communicator:
    """Build the gossip communicator for a schedule.

    ``device``: where the state lives (the tables are placed there once);
    ``None`` means CUDA, and a host without CUDA raises unless the caller
    passes ``device="cpu"``.  ``block_d``/``w_window`` tune the perm
    kernel (tile width, steps per weight window) and never change its
    arithmetic.  ``wire_dtype``
    (``"f32"``/``"bf16"``/None) is the dtype of the exchanged values.
    """
    dev = resolve_device(device)
    perms = np.asarray(schedule.perms)
    alpha = float(schedule.alpha)
    wire = resolve_wire_dtype(wire_dtype)

    multi_step = multi_step_masked = None
    if backend == "gather":
        def mix(x, w, alive=None):
            return gossip_mix(x, perms, w, alive, wire_dtype=wire)
    elif backend == "perm":
        perms_i32, partnered = involution_tables(perms)
        perms_t = torch.as_tensor(perms_i32, device=dev)
        partnered_t = torch.as_tensor(partnered, device=dev)
        kernel_kwargs = {"wire_dtype": wire, "w_window": w_window}
        if block_d is not None:
            kernel_kwargs["block_d"] = block_d

        # one kernel for every phase: the per-step mix is the T=1 chain of
        # the already α-scaled row, the chain forms scale the raw flags
        def mix(x, w, alive=None):
            return perm_gossip_run(x, w[None, :], perms_t, partnered_t,
                                   alive=alive, **kernel_kwargs)

        def multi_step(flat, carry, flags):
            return perm_gossip_run(flat, alpha * flags, perms_t, partnered_t,
                                   **kernel_kwargs), carry

        def multi_step_masked(flat, carry, flags, alive):
            return perm_gossip_run(flat, alpha * flags, perms_t, partnered_t,
                                   alive=alive, **kernel_kwargs), carry
    else:
        raise ValueError(
            f"gossip backend '{backend}' is not ported yet: the port has "
            f"{list(PORTED_BACKENDS)}; ROADMAP.md lists the order in which "
            f"the others ('dense', 'fused', 'skip', 'shard_map' and 'auto', "
            f"which needs the planner's cost model) land")

    def init(flat: torch.Tensor):
        return ()

    def step(flat: torch.Tensor, carry, flags_t: torch.Tensor, alive=None):
        return mix(flat, alpha * flags_t, alive), carry

    wire_tag = "" if wire is None else ",wire=bfloat16"
    return Communicator(
        name=f"decen[{backend}{wire_tag}]", init=init, step=step,
        multi_step=multi_step, multi_step_masked=multi_step_masked,
    )
