"""Decentralized gossip communicator (D-PSGD / MATCHA hot path).

Port of ``matcha_tpu/communicator/decen.py``: ``resolve_gossip_backend``
(:43) and ``make_decen`` (:77) with the port's backends,

* ``"perm"``   — the permutation-form CUDA kernel for every phase: the
                 per-step training mix is a T=1 launch, ``run`` chains are
                 one launch for the whole flag stream (``parallel.
                 perm_gossip_run``);
* ``"dense"``  — one matrix product ``W_t @ x`` per step
                 (``parallel.gossip_mix_dense``, ``torch.matmul`` in f32);
* ``"fused"``  — the dense step for training, and for a whole flag stream
                 (``run`` chains, the comm-split timer) the fused W-stack
                 CUDA kernel: one launch for the chain
                 (``parallel.fused_gossip_run``);
* ``"gather"`` — the per-matching gather oracle (``parallel.gossip_mix``);
* ``"skip"``   — the gather oracle with a host branch per matching
                 (``parallel.gossip_mix_skip``): an inactive matching
                 launches nothing.  Its flag rows stay on the host
                 (``Communicator.host_flags``), so the branch reads no
                 device value;
* ``"auto"``   — one of the above, chosen by ``resolve_gossip_backend``:
                 on one card ``plan.cost.choose_gossip_backend`` picks
                 ``perm`` from 4096 workers or when the dense form's
                 measured-vs-ceiling ratio reaches the gate, else
                 ``dense``.

The fused ``multi_step`` has no masked twin: its stack knows nothing of
survivors, so ``Communicator.run`` steps a masked chain through the dense
mix, as the JAX package does.  The JAX package's ``shard_map`` backend
(workers across cards) is not ported yet and raises.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..parallel import (
    build_mixing_stack,
    compose_mixing_stack,
    dense_gossip_fn,
    fused_gossip_run,
    gossip_mix,
    gossip_mix_skip,
    involution_tables,
    perm_gossip_run,
    resolve_wire_dtype,
)
from ..plan.cost import choose_gossip_backend
from ..schedule import Schedule
from ..utils import resolve_device
from .base import Communicator

__all__ = ["make_decen", "resolve_gossip_backend"]

PORTED_BACKENDS = ("perm", "dense", "fused", "gather", "skip", "auto")


def resolve_gossip_backend(schedule, mesh=None, requested: str = "auto",
                           dim=None, wire_dtype=None,
                           measured_vs_ceiling=None) -> dict:
    """Resolve a ``gossip_backend`` request to the backend that is built,
    with the decision record for the journal.

    A request other than ``auto`` passes through as it is (the record says
    so).  ``auto`` answers ``shard_map`` on a mesh of more than one device
    (the port has none yet, so that branch never runs) and on one card
    delegates to :func:`matcha_tpu_torch.plan.cost.choose_gossip_backend`.
    :func:`make_decen` and the training loop both call this, so the
    journaled decision is the backend that was built.
    """
    if requested != "auto":
        return {"requested": requested, "chosen": requested,
                "reason": "explicit config; no selection ran"}
    if mesh is not None and mesh.size > 1:
        return {"requested": "auto", "chosen": "shard_map",
                "reason": f"multi-device mesh ({mesh.size} devices): "
                          f"worker-folded ppermute plan rides ICI"}
    return choose_gossip_backend(
        schedule.num_workers, schedule.num_matchings, dim=dim,
        wire_dtype=wire_dtype,
        budget=float(np.mean(np.asarray(schedule.probs)))
        if len(schedule.probs) else None,
        topology=getattr(schedule, "name", None),
        measured_vs_ceiling=measured_vs_ceiling)


def make_decen(
    schedule: Schedule,
    backend: str = "auto",
    *,
    device=None,
    compute_dtype=torch.float32,
    chunk: int = 1,
    block_d: int | None = None,
    w_window: int = 1,
    wire_dtype=None,
) -> Communicator:
    """Build the gossip communicator for a schedule.

    ``device``: where the state lives (the tables are placed there once);
    ``None`` means CUDA, and a host without CUDA raises unless the caller
    passes ``device="cpu"``.  ``wire_dtype`` (``"f32"``/``"bf16"``/None)
    is the dtype of the exchanged values.  ``compute_dtype`` (dense and
    fused): the dtype the mixing matrices and the state are rounded to
    before each product, f32 accumulation either way; a bf16 wire turns an
    f32 ``compute_dtype`` into bf16 (the product's operand pass *is* the
    exchange), and an explicit narrower ``compute_dtype`` wins.

    ``chunk`` (fused only): collapse runs of ``chunk`` consecutive mixing
    matrices into their product before the kernel (``compose_mixing_stack``)
    — the same ``x_T`` for consensus-only chains; keep 1 for training.
    ``block_d``/``w_window`` tune the perm and fused kernels (tile width,
    steps per window) and never change their arithmetic.

    ``backend="auto"`` builds what :func:`resolve_gossip_backend` chooses
    with no measurement: ``perm`` from 4096 workers, else ``dense``.
    """
    dev = resolve_device(device)
    if backend == "auto":
        backend = resolve_gossip_backend(schedule,
                                         wire_dtype=wire_dtype)["chosen"]
    perms = np.asarray(schedule.perms)
    alpha = float(schedule.alpha)
    wire = resolve_wire_dtype(wire_dtype)
    if wire is not None and torch.finfo(compute_dtype).bits >= 32:
        compute_dtype = wire

    if backend not in ("fused", "perm") \
            and (block_d is not None or w_window != 1):
        warnings.warn(
            f"block_d/w_window tune the fused/perm backends' CUDA kernels; "
            f"backend '{backend}' ignores them. Note the fused kernel runs "
            f"multi-step *chains* (Communicator.run / the comm-split timer) "
            f"— the per-step training mix is a single dense product either "
            f"way.",
            stacklevel=2,
        )

    multi_step = multi_step_masked = None
    if backend == "gather":
        if perms.shape[1] >= 64:
            warnings.warn(
                f"gossip_backend='gather' walks the full state once per "
                f"matching and is the slowest backend at N={perms.shape[1]}. "
                f"Use backend='dense' or 'fused' (one card); 'gather' "
                f"remains for small-N debugging and oracle tests.",
                stacklevel=2,
            )

        def mix(x, w, alive=None):
            return gossip_mix(x, perms, w, alive, wire_dtype=wire)
    elif backend == "skip":
        def mix(x, w, alive=None):
            return gossip_mix_skip(x, perms, w, alive, wire_dtype=wire)
    elif backend in ("dense", "fused"):
        laplacians = torch.as_tensor(schedule.laplacians(),
                                     dtype=torch.float32, device=dev)
        mix = dense_gossip_fn(laplacians, compute_dtype=compute_dtype,
                              device=dev)
        if backend == "fused":
            kernel_kwargs = {"w_window": w_window}
            if block_d is not None:
                kernel_kwargs["block_d"] = block_d

            def multi_step(flat, carry, flags):
                stack = build_mixing_stack(laplacians, alpha, flags,
                                           dtype=compute_dtype)
                if chunk > 1:
                    stack = compose_mixing_stack(stack, chunk)
                return fused_gossip_run(flat, stack, **kernel_kwargs), carry
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
            f"{list(PORTED_BACKENDS)}; 'shard_map' (workers across cards) "
            f"lands with the multi-card work listed in ROADMAP.md")

    def init(flat: torch.Tensor):
        return ()

    def step(flat: torch.Tensor, carry, flags_t: torch.Tensor, alive=None):
        return mix(flat, alpha * flags_t, alive), carry

    wire_tag = "" if wire is None else ",wire=bfloat16"
    return Communicator(
        name=f"decen[{backend}{wire_tag}]", init=init, step=step,
        multi_step=multi_step, multi_step_masked=multi_step_masked,
        host_flags=backend == "skip",
    )
