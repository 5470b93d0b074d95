"""Communicator interface: the per-iteration consensus transform.

Port of ``matcha_tpu/communicator/base.py`` (:58): a named pair of
functions on the ``[N, D]`` stack of all workers' flattened parameters,

    carry0      = comm.init(flat0)
    flat', c'   = comm.step(flat, carry, flags_t[, alive])

with ``flags_t`` the ``f32[M]`` activation row of this step, on the state's
device, or on the host for a communicator with ``host_flags`` (the skip
backend branches on it).  ``run`` applies a whole flag stream, through
``multi_step`` (one kernel launch for the chain) when the backend has one.
``run_overlapped``, ``run_pipelined`` and ``run_elided`` are not ported
yet (``ROADMAP.md``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

__all__ = ["Communicator"]

StepFn = Callable[..., Tuple[torch.Tensor, Any]]


@dataclasses.dataclass(frozen=True)
class Communicator:
    """A named (init, step) pair.

    ``step(flat, carry, flags_t)`` also accepts an optional fourth argument
    ``alive: f32[N]``, the survivor mask (a dead worker's exchanges become
    self-loops).  ``multi_step(flat, carry, flags[T, M])``, when present,
    runs a whole flag stream at once and equals stepping through it;
    ``multi_step_masked(flat, carry, flags, alive[N])`` is its twin under a
    constant survivor mask.  ``host_flags``: ``step`` takes its flag row
    as a host (CPU) tensor, so that it can branch on it without reading
    the device.  ``encode_probe(flat, x_hat) -> x_hat'``, when present
    (CHOCO), is the compress path alone, which the comm-split timer chains
    to measure the encode share of the exchange.
    """

    name: str
    init: Callable[[torch.Tensor], Any]
    step: StepFn
    multi_step: Any = None
    multi_step_masked: Any = None
    host_flags: bool = False
    encode_probe: Any = None

    def flags_device(self, device: torch.device) -> torch.device:
        """Where ``step`` wants its flag rows for a state on ``device``:
        there, or on the host."""
        return torch.device("cpu") if self.host_flags else device

    def run(self, flat: torch.Tensor, flags, carry: Any = None,
            alive: Any = None):
        """Apply the communicator over a whole flag stream (consensus-only
        chains, tests and the comm-split timer).

        ``alive``: optional survivor mask, ``f32[N]`` (constant for the
        chain) or ``f32[T, N]`` (per step).  A constant mask uses
        ``multi_step_masked`` when the backend offers one; otherwise
        masked chains step one row at a time."""
        if carry is None:
            carry = self.init(flat)
        flags = torch.as_tensor(flags, dtype=torch.float32,
                                device=self.flags_device(flat.device))
        if flags.shape[0] == 0:
            return flat, carry
        if alive is None:
            if self.multi_step is not None:
                return self.multi_step(flat, carry, flags)
            for t in range(flags.shape[0]):
                flat, carry = self.step(flat, carry, flags[t])
            return flat, carry
        alive = torch.as_tensor(alive, dtype=torch.float32, device=flat.device)
        if alive.ndim == 1 and self.multi_step_masked is not None:
            return self.multi_step_masked(flat, carry, flags, alive)
        for t in range(flags.shape[0]):
            a = alive if alive.ndim == 1 else alive[t]
            flat, carry = self.step(flat, carry, flags[t], a)
        return flat, carry
