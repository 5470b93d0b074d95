"""Communicator interface: the per-iteration consensus transform.

Port of ``matcha_tpu/communicator/base.py`` (:58): a named pair of
functions on the ``[N, D]`` stack of all workers' flattened parameters,

    carry0      = comm.init(flat0)
    flat', c'   = comm.step(flat, carry, flags_t[, alive])

with ``flags_t`` the ``f32[M]`` activation row of this step, on the state's
device, or on the host for a communicator with ``host_flags`` (the skip
backend branches on it).  ``run`` applies a whole flag stream, through
``multi_step`` (one kernel launch for the chain) when the backend has one.

The two-phase form of ``step`` (JAX ``base.py:93``, :117), which the
pipelined training step runs:

    delta, c' = comm.begin_mix(flat, carry, flags_t[, alive])  # issue
    flat'     = comm.apply_mix(flat, delta)                    # consume

``begin_mix`` runs this step's whole exchange and returns the mixing delta
``step(flat)[0] − flat``, a tensor of its own (never a view of ``flat``);
``apply_mix`` is an elementwise add.  Every transform here keeps the worker
mean (doubly stochastic ``W``; CHOCO's telescoping ``s``/``x̂``), so a
delta has zero column mean, and applying it late moves only the spread of
the workers, never their mean.  ``run_overlapped`` (:123),
``run_pipelined`` (:182, a ring of K in-flight deltas) and ``run_elided``
(:258, local steps that execute nothing) chain it, or ``step``, over a
flag stream.  JAX's ``lax.scan``/``lax.cond`` become host loops and host
branches on the step index: no device value is read to decide anything.

On a worker mesh (``decen``'s and CHOCO's folded backends,
``centralized``, and the one-tensor backends through
:func:`gathered_communicator`) ``flat`` is a ``parallel.WorkerBlocks``,
the C card-major blocks: ``step``, ``run``, ``begin_mix``/``apply_mix``,
``run_overlapped`` and ``run_pipelined`` (its ring K ``WorkerBlocks``)
take and return one.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from ..parallel.mesh import (
    WorkerBlocks,
    _tree_map,
    gather_workers,
    is_worker_rows,
    shard_workers,
)
from ..parallel.multihost import gather_to_first, scatter_tree_from_first

__all__ = ["Communicator", "gathered_communicator"]

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

    def _step(self, flat, carry, flags_t, alive=None):
        """``step``, with the survivor mask only where there is one."""
        if alive is None:
            return self.step(flat, carry, flags_t)
        return self.step(flat, carry, flags_t, alive)

    def _chain_inputs(self, flat, flags, carry, alive):
        """A chain's flag rows (where ``step`` wants them), carry (``init``
        when None) and survivor mask, as tensors."""
        if carry is None:
            carry = self.init(flat)
        flags = torch.as_tensor(flags, dtype=torch.float32,
                                device=self.flags_device(flat.device))
        if alive is not None:
            alive = torch.as_tensor(alive, dtype=torch.float32,
                                    device=flat.device)
        return flags, carry, alive

    @staticmethod
    def _alive_at(alive, t: int):
        """Step t's mask of an ``f32[N]`` or ``f32[T, N]`` mask."""
        return alive if alive is None or alive.ndim == 1 else alive[t]

    def begin_mix(self, flat: torch.Tensor, carry: Any, flags_t,
                  alive: Any = None):
        """Issue this step's exchange; returns ``(delta, carry')`` with
        ``delta = step(flat)[0] − flat``.  Every launch of the exchange
        happens here, and the carry advances at issue time (CHOCO's
        ``{x̂, s}``), so a pipelined chain threads carries as an eager one
        does.  The subtraction makes ``delta`` a new tensor even where
        ``step`` returns ``flat`` itself (``none``)."""
        mixed, carry = self._step(flat, carry, flags_t, alive)
        return mixed - flat, carry

    def apply_mix(self, flat: torch.Tensor,
                  delta: torch.Tensor) -> torch.Tensor:
        """Consume a ``begin_mix`` delta: ``flat + delta``, no exchange."""
        return flat + delta

    def run_overlapped(self, flat: torch.Tensor, flags, carry: Any = None,
                       alive: Any = None, drain: bool = True):
        """The one-step pipeline over a flag stream: step t applies the
        delta issued at t−1, then issues its own.

        On a pure consensus chain the drained pipeline is ``run`` up to f32
        reassociation (about an ulp a step); a bf16 wire re-rounds the
        slightly different state, so there the two agree to the 2⁻⁸ noise
        of the wire.  ``drain=True`` applies the last delta and returns
        ``(flat, carry)``; ``drain=False`` returns ``(visible state,
        carry, pending delta)``, what an epoch boundary of the pipelined
        train loop holds.  ``alive``: ``f32[N]`` or ``f32[T, N]``."""
        flags, carry, alive = self._chain_inputs(flat, flags, carry, alive)
        pending = (flat.zeros_like() if isinstance(flat, WorkerBlocks)
                   else torch.zeros_like(flat))
        for t in range(flags.shape[0]):
            flat = self.apply_mix(flat, pending)
            pending, carry = self.begin_mix(flat, carry, flags[t],
                                            self._alive_at(alive, t))
        if drain:
            return self.apply_mix(flat, pending), carry
        return flat, carry, pending

    def run_pipelined(self, flat: torch.Tensor, flags, carry: Any = None,
                      alive: Any = None, staleness: int = 1,
                      drain: bool = True):
        """The bounded-staleness pipeline, consume-at-t+K, over a ``[K, N,
        D]`` ring of in-flight deltas: step t applies slot ``t mod K`` (the
        delta issued at t−K, zero in the first K steps), then issues into
        the same slot.  ``staleness=1`` is :meth:`run_overlapped` bit for
        bit.  For K > 1 each delta is issued on a state missing its K−1
        in-flight predecessors, so the chain is not ``run``'s, but every
        delta has zero column mean and the worker mean never moves; on a
        stream that fires at most once every K steps each delta is
        consumed before the next is issued, and the drained chain is
        ``run``'s again.  ``drain=True`` flushes the ring oldest-first
        (slot ``(T + i) mod K`` for i = 0..K−1) and returns ``(flat,
        carry)``; ``drain=False`` returns ``(visible state, carry,
        ring)``: the ring a ``[K, N, D]`` tensor, or on a worker mesh a
        list of K ``WorkerBlocks``, slot by slot."""
        k = int(staleness)
        if k < 1:
            raise ValueError(f"staleness must be >= 1, got {staleness}")
        flags, carry, alive = self._chain_inputs(flat, flags, carry, alive)
        if isinstance(flat, WorkerBlocks):
            ring = [flat.zeros_like() for _ in range(k)]
        else:
            ring = torch.zeros((k,) + tuple(flat.shape), dtype=flat.dtype,
                               device=flat.device)
        steps = flags.shape[0]
        if steps == 0:
            return (flat, carry) if drain else (flat, carry, ring)
        for t in range(steps):
            slot = t % k
            flat = self.apply_mix(flat, ring[slot])
            delta, carry = self.begin_mix(flat, carry, flags[t],
                                          self._alive_at(alive, t))
            ring[slot] = delta
        if not drain:
            return flat, carry, ring
        for i in range(k):
            flat = self.apply_mix(flat, ring[(steps + i) % k])
        return flat, carry

    def run_elided(self, flat: torch.Tensor, flags, local_every: int,
                   carry: Any = None, alive: Any = None, offset: int = 0):
        """The chain with local-step elision: step t runs ``step`` only
        when ``(t + offset) % local_every == 0``; any other step executes
        nothing (no launch, no carry advance).  So ``run_elided(flags, L)``
        is ``run(flags[::L])`` on the executed rows, and on a stream whose
        other rows are zero it is ``run`` (a zero row mixes by the
        identity).  ``local_every``: a Python int (values below 1 count as
        1); ``offset`` aligns the cursor mid-stream."""
        flags, carry, alive = self._chain_inputs(flat, flags, carry, alive)
        every = max(int(local_every), 1)
        for t in range(flags.shape[0]):
            if (t + int(offset)) % every == 0:
                flat, carry = self._step(flat, carry, flags[t],
                                         self._alive_at(alive, t))
        return flat, carry

    def run(self, flat: torch.Tensor, flags, carry: Any = None,
            alive: Any = None):
        """Apply the communicator over a whole flag stream (consensus-only
        chains, tests and the comm-split timer).

        ``alive``: optional survivor mask, ``f32[N]`` (constant for the
        chain) or ``f32[T, N]`` (per step).  A constant mask uses
        ``multi_step_masked`` when the backend offers one; otherwise
        masked chains step one row at a time."""
        flags, carry, alive = self._chain_inputs(flat, flags, carry, alive)
        if flags.shape[0] == 0:
            return flat, carry
        if alive is None and self.multi_step is not None:
            return self.multi_step(flat, carry, flags)
        if alive is not None and alive.ndim == 1 \
                and self.multi_step_masked is not None:
            return self.multi_step_masked(flat, carry, flags, alive)
        for t in range(flags.shape[0]):
            flat, carry = self._step(flat, carry, flags[t],
                                     self._alive_at(alive, t))
        return flat, carry


def _fold_rows(tree, mesh, num_workers: int):
    """The worker-major floating tensors of a carry-like value folded onto
    ``mesh`` (``shard_workers``); anything else (a generator's state) as
    it is, on card 0."""
    if isinstance(tree, dict):
        return {k: _fold_rows(v, mesh, num_workers) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_fold_rows(v, mesh, num_workers) for v in tree)
    return shard_workers(tree, mesh) if is_worker_rows(tree, num_workers) \
        else tree


def gathered_communicator(comm: Communicator, mesh) -> Communicator:
    """A one-tensor communicator (built on ``mesh.devices[0]``) over a
    worker mesh, as the JAX package runs its one-tensor backends on a
    sharded state: each call gathers the folded state and carry onto card
    0 (``parallel.gather_workers``), runs ``comm`` there on the ``[N, D]``
    tensor (the perm kernel, the dense product, the fused kernel's
    chains) and folds the result back (``parallel.shard_workers``; the
    carry's worker rows too, so that it is checkpointed and masked as a
    folded carry is).  Every row is the one-card communicator's, bit for
    bit, whatever C is.  The flag rows and the survivor mask are where
    ``comm`` wants them: on card 0.

    On a mesh that spans processes (``comm`` built on this process's
    first card) the state and the carry's folded rows are sent to the
    process that owns card 0 (``multihost.gather_to_first``), ``comm``
    runs there alone, and the result's rows are sent back and its other
    leaves broadcast (``multihost.scatter_tree_from_first``): one launch
    of the one-card kernel for the whole job, bitwise the one-card call.
    Every process passes its own replicated flag row and mask; only the
    first card's process reads them."""
    if mesh.multi_process:
        return _gathered_across_processes(comm, mesh)
    first = mesh.devices[0]

    def gathered(fn):
        if fn is None:
            return None

        def call(flat, carry, *args):
            x = gather_workers(flat, first)
            out, carry = fn(x, gather_workers(carry, first), *args)
            return (shard_workers(out, mesh),
                    _fold_rows(carry, mesh, x.shape[0]))

        return call

    def init(flat):
        x = gather_workers(flat, first)
        return _fold_rows(comm.init(x), mesh, x.shape[0])

    encode_probe = None
    if comm.encode_probe is not None:
        def encode_probe(flat, x_hat):
            return shard_workers(comm.encode_probe(
                gather_workers(flat, first), gather_workers(x_hat, first)),
                mesh)

    return dataclasses.replace(
        comm, init=init, step=gathered(comm.step),
        multi_step=gathered(comm.multi_step),
        multi_step_masked=gathered(comm.multi_step_masked),
        encode_probe=encode_probe)


def _gathered_across_processes(comm: Communicator, mesh) -> Communicator:
    """:func:`gathered_communicator` on a mesh that spans processes."""
    leads = mesh.rank == mesh.owner(0)

    def collect(tree):
        return _tree_map(lambda a: gather_to_first(a)
                         if isinstance(a, WorkerBlocks) else a, tree)

    def on_first(fn, flat, *rest):
        """``fn(flat, *rest)`` with every folded value gathered, in the
        first card's process (None elsewhere), its result folded back."""
        x = gather_to_first(flat)
        rest = collect(rest)
        out = fn(x, *rest) if leads else None
        return scatter_tree_from_first(out, mesh,
                                       mesh.size * flat[0].shape[0])

    def gathered(fn):
        if fn is None:
            return None

        def call(flat, carry, *args):
            return on_first(fn, flat, carry, *args)

        return call

    encode_probe = None
    if comm.encode_probe is not None:
        def encode_probe(flat, x_hat):
            return on_first(comm.encode_probe, flat, x_hat)

    return dataclasses.replace(
        comm, init=lambda flat: on_first(comm.init, flat),
        step=gathered(comm.step), multi_step=gathered(comm.multi_step),
        multi_step_masked=gathered(comm.multi_step_masked),
        encode_probe=encode_probe)
