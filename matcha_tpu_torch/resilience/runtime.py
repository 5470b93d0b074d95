"""Self-healing primitives executed inside the train step.

Port of ``matcha_tpu/resilience/runtime.py`` (:33-200) on ``[N, ...]``
tensors.  Resilience is arithmetic on the worker axis: non-finite rows are
detected with a per-row reduction, quarantined by zeroing their edges in
the gossip mask (the masked mixing stays doubly stochastic over the
survivors) and by sealing their values to zero on the gossip input, and
healed by overwriting them with the survivors' mean.  Every mask is a
``torch.where`` (or ``masked_fill_``), never a multiply: the row being
masked is typically the one holding the NaN, and ``0·NaN = NaN``.

Healing is conservative: a row is only overwritten when there is at least
one alive-and-finite donor and the donors' mean is finite.  That guard,
``can_heal``, is a device predicate: nothing here reads the device.

The JAX pytree walks become walks over the port's state: the model's
parameters and buffers, the optimizer's ``momentum_buffer`` per parameter
(``None`` before the first step), the communicator's carry (a tensor, or
a dict/tuple/list of them) and the pipeline's ``mix_pending``.  A tensor
is worker-major when its leading axis is the worker count; only floating
tensors are touched (a stochastic compressor's ``uint8`` generator state
passes through).

On a worker mesh the parameter stack is a ``parallel.WorkerBlocks`` (the
C card-major ``[L, D]`` blocks) and the masks stay ``f32[N]`` on card 0:
:func:`finite_rows`, :func:`inject_nan_rows`, :func:`heal_and_mask` and
the quarantined gossip take one and work block by block, each card on
its slice of the masks, and the donors' mean comes from per-card
partials (``parallel.masked_mean_rows``); :func:`heal_folded_stat_rows`
is :func:`heal_worker_stat_rows` over the cards' statistics.
"""

from __future__ import annotations

from typing import Any, Iterator, Tuple

import torch

from ..parallel import WorkerBlocks, masked_mean_rows, split_like

__all__ = ["begin_mix_quarantined", "finite_rows", "gossip_quarantined",
           "heal_and_mask", "heal_folded_stat_rows", "heal_worker_stat_rows",
           "inject_nan_rows", "mask_worker_rows", "state_finite_rows",
           "state_tensors"]


def _rows(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``[N]`` mask broadcast over the trailing dims of ``[N, ...]``."""
    return mask.reshape((mask.shape[0],) + (1,) * (x.ndim - 1))


def _worker_major(x, num_workers: int) -> bool:
    return (isinstance(x, torch.Tensor) and x.is_floating_point()
            and x.ndim >= 1 and x.shape[0] == num_workers)


def tensors_in(tree: Any) -> Iterator[torch.Tensor]:
    """Every tensor of a carry-like value: a tensor, or a dict, tuple or
    list of them (nested)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tensors_in(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from tensors_in(v)


def per_card(fn, mask: torch.Tensor, *xs):
    """``fn(mask, *xs)`` on ``[N, ...]`` tensors; on ``WorkerBlocks``
    block by block, each with its card's slice of the ``[N]`` mask
    (``parallel.split_like``)."""
    if isinstance(xs[0], WorkerBlocks):
        return WorkerBlocks(fn(m, *blocks) for m, *blocks in
                            zip(split_like(mask, xs[0]), *xs))
    return fn(mask, *xs)


def finite_rows(flat) -> torch.Tensor:
    """``f32[N]``: 1.0 where the row is entirely finite (of a
    ``WorkerBlocks``: every card's rows, in worker order on card 0)."""
    if isinstance(flat, WorkerBlocks):
        return torch.cat([finite_rows(b).to(flat.device) for b in flat])
    return torch.isfinite(flat).reshape(flat.shape[0], -1).all(dim=1).to(
        torch.float32)


def inject_nan_rows(flat, inject: torch.Tensor):
    """Poison the rows where ``inject > 0`` (the ``nan`` fault event)."""
    return per_card(lambda m, x: torch.where(
        _rows(m, x) > 0, torch.full_like(x, float("nan")), x), inject, flat)


def heal_and_mask(flat, alive_t: torch.Tensor, revive_t: torch.Tensor
                  ) -> Tuple[Any, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quarantine, heal, and return the effective survivor mask.

    Returns ``(flat, ok, healed, finite)``, the masks ``f32[N]``:

    * ``ok``: rows that gossip this step, planned alive ∧ finite (after
      the heal);
    * ``healed``: rows overwritten with the donors' mean, the planned
      revivals and the alive rows that are not finite;
    * ``finite``: the rows' finiteness after the heal (``finite_before ∨
      healed``), which seals the gossip input without a second pass.

    The donors are the alive, finite rows not being healed (a revived
    worker's own stale row does not vote on where it rejoins)."""
    finite = finite_rows(flat)
    ok = alive_t * finite
    want_heal = torch.clamp(revive_t + alive_t * (1.0 - finite), 0.0, 1.0)
    donors = ok * (1.0 - want_heal)
    mean = masked_mean_rows(flat, donors)
    can_heal = (donors.sum() > 0) & torch.isfinite(mean).all()
    healed = want_heal * can_heal.to(torch.float32)
    flat = fill_rows(flat, healed, mean)
    finite = torch.clamp(finite + healed, 0.0, 1.0)
    ok = alive_t * finite
    return flat, ok, healed, finite


def fill_rows(flat, rows: torch.Tensor, value: torch.Tensor):
    """``flat`` with the rows where ``rows > 0`` replaced by the row
    ``value`` (``[...]``, on any device)."""
    return per_card(lambda m, x: torch.where(
        _rows(m, x) > 0, value.to(x.device).expand_as(x), x), rows, flat)


def _seal(flat, gate):
    """``(sealed input, gate)``: the rows where ``gate`` is 0 zeroed."""
    if gate is None:
        gate = finite_rows(flat)
    return per_card(lambda g, x: torch.where(
        _rows(g, x) > 0, x, torch.zeros_like(x)), gate, flat), gate


def gossip_quarantined(step_fn, flat, carry: Any, flags_t,
                       ok: torch.Tensor, gate=None):
    """One communicator step with the non-finite rows sealed: zeros on the
    input (their edges are already weight-zero through ``ok``, so the zeros
    contribute nothing and ``0·NaN`` cannot leak), and the original rows
    restored on the output, where the divergence detector still sees them.
    ``gate``: the rows' finiteness if the caller has it
    (:func:`heal_and_mask`)."""
    safe, gate = _seal(flat, gate)
    mixed, carry = step_fn(safe, carry, flags_t, ok)
    return per_card(lambda g, m, x: torch.where(_rows(g, x) > 0, m, x),
                    gate, mixed, flat), carry


def begin_mix_quarantined(begin_fn, flat, carry: Any, flags_t,
                          ok: torch.Tensor, gate=None):
    """The two-phase twin of :func:`gossip_quarantined`: issue the exchange
    on the sealed input and zero the quarantined rows' deltas, so the
    deferred ``apply_mix`` never writes into them."""
    safe, gate = _seal(flat, gate)
    delta, carry = begin_fn(safe, carry, flags_t, ok)
    return per_card(lambda g, d: torch.where(
        _rows(g, d) > 0, d, torch.zeros_like(d)), gate, delta), carry


def worker_groups(tensors, num_workers: int) -> list:
    """The worker-major floating tensors among ``tensors``, grouped by
    dtype and device in order of first appearance: each group is worked
    on as one ``[N, Σ]`` block, a few launches instead of a few per
    tensor (a model has dozens of parameters and buffers)."""
    groups = {}
    for x in tensors:
        if _worker_major(x, num_workers):
            groups.setdefault((x.dtype, x.device), []).append(x)
    return list(groups.values())


def worker_block(xs, num_workers: int) -> torch.Tensor:
    """``[N, Σ]``: a group's rows side by side (a view for one contiguous
    tensor, else a new tensor)."""
    if len(xs) == 1:
        return xs[0].reshape(num_workers, -1)
    return torch.cat([x.reshape(num_workers, -1) for x in xs], dim=1)


def write_block(xs, block: torch.Tensor) -> None:
    """Copy a ``[N, Σ]`` block back into its group's tensors, in place."""
    parts = torch.split(block, [x[0].numel() for x in xs], dim=1)
    torch._foreach_copy_(xs, [p.view(x.shape) for p, x in zip(parts, xs)])


def mask_worker_rows(tree: Any, keep: torch.Tensor, num_workers: int) -> Any:
    """Zero, in place, the rows where ``keep == 0`` of every worker-major
    floating tensor in ``tree`` (a tensor, or a dict/tuple/list of them);
    returns ``tree``.  Resets a healed worker's momentum, CHOCO carry and
    in-flight deltas.  ``masked_fill_`` replaces a NaN row too."""
    drop = keep <= 0
    for xs in worker_groups(tensors_in(tree), num_workers):
        if len(xs) == 1:
            xs[0].masked_fill_(_rows(drop, xs[0]), 0.0)
            continue
        block = worker_block(xs, num_workers)
        block.masked_fill_(drop[:, None], 0.0)
        write_block(xs, block)
    return tree


def heal_worker_stat_rows(tensors, healed: torch.Tensor, donors: torch.Tensor,
                          num_workers: int) -> None:
    """Overwrite, in place, the healed rows of per-worker statistic tensors
    (batch-norm running mean and variance) with the donors' mean: they can
    neither be kept through a heal nor zero-reset (variance 0 is not
    neutral).  With no donors the mean is zero, but then no row is healed
    (the parameters' heal was refused too)."""
    for xs in worker_groups(tensors, num_workers):
        block = worker_block(xs, num_workers)
        mean = masked_mean_rows(block, donors.to(block.dtype))
        healed_block = torch.where(healed[:, None] > 0,
                                   mean.expand_as(block), block)
        write_block(xs, healed_block)


def heal_folded_stat_rows(card_tensors, healed: torch.Tensor,
                          donors: torch.Tensor, rows: int) -> None:
    """:func:`heal_worker_stat_rows` over a worker mesh:
    ``card_tensors[c]`` are card c's ``[L, ...]`` statistic tensors (the
    same structure on every card), ``healed`` and ``donors`` ``f32[N]``.
    Each group's donors' mean comes from per-card partials
    (``parallel.masked_mean_rows`` of the cards' blocks)."""
    groups = [worker_groups(tensors, rows) for tensors in card_tensors]
    for parts in zip(*groups):
        blocks = WorkerBlocks(worker_block(xs, rows) for xs in parts)
        mean = masked_mean_rows(blocks, donors)
        for xs, block in zip(parts, fill_rows(blocks, healed, mean)):
            write_block(xs, block)


def momentum_buffers(optimizer) -> list:
    """The optimizer's momentum buffers that exist (``None`` before the
    first step is skipped)."""
    return [s["momentum_buffer"] for s in optimizer.state.values()
            if s.get("momentum_buffer") is not None]


def state_tensors(state) -> list:
    """Every tensor of a train state: parameters, buffers, momentum
    buffers, the communicator's carry and ``mix_pending``."""
    out = [p.detach() for p in state.model.parameters()]
    out += list(state.model.buffers())
    out += momentum_buffers(state.optimizer)
    out += list(tensors_in(state.comm_carry))
    out += list(tensors_in(state.mix_pending))
    return out


def state_finite_rows(state, num_workers: int) -> torch.Tensor:
    """``bool[N]``: per worker, all finite over the whole train state.

    Every floating tensor counts: parameters, batch-norm buffers, momentum,
    every tensor of ``comm_carry`` (CHOCO's ``x̂`` and ``s``) and
    ``mix_pending`` (the ``[N, D]`` delta or the ``[N, K, D]`` ring).
    Worker-major tensors reduce over their trailing axes; a tensor without
    a worker axis ANDs into every worker."""
    mask = None
    for x in state_tensors(state):
        if not x.is_floating_point():
            continue
        if _worker_major(x, num_workers):
            rows = torch.isfinite(x).reshape(num_workers, -1).all(dim=1)
        else:
            rows = torch.isfinite(x).all().expand(num_workers)
        mask = rows if mask is None else mask & rows
    if mask is None:
        raise ValueError("the train state holds no floating tensor")
    return mask
