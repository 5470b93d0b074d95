"""Elastic membership, device half: the step's input and the boundary surgery.

Port of ``matcha_tpu/elastic/runtime.py`` (:51-156).

* :class:`Membership` is what the step reads each epoch: the pool mask
  ``alive: f32[N]`` on the device and the α scale (executed α ÷ the
  schedule's α) as a host float, which multiplies the flag row (every
  backend's edge weight is ``α·flag_j``).  It also carries the vacant
  slots' indices, made on the host with the mask, so the step can freeze
  them without reading the device.
* :func:`vacant_rows` and :func:`freeze_worker_rows` are the step's freeze:
  the step computes a vacant slot's update like any other (the shapes are
  static), so the slot's rows are captured before the step writes them and
  written back after.  PyTorch updates in place, so the captured rows are
  copies (``index_select``), never references; each dtype's tensors are
  handled as one block.
* :func:`make_bootstrap_fn` builds the boundary surgery for (re)entering
  slots, a plain function that updates the state in place: joined rows
  adopt the donors' parameter mean and batch-norm statistics; restored
  rows keep their own frozen parameters if still finite, else take the
  mean; momentum, the carry and in-flight deltas reset for both.  On a
  worker mesh (a state with ``cards``) the donors' mean comes from
  per-card partials and every card writes its own rows.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List

import numpy as np
import torch

from ..parallel import WorkerBlocks, block_of, masked_mean_rows, split_like
from ..resilience.runtime import (
    fill_rows,
    finite_rows,
    heal_folded_stat_rows,
    heal_worker_stat_rows,
    mask_worker_rows,
    momentum_buffers,
    tensors_in,
    worker_block,
    worker_groups,
    write_block,
)

__all__ = ["Membership", "freeze_worker_rows", "make_bootstrap_fn",
           "membership_arrays", "vacant_rows"]


@dataclasses.dataclass(frozen=True)
class Membership:
    """The step's membership input: ``alive`` ``f32[N]`` (pool occupancy,
    on the device), ``alpha_scale`` (a host float) and ``vacant``, the
    ``int64`` indices of the slots where ``alive`` is 0 (on the device;
    empty when the pool is full).  On a worker mesh ``card_vacant`` holds
    each card's vacant rows as local indices on its device (``alive`` and
    ``vacant`` on card 0); () on one card."""

    alive: torch.Tensor
    alpha_scale: float
    vacant: torch.Tensor
    card_vacant: tuple = ()

    @classmethod
    def fresh(cls, num_workers: int, device=None) -> "Membership":
        return membership_arrays(np.ones(num_workers, np.float32), 1.0,
                                 device)


def membership_arrays(alive: np.ndarray, alpha_scale: float,
                      device=None, mesh=None) -> Membership:
    """Host mask and scale → the value the next epoch's steps read (with
    ``mesh``, a ``parallel.WorkerMesh``, each card's vacant rows too)."""
    mask = np.asarray(alive, np.float32)
    card_vacant = ()
    if mesh is not None:
        rows = len(mask) // mesh.size
        card_vacant = tuple(
            torch.as_tensor(np.flatnonzero(mask[c * rows:(c + 1) * rows]
                                           <= 0), dtype=torch.long,
                            device=dev)
            for c, dev in enumerate(mesh.devices))
    return Membership(
        alive=torch.as_tensor(mask, device=device),
        alpha_scale=float(alpha_scale),
        vacant=torch.as_tensor(np.flatnonzero(mask <= 0), dtype=torch.long,
                               device=device),
        card_vacant=card_vacant)


def vacant_rows(tree: Any, vacant: torch.Tensor,
                num_workers: int) -> List[torch.Tensor]:
    """Copies of the ``vacant`` rows of the worker-major floating tensors
    of ``tree`` (a tensor or a dict/tuple/list of them): one ``[V, Σ]``
    block a group (``resilience.runtime.worker_groups``)."""
    return [worker_block(xs, num_workers).index_select(0, vacant)
            for xs in worker_groups(tensors_in(tree), num_workers)]


def freeze_worker_rows(tree: Any, saved: List[torch.Tensor],
                       vacant: torch.Tensor, num_workers: int) -> Any:
    """Write the rows :func:`vacant_rows` captured back into ``tree``'s
    tensors, in place (``index_copy_``: a frozen NaN row stays as it was,
    no arithmetic touches it); returns ``tree``.  ``tree`` has the
    structure the rows were captured from (the carry a communicator
    returns is a new value of the same structure)."""
    groups = worker_groups(tensors_in(tree), num_workers)
    if len(groups) != len(saved):
        raise ValueError(f"freeze: {len(groups)} groups, {len(saved)} "
                         f"captured")
    for xs, rows in zip(groups, saved):
        block = worker_block(xs, num_workers)
        block.index_copy_(0, vacant, rows)
        if len(xs) > 1:
            write_block(xs, block)
    return tree


def make_bootstrap_fn(flattener, num_workers: int):
    """Build ``bootstrap(state, joined, restored, donors) -> state``: the
    slot masks ``f32[N]`` (numpy or tensors) of ``MembershipView.apply`` /
    ``ElasticController.reconcile_restored`` and the donors (live and not
    themselves entering).  Updates the state in place.

    Joined rows, and restored rows that went non-finite while vacant, take
    the donors' mean when it exists and is finite (the quorum guard of
    ``heal_and_mask``); batch-norm statistics follow the parameters; the
    momentum, carry and in-flight delta rows of every (re)entered slot
    reset."""
    n = int(num_workers)

    def bootstrap(state, joined, restored, donors):
        # a mesh state's cards, each an [L]-row one-card state, or the
        # one-card state itself
        cards = getattr(state, "cards", None)
        views = [state] if cards is None else cards
        dev = next(views[0].model.parameters()).device
        joined, restored, donors = (
            torch.as_tensor(np.asarray(m, np.float32), device=dev)
            for m in (joined, restored, donors))
        flat = (flattener.flatten(state.params) if cards is None
                else WorkerBlocks(flattener.flatten(card.params)
                                  for card in cards))
        finite = finite_rows(flat)
        fallback = torch.clamp(restored * (1.0 - finite), 0.0, 1.0)
        want_mean = torch.clamp(joined + fallback, 0.0, 1.0)
        mean = masked_mean_rows(flat, donors)
        can = (donors.sum() > 0) & torch.isfinite(mean).all()
        healed = want_mean * can.to(torch.float32)
        flat = fill_rows(flat, healed, mean)
        keep = 1.0 - torch.clamp(joined + restored, 0.0, 1.0)
        if cards is None:
            flattener.unflatten_into(flat, state.params)
            heal_worker_stat_rows(list(state.model.buffers()), healed,
                                  donors, n)
            rows, keeps, carries = n, [keep], [state.comm_carry]
        else:
            for card, block in zip(cards, flat):
                flattener.unflatten_into(block, card.params)
            rows = flattener.num_workers
            heal_folded_stat_rows([list(card.model.buffers())
                                   for card in cards], healed, donors, rows)
            keeps = split_like(keep, flat)
            carries = [block_of(state.comm_carry, c)
                       for c in range(len(cards))]
        for view, k, carry in zip(views, keeps, carries):
            mask_worker_rows(momentum_buffers(view.optimizer), k, rows)
            mask_worker_rows(carry, k, rows)
            mask_worker_rows(view.mix_pending, k, rows)
        return state

    return bootstrap
