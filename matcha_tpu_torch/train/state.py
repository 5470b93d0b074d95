"""Train state and the (SGD + gossip) step.

Port of ``matcha_tpu/train/state.py``: ``make_optimizer`` (:100),
``init_train_state`` (:114), ``make_train_step`` (:167, with
``grad_chunk``, the pipelined schedule, local-step elision, a runtime fault
plan, elastic membership and the telemetry accumulator) and
``make_eval_fn`` (:672); the step reads the run controller's knobs
(``serve.ControlKnobs``, JAX :403-418) from ``state.control``.  The step's
phases carry the JAX package's span names (``matcha/fwd_bwd``,
``matcha/sgd``, ``matcha/heal``, ``comm/step``), ranges only inside a
profiler window (``utils.device_span``).

The JAX step vmaps a per-worker loss over the worker axis.  The port's
model holds all workers stacked, so one forward/backward serves them all:
the loss handed to autograd is the **sum** of the per-worker mean losses,
which gives every worker exactly the gradient of its own loss (a mean over
workers would scale each by 1/N).  Then torch-style SGD, then the
communicator's consensus transform on the flattened ``[N, D]`` parameter
stack.  Batch-norm statistics are per-worker buffers and are not gossiped.

PyTorch updates in place: the step mutates the state it is given (model
parameters, optimizer momentum, the step cursor, the pending ring) and
returns it.  The pending deltas are tensors of their own (``begin_mix``'s
subtraction, or the ring's storage), never views of the parameters, so the
next optimizer step cannot write into them.

On a worker mesh (the JAX package's ``shard_workers`` of the state,
``loop.py:445``) the state is a :class:`MeshTrainState`: card c holds a
model stacking workers ``c·L..(c+1)·L``, its optimizer and its rows of
the pending deltas, folded from the same CPU inits as one card's
(:func:`init_mesh_train_state`).  :func:`make_mesh_train_step` runs the
one-card step without a communicator on each card's block in turn, then
what the one-card step does after SGD on the folded stack: the fault
plan's injection and heal and the membership's freeze (JAX
``state.py:393-470``, :575-582), the communicator's mix once across the
cards, eager or pipelined (every card's new block is formed before any
is written back), the telemetry accumulator's step and the run
controller's knobs.  Each row's arithmetic is the one-card step's; what
reads rows across cards (the donors' mean of the heal, the fleet means,
the disagreement) is formed from per-card partials.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn

from ..communicator import Communicator
from ..elastic.runtime import Membership, freeze_worker_rows, vacant_rows
from ..models.layers import init_workers
from ..obs.telemetry import (
    Telemetry,
    TelemetrySpec,
    age_bin_table,
    telemetry_step,
)
from ..ops import WorkerFlattener
from ..parallel import (
    WorkerBlocks,
    WorkerMesh,
    block_of,
    fold_dims,
    masked_mean_rows,
    split_like,
    worker_deviation,
    worker_disagreement,
)
from ..resilience.runtime import (
    begin_mix_quarantined,
    gossip_quarantined,
    heal_and_mask,
    heal_folded_stat_rows,
    heal_worker_stat_rows,
    inject_nan_rows,
    mask_worker_rows,
    momentum_buffers,
)
from ..serve.runtime import ControlKnobs
from ..utils import cross_entropy_loss, device_span, top_k_accuracy

__all__ = ["MeshTrainState", "OptimizerSpec", "TrainState",
           "fresh_mix_pending", "init_mesh_train_state", "init_train_state",
           "make_eval_fn", "make_mesh_eval_fn", "make_mesh_train_step",
           "make_optimizer", "make_train_step", "mesh_card_state",
           "mesh_flat"]


@dataclasses.dataclass
class TrainState:
    model: nn.Module  # worker-stacked parameters and BN buffers, [N, ...]
    optimizer: torch.optim.Optimizer  # holds the momentum (opt_state)
    comm_carry: Any
    step: int  # host-side schedule cursor
    # in-flight mixing delta(s) of the pipelined schedule: f32[N, D] at
    # overlap="1step" with staleness 1 (issued at step t−1, consumed at t),
    # the worker-major ring f32[N, K, D] at staleness K ≥ 2 (slot t mod K
    # holds the delta issued at t−K), () when eager.  Checkpointed.
    mix_pending: Any = ()
    # i32[N, K] age of each ring slot's delta (−1: empty, before the ring
    # filled, after an elided issue, or a healed or vacant row), () below
    # K = 2.  Never checkpointed: a resume rebuilds it from the cursor.
    mix_ages: Any = ()
    # the elastic pool's mask and α scale (``elastic.runtime.Membership``),
    # set by the loop at each epoch boundary; () without a membership
    # trace.  Never checkpointed: a sidecar records the view.
    membership: Any = ()
    # the epoch's ``obs.Telemetry`` accumulator, made fresh by the loop at
    # each epoch (and for a rollback's retry); () with telemetry off.
    # Never checkpointed, never snapshotted, never checked for finiteness.
    telemetry: Any = ()
    # the run controller's knobs (``serve.ControlKnobs``: the flag row's
    # per-matching scale, the α scale and the gossip cadence), set by the
    # loop at each epoch boundary of a supervised run; () otherwise.
    # Never checkpointed: the journal's control events rebuild them.
    control: Any = ()

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    @property
    def batch_stats(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_buffers())


@dataclasses.dataclass
class MeshTrainState:
    """The train state folded card-major across a worker mesh.

    ``cards[c]`` is the one-card :class:`TrainState` of workers
    ``c·L..(c+1)·L``: a model stacking those L workers on
    ``mesh.devices[c]``, its optimizer and its rows of the pending deltas
    (``[L, D]``, or the ring ``[L, K, D]`` and its ``i32[L, K]`` ages);
    ``mix_pending`` and ``mix_ages`` read and write them as
    ``WorkerBlocks`` (() when eager).  The communicator's carry is the
    mesh's, folded like the state where it has worker rows (CHOCO's
    ``{x̂, s}`` as ``WorkerBlocks``; the cards' own ``comm_carry`` is not
    read); the schedule cursor ``step`` is every card's, which advance
    together.  ``membership``: the elastic pool's
    ``elastic.runtime.Membership`` (its masks on card 0, each card's
    vacant rows on that card), () without a membership trace.
    ``telemetry``: the epoch's ``obs.Telemetry`` accumulator, one per
    mesh on card 0 (JAX shards it like the state; its per-worker rows
    arrive gathered in worker order), () with telemetry off.
    ``control``: the run controller's ``serve.ControlKnobs``, once for the
    mesh (replicated in JAX: ``row_scale`` is ``[M]`` matchings, not
    workers), () unsupervised.  None of the three is checkpointed."""

    cards: List[TrainState]
    mesh: WorkerMesh
    comm_carry: Any = ()
    membership: Any = ()
    telemetry: Any = ()
    control: Any = ()

    @property
    def step(self) -> int:
        return self.cards[0].step

    @step.setter
    def step(self, value: int) -> None:
        for card in self.cards:
            card.step = value

    @property
    def mix_pending(self):
        return _card_blocks(self.cards, "mix_pending")

    @mix_pending.setter
    def mix_pending(self, value) -> None:
        _set_card_blocks(self.cards, "mix_pending", value)

    @property
    def mix_ages(self):
        return _card_blocks(self.cards, "mix_ages")

    @mix_ages.setter
    def mix_ages(self, value) -> None:
        _set_card_blocks(self.cards, "mix_ages", value)


def _card_blocks(cards, name: str):
    """The cards' ``name`` tensors as a ``WorkerBlocks``; () when they
    hold none."""
    if not isinstance(getattr(cards[0], name), torch.Tensor):
        return ()
    return WorkerBlocks(getattr(card, name) for card in cards)


def _set_card_blocks(cards, name: str, value) -> None:
    """Card c's ``name`` becomes block c of ``value`` (a ``WorkerBlocks``),
    or ``value`` itself (())."""
    for c, card in enumerate(cards):
        setattr(card, name, value[c] if isinstance(value, WorkerBlocks)
                else value)


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """torch-style SGD hyperparameters and the learning-rate schedule; the
    port's counterpart of the optax transformation (``init`` builds the
    stateful torch optimizer over a model's parameters)."""

    lr_schedule: Callable[[int], np.float32]
    momentum: float = 0.9
    weight_decay: float = 5e-4
    nesterov: bool = True

    def init(self, params) -> torch.optim.SGD:
        # without momentum, Nesterov's look-ahead is the plain step (optax's
        # trace of decay 0); torch refuses the pair, so it is dropped
        return torch.optim.SGD(list(params), lr=float(self.lr_schedule(0)),
                               momentum=self.momentum,
                               weight_decay=self.weight_decay,
                               nesterov=self.nesterov and self.momentum != 0)


def make_optimizer(lr_schedule: Callable, momentum: float = 0.9,
                   weight_decay: float = 5e-4,
                   nesterov: bool = True) -> OptimizerSpec:
    """``torch.optim.SGD(momentum, weight_decay, nesterov)``: weight decay
    joins the gradient before the momentum buffer, as the JAX package's
    ``add_decayed_weights`` + nesterov ``sgd`` chain does."""
    return OptimizerSpec(lr_schedule, momentum, weight_decay, nesterov)


def fresh_mix_pending(overlap: str, staleness: int, num_workers: int,
                      dim: int, device=None):
    """``(mix_pending, mix_ages)`` of a primed pipeline: the zero delta
    (``overlap="1step"``), the zero ``[N, K, D]`` ring and all-empty (−1)
    ages (``staleness`` K ≥ 2), or ``((), ())`` when eager."""
    if overlap != "1step":
        return (), ()
    if staleness > 1:
        return (torch.zeros(num_workers, staleness, dim, device=device),
                torch.full((num_workers, staleness), -1, dtype=torch.int32,
                           device=device))
    return torch.zeros(num_workers, dim, device=device), ()


def init_train_state(model: nn.Module, num_workers: int,
                     optimizer: OptimizerSpec, communicator: Communicator,
                     seed: int = 0, sync_init: bool = True,
                     device=None, overlap: str = "off",
                     staleness: int = 1) -> tuple[TrainState, WorkerFlattener]:
    """Per-worker independent inits (worker ``w`` seeded ``seed + w``),
    made on the CPU so they are the same on every device, then the
    reference's initial AllReduce sync when ``sync_init``.
    ``overlap="1step"`` primes the zero delta the pipelined step consumes
    at step 0, ``staleness`` K ≥ 2 the ``[N, K, D]`` ring and its empty
    ages (:func:`fresh_mix_pending`)."""
    if staleness < 1:
        raise ValueError(f"staleness must be >= 1, got {staleness}")
    if getattr(model, "num_workers", None) != num_workers:
        raise ValueError(f"model stacks {getattr(model, 'num_workers', None)} "
                         f"workers, expected {num_workers}")
    _init_replicas(model, seed, sync_init)
    model.to(device)
    params = dict(model.named_parameters())
    flattener = WorkerFlattener(params)
    pending, ages = fresh_mix_pending(overlap, staleness, num_workers,
                                      flattener.dim,
                                      next(model.parameters()).device)
    state = TrainState(
        model=model,
        optimizer=optimizer.init(model.parameters()),
        comm_carry=communicator.init(flattener.flatten(params)),
        step=0,
        mix_pending=pending,
        mix_ages=ages,
    )
    return state, flattener


def _init_replicas(model: nn.Module, seed: int, sync_init: bool) -> None:
    """Worker ``w`` seeded ``seed + w``, then, with ``sync_init``, every
    parameter set to the workers' mean (the reference's AllReduce)."""
    init_workers(model, seed)
    if sync_init:
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(p.mean(dim=0, keepdim=True).expand_as(p))


def init_mesh_train_state(model: nn.Module, num_workers: int,
                          optimizer: OptimizerSpec,
                          communicator: Communicator, mesh: WorkerMesh,
                          make_model: Callable[[int], nn.Module],
                          seed: int = 0, sync_init: bool = True,
                          overlap: str = "off", staleness: int = 1
                          ) -> tuple[MeshTrainState, WorkerFlattener]:
    """The N workers' inits made on the CPU in ``model`` exactly as
    :func:`init_train_state` makes them (``sync_init`` included), then
    folded card-major: card c gets ``make_model(L)``, loaded with rows
    ``c·L..(c+1)·L`` of every parameter and buffer and moved to
    ``mesh.devices[c]``, a fresh optimizer over it and its rows of a
    primed pipeline (:func:`fresh_mix_pending` of ``overlap`` and
    ``staleness``).  Returns the state and the flattener of one card's
    ``[L, D]`` block (every card's is the same)."""
    if staleness < 1:
        raise ValueError(f"staleness must be >= 1, got {staleness}")
    if getattr(model, "num_workers", None) != num_workers:
        raise ValueError(f"model stacks {getattr(model, 'num_workers', None)} "
                         f"workers, expected {num_workers}")
    _, rows = fold_dims(num_workers, mesh)
    _init_replicas(model, seed, sync_init)
    whole = model.state_dict()
    cards = []
    for c, dev in enumerate(mesh.devices):
        card = make_model(rows)
        card.load_state_dict({k: v[c * rows:(c + 1) * rows]
                              for k, v in whole.items()})
        card.to(dev)
        cards.append(TrainState(model=card,
                                optimizer=optimizer.init(card.parameters()),
                                comm_carry=(), step=0))
    flattener = WorkerFlattener(cards[0].params)
    for card, dev in zip(cards, mesh.devices):
        card.mix_pending, card.mix_ages = fresh_mix_pending(
            overlap, staleness, rows, flattener.dim, dev)
    state = MeshTrainState(cards, mesh)
    state.comm_carry = communicator.init(mesh_flat(state, flattener))
    return state, flattener


def mesh_flat(state: MeshTrainState,
              flattener: WorkerFlattener) -> WorkerBlocks:
    """The folded ``[N, D]`` parameter stack: each card's ``[L, D]``."""
    return WorkerBlocks(flattener.flatten(card.params)
                        for card in state.cards)


def mesh_card_state(state: MeshTrainState, c: int) -> TrainState:
    """Card c's :class:`TrainState` with its rows of the mesh's carry (a
    ``WorkerBlocks`` entry's block c, the tensor itself; an entry without
    worker rows, such as CHOCO's generator state, as it is): what a
    per-worker check or write of the whole state reads on that card."""
    return dataclasses.replace(state.cards[c],
                               comm_carry=block_of(state.comm_carry, c))


@contextlib.contextmanager
def _worker_slab(model: nn.Module, lo: int, hi: int):
    """Within the block, every parameter and buffer of ``model`` reads as
    its worker rows ``lo:hi`` — views of the full tensors, so gradients and
    running-statistic updates land in them.  The layers read their worker
    count from their weights, so the model then runs those workers alone."""
    swapped = []
    for module in model.modules():
        for store in (module._parameters, module._buffers):
            for name, tensor in store.items():
                if tensor is not None:
                    swapped.append((store, name, tensor))
                    store[name] = tensor[lo:hi]
    try:
        yield
    finally:
        for store, name, tensor in swapped:
            store[name] = tensor


def _mix_options(flags_host: np.ndarray, overlap: str, staleness: int,
                 stale_alpha_scale: float, local_steps: int):
    """The pipelined schedule's options, checked: ``(overlap_on,
    staleness, ring_on, local_steps, comm_flags_host)``, the last the
    flag rows times the damped α's scale (f32)."""
    if overlap not in ("off", "1step"):
        raise ValueError(f"overlap must be 'off' or '1step', got {overlap!r}")
    overlap_on = overlap == "1step"
    staleness = int(staleness)
    if staleness < 1:
        raise ValueError(f"staleness must be >= 1, got {staleness}")
    if staleness > 1 and not overlap_on:
        raise ValueError("staleness > 1 needs overlap='1step': the eager "
                         "path has no pending ring to age deltas through")
    if not stale_alpha_scale > 0:
        raise ValueError(f"stale_alpha_scale must be > 0, got "
                         f"{stale_alpha_scale}")
    local_steps = int(local_steps)
    if local_steps < 1:
        raise ValueError(f"local_steps must be >= 1, got {local_steps}")
    # the damped α rides the communicator's flag rows (every backend's edge
    # weight is α·flag_j), scaled once here in f32 as the JAX step does
    comm_flags_host = (flags_host * np.float32(stale_alpha_scale)
                       if stale_alpha_scale != 1.0 else flags_host)
    return (overlap_on, staleness, overlap_on and staleness > 1,
            local_steps, comm_flags_host)


def _check_faults(faults, flags_host: np.ndarray, n: int) -> None:
    if faults is not None and faults.alive.shape != (flags_host.shape[0], n):
        raise ValueError(
            f"fault arrays {faults.alive.shape} do not match "
            f"(iterations={flags_host.shape[0]}, workers={n}); compile the "
            f"FaultPlan against this schedule")


def _fault_rows(faults):
    """``rows(dev, t) -> (alive, revive, nan_inject)``, step t's ``f32[N]``
    rows of the compiled plan, its arrays placed on ``dev`` once."""
    placed = {}  # device -> (alive, revive, nan_inject), f32[T, N]

    def rows(dev, t: int):
        if dev not in placed:
            placed[dev] = tuple(
                torch.as_tensor(np.asarray(a, np.float32), device=dev)
                for a in (faults.alive, faults.revive, faults.nan_inject))
        return tuple(a[t] for a in placed[dev])

    return rows


def _stat_buffers(model: nn.Module) -> list:
    return [b for b in model.buffers() if b.is_floating_point()]


def _momenta(state: TrainState) -> list:
    """``(parameter, momentum buffer or None)`` in the model's order; none
    at all without momentum (SGD keeps no buffer then)."""
    if not state.optimizer.defaults.get("momentum"):
        return []
    return [(p, state.optimizer.state.get(p, {}).get("momentum_buffer"))
            for p in state.model.parameters()]


def _capture_vacant(state: TrainState, flattener: WorkerFlattener,
                    vacant: torch.Tensor):
    """Copies of the vacant slots' rows, before the step writes them:
    parameters (as one ``[V, D]`` block), batch-norm buffers, momentum
    (zeros where no buffer exists yet, as the JAX trace starts) and
    carry."""
    n = flattener.num_workers
    moms = [buf if buf is not None else torch.zeros_like(p)
            for p, buf in _momenta(state)]
    return {"flat": flattener.flatten(state.params).index_select(0, vacant),
            "buffers": vacant_rows(_stat_buffers(state.model), vacant, n),
            "momentum": vacant_rows(moms, vacant, n),
            "carry": vacant_rows(state.comm_carry, vacant, n)}


def _freeze_vacant(state: TrainState, saved, vacant: torch.Tensor,
                   n: int) -> None:
    """Write the captured rows back (the parameters went through the flat
    stack already)."""
    freeze_worker_rows(_stat_buffers(state.model), saved["buffers"], vacant,
                       n)
    freeze_worker_rows([buf for _, buf in _momenta(state)],
                       saved["momentum"], vacant, n)
    freeze_worker_rows(state.comm_carry, saved["carry"], vacant, n)


def _ring_drops(ages: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """The ring's real deltas (slots with an age) a row mask is about to
    drop, as a 0-d f32 count on the device."""
    return ((ages >= 0) & (keep[:, None] <= 0)).sum(dtype=torch.float32)


def _reset_rows(state: TrainState, carry, keep: torch.Tensor, n: int,
                overlap_on: bool, ring_on: bool, counting: bool):
    """A heal's resets of the rows where ``keep`` is 0: momentum, the
    carry ``carry`` and the in-flight deltas (ring slots marked −1).
    Returns the ring's deltas dropped when ``counting``, else ``None``."""
    mask_worker_rows(momentum_buffers(state.optimizer), keep, n)
    mask_worker_rows(carry, keep, n)
    dropped = None
    if overlap_on:
        # a healed worker restarts from the donors' mean: the deltas issued
        # from its old parameters are stale like its momentum
        if ring_on:
            if counting:
                dropped = _ring_drops(state.mix_ages, keep)
            state.mix_ages.masked_fill_(keep[:, None] <= 0, -1)
        mask_worker_rows(state.mix_pending, keep, n)
    return dropped


def _vacate_pending(state: TrainState, alive: torch.Tensor, n: int,
                    ring_on: bool, counting: bool):
    """A vacant slot neither issues nor consumes deltas: its pending rows
    zeroed (ring slots marked −1).  Returns the ring's deltas dropped when
    ``counting``, else ``None``."""
    vacated = None
    if ring_on:
        if counting:
            vacated = _ring_drops(state.mix_ages, alive)
        state.mix_ages.masked_fill_(alive[:, None] <= 0, -1)
    mask_worker_rows(state.mix_pending, alive, n)
    return vacated


def _exchange(communicator: Communicator, flat, carry, row, alive, gate):
    """``step``, quarantined under a survivor mask."""
    if alive is None:
        return communicator.step(flat, carry, row)
    return gossip_quarantined(communicator.step, flat, carry, row, alive,
                              gate=gate)


def _issue(communicator: Communicator, flat, carry, row, alive, gate):
    """``begin_mix``, quarantined under a survivor mask."""
    if alive is None:
        return communicator.begin_mix(flat, carry, row)
    return begin_mix_quarantined(communicator.begin_mix, flat, carry, row,
                                 alive, gate=gate)


def _fleet_mean(v: torch.Tensor, alive) -> torch.Tensor:
    """Mean over workers, the quarantined rows left out (``where``: a dead
    worker's loss may be NaN).  With no alive worker, the mean of the
    finite rows, and NaN when none is finite."""
    if alive is None:
        return v.mean()
    per_worker = v.reshape(v.shape[0], -1).mean(dim=1)
    zero = torch.zeros_like(per_worker)
    kept = torch.where(alive > 0, per_worker, zero)
    fin = torch.isfinite(per_worker).to(per_worker.dtype)
    local = torch.where(
        fin.sum() > 0,
        torch.where(fin > 0, per_worker, zero).sum()
        / torch.clamp(fin.sum(), min=1.0),
        torch.full_like(fin.sum(), float("nan")))
    return torch.where(alive.sum() > 0,
                       kept.sum() / torch.clamp(alive.sum(), min=1.0),
                       local)


def make_train_step(
    optimizer: OptimizerSpec,
    communicator: Communicator,
    flattener: WorkerFlattener,
    flags: np.ndarray,
    lr_schedule: Optional[Callable] = None,
    grad_chunk: Optional[int] = None,
    overlap: str = "off",
    staleness: int = 1,
    stale_alpha_scale: float = 1.0,
    local_steps: int = 1,
    faults=None,
    elastic: bool = False,
    telemetry: Optional[TelemetrySpec] = None,
    control: bool = False,
):
    """Build ``step(state, xb, yb) -> (state, metrics)``.

    ``communicator=None``: the step of one card of a worker mesh, which
    runs the forward/backward and SGD and leaves the mix and the
    disagreement to its caller (:func:`make_mesh_train_step`); none of
    the options below that act on the mix may be set then.

    ``xb: [N, B, ...]`` and ``yb: int[N, B]`` on the model's device.  The
    activation-flag stream is moved to the device once (kept on the host
    for a communicator with ``host_flags``) and indexed by the host cursor
    ``state.step``.  ``metrics``: ``loss``, ``accuracy`` and
    ``disagreement`` as 0-d device tensors (no host read here), ``lr`` and
    ``active_matchings`` as host floats.

    ``grad_chunk``: workers whose forward/backward runs at once.  ``None``
    runs all N together; ``c < N`` runs N/c slabs of c workers in turn, one
    backward each, so only c·B images' activations are live at a time.
    Workers are independent until the gossip, so the result is the same up
    to the order of cuDNN's sums (its algorithms may differ by group
    count).

    ``overlap="1step"``: the pipelined schedule.  Each step first consumes
    the delta issued at step t−1 (``state.mix_pending``, an add), then
    issues its own exchange through ``communicator.begin_mix`` and parks
    the delta for step t+1: the post-SGD parameters of step t are mixed by
    ``W_t`` as eagerly, only step t+1's gradient update joins the
    consensus a round late.  ``staleness`` K ≥ 2 (needs ``"1step"``):
    step t consumes ring slot ``t mod K`` (the delta issued at t−K), ages
    the slots, then issues into the same slot.  ``stale_alpha_scale``
    multiplies the communicator's flag rows (the executed α;
    ``active_matchings`` counts the unscaled rows).  ``local_steps`` L:
    the exchange runs only where ``state.step % L == 0``, a host branch;
    any other step launches nothing, and under the pipeline it parks a
    zero delta (its ring slot marked empty, −1) while the consume stays
    unconditional.

    ``faults``: a compiled fault plan (``resilience.RuntimeFaults``,
    arrays ``[T, N]`` indexed by the cursor, placed on the device once).
    Each step then (a) poisons the plan's NaN rows, (b) heals the planned
    revivals and the alive rows that are not finite from the donors' mean
    (``heal_and_mask``), resets their momentum, carry and in-flight delta
    rows (ring slots marked −1) and gives them the donors' batch-norm
    statistics, and (c) gossips under the survivor mask with the
    non-finite rows sealed to zero (``gossip_quarantined``, or
    ``begin_mix_quarantined`` in the pipeline).  Link faults are not
    handled here: the caller multiplies ``flags`` by the plan's
    ``link_up``.  ``elastic``: the step reads ``state.membership`` (an
    ``elastic.runtime.Membership``): the pool mask composes into the
    survivor mask (and into the plan's revivals), ``alpha_scale``
    multiplies the flag row, and the vacant slots' parameters, batch-norm
    statistics, momentum and carry are frozen (captured before the step
    writes them, written back after), their in-flight deltas zeroed.
    Under either, ``loss`` and ``accuracy`` average the surviving rows,
    ``disagreement`` is theirs, and ``healed`` and ``alive_workers`` join
    the metrics.  With neither, the step is the step without them: no
    extra launch.

    ``telemetry``: an ``obs.TelemetrySpec``.  When given and
    ``state.telemetry`` is an ``obs.Telemetry``, each step adds to it in
    place (``obs.telemetry_step``, JAX ``state.py:621-650``): the step's
    disagreement, its flag row times the mix gate (an elided step moves
    no bytes), the alive count, heals and dropped deltas, the ring's
    consumed ages and the per-worker alive mask and deviation rows.  The
    disagreement metric is then derived from the deviation rows (the two
    differ only by the alive-weighted mean), so the accounting costs a few
    launches a step and no read.

    ``control``: when True and ``state.control`` is a
    ``serve.ControlKnobs``, the flag row (after the membership's α scale)
    is multiplied by ``row_scale`` and then by ``alpha_scale``, in f32 and
    in that order, as the JAX step does (:403-418), so the kernel gets the
    same weights bit for bit; and ``local_every`` replaces
    ``local_steps`` as the cadence of the host branch.  The knobs change
    only at an epoch boundary.  The telemetry counts the unscaled row
    gated by the cadence, as in JAX.
    """
    flags_host = np.asarray(flags, np.float32)  # [T, M]
    n = flattener.num_workers
    if communicator is None and (
            overlap != "off" or local_steps != 1 or faults is not None
            or elastic or telemetry is not None or control):
        raise ValueError("a step without a communicator takes no option "
                         "that acts on the mix")
    overlap_on, staleness, ring_on, local_steps, comm_flags_host = \
        _mix_options(flags_host, overlap, staleness, stale_alpha_scale,
                     local_steps)
    comm_flags = {}  # device -> tensor, placed at first use
    if grad_chunk is not None and not 1 <= grad_chunk <= n:
        raise ValueError(f"grad_chunk {grad_chunk} must be in [1, {n}]")
    if grad_chunk is not None and n % grad_chunk:
        raise ValueError(f"grad_chunk {grad_chunk} must divide num_workers "
                         f"{n}")
    slabs = [(0, n)] if grad_chunk is None else [
        (lo, lo + grad_chunk) for lo in range(0, n, grad_chunk)]
    _check_faults(faults, flags_host, n)
    fault_rows = _fault_rows(faults)
    age_tables = {}  # device -> the consumed-age histogram's bin table

    def forward_backward(model: nn.Module, xb, yb):
        """Per-worker losses ``[N]`` and logits, detached; the gradients
        accumulate in the parameters' ``.grad``."""
        if len(slabs) == 1:
            logits = model(xb)
            losses = cross_entropy_loss(logits, yb)  # [N]
            # the sum of the per-worker means: each worker gets exactly the
            # gradient of its own loss
            losses.sum().backward()
            return losses.detach(), logits.detach()
        losses, logits = [], []
        for lo, hi in slabs:
            with _worker_slab(model, lo, hi):
                out = model(xb[lo:hi])
                loss = cross_entropy_loss(out, yb[lo:hi])
                loss.sum().backward()
            losses.append(loss.detach())
            logits.append(out.detach())
        return torch.cat(losses), torch.cat(logits)

    def mix(state: TrainState, flat: torch.Tensor, row, do_mix: bool,
            alive=None, gate=None, counting: bool = False):
        """The consensus transform of this step on ``flat`` (``do_mix``:
        the step exchanges; else it is elided): returns
        ``(flat, consumed)``, the parameters the step leaves visible (the
        pending deltas in ``state``) and, on the ring when ``counting``,
        the age of the delta each row consumed (else ``None``).
        ``alive``/``gate``: the survivor mask and the rows' finiteness
        of a faulted or elastic step."""
        if ring_on:
            slot = state.step % staleness
            ages = state.mix_ages
            ages.add_((ages >= 0).to(ages.dtype))
            consumed = ages[:, slot].clone() if counting else None
            ring = state.mix_pending
            flat = communicator.apply_mix(flat, ring[:, slot])
            if do_mix:
                delta, state.comm_carry = _issue(
                    communicator, flat, state.comm_carry, row, alive, gate)
                ring[:, slot] = delta
                if alive is None:
                    ages[:, slot] = 0
                else:
                    # dead or non-finite rows issued nothing real
                    ages[:, slot] = torch.where(
                        (alive > 0) & (gate > 0), 0, -1).to(ages.dtype)
            else:
                ring[:, slot] = 0.0
                ages[:, slot] = -1
            return flat, consumed
        if overlap_on:
            flat = communicator.apply_mix(flat, state.mix_pending)
            if do_mix:
                state.mix_pending, state.comm_carry = _issue(
                    communicator, flat, state.comm_carry, row, alive, gate)
            else:
                state.mix_pending = torch.zeros_like(flat)
            return flat, None
        if do_mix:
            flat, state.comm_carry = _exchange(
                communicator, flat, state.comm_carry, row, alive, gate)
        return flat, None

    def heal(state: TrainState, flat: torch.Tensor, dev, t: int, member,
             counting: bool):
        """Inject, heal and mask (the fault/membership branch before the
        gossip, JAX ``state.py:393-470``): returns ``(flat, alive,
        healed, gate, dropped)``; ``dropped`` counts the ring's deltas the
        heal dropped when ``counting`` (telemetry on), else ``None``."""
        if faults is not None:
            alive_t, revive_t, inject_t = fault_rows(dev, t)
            flat = inject_nan_rows(flat, inject_t)
            if member is not None:
                # a vacant slot is dead whatever the plan says, and a
                # planned revival of a vacant slot stays vacant
                alive_t = alive_t * member.alive
                revive_t = revive_t * member.alive
        else:
            alive_t = member.alive
            revive_t = torch.zeros_like(alive_t)
        flat, alive, healed, gate = heal_and_mask(flat, alive_t, revive_t)
        keep = 1.0 - healed
        dropped = _reset_rows(state, state.comm_carry, keep, n, overlap_on,
                              ring_on, counting)
        heal_worker_stat_rows(_stat_buffers(state.model), healed,
                              alive * keep, n)
        return flat, alive, healed, gate, dropped

    def step(state: TrainState, xb: torch.Tensor, yb: torch.Tensor):
        model, opt = state.model, state.optimizer
        tel = (state.telemetry if telemetry is not None
               and isinstance(state.telemetry, Telemetry) else None)
        counting = tel is not None
        member = (state.membership if elastic
                  and isinstance(state.membership, Membership) else None)
        # the vacant slots are a host-made index tensor: its size is
        # metadata, not a device read
        vacant = (member.vacant if member is not None
                  and member.vacant.numel() else None)
        saved = (_capture_vacant(state, flattener, vacant)
                 if vacant is not None else None)
        model.train()
        opt.zero_grad(set_to_none=True)
        # the phases' ranges: inside a profiler window each kernel is the
        # phase's that launched it (obs.xprof); outside, nothing
        with device_span("matcha/fwd_bwd"):
            losses, logits = forward_backward(model, xb, yb)
        lr = float(optimizer.lr_schedule(state.step))
        for group in opt.param_groups:
            group["lr"] = lr
        with device_span("matcha/sgd"):
            opt.step()

        t = min(state.step, flags_host.shape[0] - 1)
        if communicator is None:
            # one card of a mesh: the caller mixes across the cards and
            # forms its fleet means from the per-worker values
            correct = top_k_accuracy(logits, yb)
            metrics = {
                "loss": losses.mean(),
                "accuracy": correct.mean(),
                "lr": float(lr_schedule(state.step)) if lr_schedule else 0.0,
                "active_matchings": float(flags_host[t].sum()),
                "worker_loss": losses,
                "worker_accuracy": correct,
            }
            state.step += 1
            return state, metrics
        dev = communicator.flags_device(xb.device)
        if dev not in comm_flags:
            comm_flags[dev] = torch.as_tensor(comm_flags_host, device=dev)
        row = comm_flags[dev][t]
        if member is not None and member.alpha_scale != 1.0:
            # the re-folded α rides the flag row, scaled in f32 as the
            # JAX step scales it
            row = row * float(np.float32(member.alpha_scale))
        every = local_steps
        knobs = state.control if control and isinstance(
            state.control, ControlKnobs) else None
        if knobs is not None:
            row = row * knobs.row_scale
            if knobs.alpha_scale != 1.0:
                row = row * knobs.alpha_scale
            every = knobs.local_every
        params = state.params
        do_mix = state.step % every == 0
        with torch.no_grad():
            flat = flattener.flatten(params)
            alive = healed = gate = dropped = None
            if faults is not None or member is not None:
                with device_span("matcha/heal"):
                    flat, alive, healed, gate, dropped = heal(
                        state, flat, xb.device, t, member, counting)
            with device_span("comm/step"):
                flat, consumed = mix(state, flat, row, do_mix, alive, gate,
                                     counting)
            if saved is not None:
                # the vacant slots keep the rows they had before the step
                # (the survivor mask already made their gossip a self-loop)
                flat.index_copy_(0, vacant, saved["flat"])
                _freeze_vacant(state, saved, vacant, n)
            if member is not None and overlap_on:
                # a vacant slot neither issues nor consumes deltas
                vacated = _vacate_pending(state, member.alive, n, ring_on,
                                          counting)
                if vacated is not None:
                    dropped = (vacated if dropped is None
                               else dropped + vacated)
            flattener.unflatten_into(flat, params)
            rows = None
            if counting:
                rows, disagreement = worker_deviation(flat, alive)
            else:
                disagreement = worker_disagreement(flat, alive)
            metrics = {
                "loss": _fleet_mean(losses, alive),
                "accuracy": _fleet_mean(top_k_accuracy(logits, yb), alive),
                "disagreement": disagreement,
                "lr": float(lr_schedule(state.step)) if lr_schedule else 0.0,
                "active_matchings": float(flags_host[t].sum()),
            }
            if alive is not None:
                metrics["healed"] = healed.sum()
                metrics["alive_workers"] = alive.sum()
            if counting:
                age_bins = None
                if consumed is not None:
                    if consumed.device not in age_tables:
                        age_tables[consumed.device] = age_bin_table(
                            staleness, consumed.device)
                    age_bins = age_tables[consumed.device]
                # the ring counts the deltas its masks dropped; the one-step
                # pipeline drops a healed row's pending delta
                stale_dropped = dropped if ring_on else (
                    metrics.get("healed") if overlap_on else None)
                telemetry_step(
                    tel, telemetry, disagreement=disagreement,
                    # an elided step exchanges nothing: zero bytes
                    flags_t=flags_host[t] * np.float32(do_mix),
                    alive_count=metrics.get("alive_workers", n),
                    healed=metrics.get("healed"),
                    stale_dropped=stale_dropped, consumed_age=consumed,
                    worker_alive=alive, worker_disagreement=rows,
                    age_bins=age_bins)
        state.step += 1
        return state, metrics

    return step


def make_mesh_train_step(optimizer: OptimizerSpec,
                         communicator: Communicator,
                         flattener: WorkerFlattener, flags: np.ndarray,
                         lr_schedule: Optional[Callable] = None,
                         grad_chunk: Optional[int] = None,
                         overlap: str = "off",
                         staleness: int = 1,
                         stale_alpha_scale: float = 1.0,
                         local_steps: int = 1,
                         faults=None,
                         elastic: bool = False,
                         telemetry: Optional[TelemetrySpec] = None,
                         control: bool = False):
    """Build the folded ``step(state, xb, yb) -> (state, metrics)`` over a
    :class:`MeshTrainState`.

    ``xb: [N, B, ...]``, ``yb: int[N, B]`` on card 0's device; card c
    takes rows ``c·L..(c+1)·L`` (a view on its own device, else a copy).
    Each card runs the one-card step without a communicator
    (:func:`make_train_step`: forward/backward in ``grad_chunk`` slabs
    within its L workers, then SGD), all launched from this thread in card
    order.  Then the folded ``[N, D]`` stack (``mesh_flat``) goes through
    what the one-card step does after SGD, with every option of
    :func:`make_train_step` and its meaning:

    * ``faults``/``elastic``: each card poisons its rows of the plan's
      NaN events; the heal (``heal_and_mask`` on the ``WorkerBlocks``:
      the masks ``f32[N]`` on card 0, the donors' mean from per-card
      partials) overwrites the healed rows on their cards, and each card
      resets its healed rows' momentum, carry and pending deltas and
      takes the donors' batch-norm mean; the gossip is quarantined (the
      non-finite rows sealed card by card, the survivor mask handed to
      the communicator); each card captures its vacant slots' rows
      before its step and writes them back after the mix.
    * ``overlap``/``staleness``: each card consumes its rows of the delta
      (or of ring slot ``t mod K``) and parks its rows of the delta that
      ``communicator.begin_mix`` issues on the folded stack; the ages age
      and reset card by card.
    * ``local_steps``, ``telemetry``, ``control``: the exchange runs only
      where the cursor is a multiple of the cadence (a host branch); the
      accumulator on card 0 takes the step's counts, with the per-worker
      deviation rows, alive mask and consumed ages gathered onto card 0
      in worker order, and nothing is read back; the knobs scale the flag
      row in the JAX step's order.

    Every card's new block is formed before any is written back into the
    cards' parameters.  ``metrics`` on card 0: ``loss`` and ``accuracy``
    the mean of the cards' means (under faults or membership, the one-card
    fleet mean of the gathered per-worker values), ``disagreement`` from
    per-card partials (:func:`_folded_deviation`), ``healed`` and
    ``alive_workers`` under faults or membership.  The communicator's flag
    rows are kept where it wants them (the host, for the folded decen
    backend)."""
    card_step = make_train_step(optimizer, None, flattener, flags,
                                lr_schedule=lr_schedule,
                                grad_chunk=grad_chunk)
    flags_host = np.asarray(flags, np.float32)  # [T, M]
    overlap_on, staleness, ring_on, local_steps, comm_flags_host = \
        _mix_options(flags_host, overlap, staleness, stale_alpha_scale,
                     local_steps)
    rows = flattener.num_workers
    fault_rows = _fault_rows(faults)
    comm_flags = {}
    age_tables = {}

    def mix(state: MeshTrainState, flat: WorkerBlocks, cursor: int, row,
            do_mix: bool, alive, gate, counting: bool):
        """The one-card step's ``mix`` on the folded stack: ``(flat,
        consumed)``, the ages consumed ``i32[N]`` on card 0 when
        ``counting`` on the ring."""
        first = state.mesh.devices[0]
        if ring_on:
            slot = cursor % staleness
            consumed = []
            for card in state.cards:
                ages = card.mix_ages
                ages.add_((ages >= 0).to(ages.dtype))
                if counting:
                    consumed.append(ages[:, slot].clone().to(first))
            flat = communicator.apply_mix(flat, WorkerBlocks(
                card.mix_pending[:, slot] for card in state.cards))
            if do_mix:
                delta, state.comm_carry = _issue(
                    communicator, flat, state.comm_carry, row, alive, gate)
                issued = (None if alive is None else split_like(
                    (alive > 0) & (gate > 0), flat))
                for c, card in enumerate(state.cards):
                    card.mix_pending[:, slot] = delta[c]
                    if issued is None:
                        card.mix_ages[:, slot] = 0
                    else:
                        # dead or non-finite rows issued nothing real
                        card.mix_ages[:, slot] = torch.where(
                            issued[c], 0, -1).to(card.mix_ages.dtype)
            else:
                for card in state.cards:
                    card.mix_pending[:, slot] = 0.0
                    card.mix_ages[:, slot] = -1
            return flat, (torch.cat(consumed) if counting else None)
        if overlap_on:
            flat = communicator.apply_mix(flat, state.mix_pending)
            if do_mix:
                state.mix_pending, state.comm_carry = _issue(
                    communicator, flat, state.comm_carry, row, alive, gate)
            else:
                state.mix_pending = flat.zeros_like()
            return flat, None
        if do_mix:
            flat, state.comm_carry = _exchange(
                communicator, flat, state.comm_carry, row, alive, gate)
        return flat, None

    def heal(state: MeshTrainState, flat: WorkerBlocks, t: int, member,
             counting: bool):
        """The one-card step's ``heal`` on the folded stack."""
        first = state.mesh.devices[0]
        if faults is not None:
            alive_t, revive_t, inject_t = fault_rows(first, t)
            flat = inject_nan_rows(flat, inject_t)
            if member is not None:
                # a vacant slot is dead whatever the plan says, and a
                # planned revival of a vacant slot stays vacant
                alive_t = alive_t * member.alive
                revive_t = revive_t * member.alive
        else:
            alive_t = member.alive
            revive_t = torch.zeros_like(alive_t)
        flat, alive, healed, gate = heal_and_mask(flat, alive_t, revive_t)
        keep = 1.0 - healed
        drops = [_reset_rows(card, block_of(state.comm_carry, c), k, rows,
                             overlap_on, ring_on, counting)
                 for c, (card, k) in enumerate(zip(state.cards,
                                                   split_like(keep, flat)))]
        heal_folded_stat_rows([_stat_buffers(card.model)
                               for card in state.cards], healed,
                              alive * keep, rows)
        return flat, alive, healed, gate, _card_sum(drops, first)

    def step(state: MeshTrainState, xb: torch.Tensor, yb: torch.Tensor):
        devices = state.mesh.devices
        first = devices[0]
        n = rows * len(devices)
        _check_faults(faults, flags_host, n)
        cursor = state.step
        t = min(cursor, flags_host.shape[0] - 1)
        tel = (state.telemetry if telemetry is not None
               and isinstance(state.telemetry, Telemetry) else None)
        counting = tel is not None
        member = (state.membership if elastic
                  and isinstance(state.membership, Membership) else None)
        # each card's vacant rows: host-made index tensors, so their
        # sizes are metadata, not device reads
        vacant = ([v if v.numel() else None for v in member.card_vacant]
                  if member is not None and member.vacant.numel()
                  else [None] * len(devices))
        saved = [None if v is None else _capture_vacant(
                     mesh_card_state(state, c), flattener, v)
                 for c, v in enumerate(vacant)]
        # each card's step advances its own cursor: the mesh's
        parts = [card_step(card,
                           xb[c * rows:(c + 1) * rows].to(devices[c],
                                                          non_blocking=True),
                           yb[c * rows:(c + 1) * rows].to(devices[c],
                                                          non_blocking=True)
                           )[1]
                 for c, card in enumerate(state.cards)]
        dev = communicator.flags_device(first)
        if dev not in comm_flags:
            comm_flags[dev] = torch.as_tensor(comm_flags_host, device=dev)
        row = comm_flags[dev][t]
        if member is not None and member.alpha_scale != 1.0:
            row = row * float(np.float32(member.alpha_scale))
        every = local_steps
        knobs = state.control if control and isinstance(
            state.control, ControlKnobs) else None
        if knobs is not None:
            row = row * knobs.row_scale
            if knobs.alpha_scale != 1.0:
                row = row * knobs.alpha_scale
            every = knobs.local_every
        do_mix = cursor % every == 0
        with torch.no_grad():
            flat = mesh_flat(state, flattener)
            alive = healed = gate = dropped = None
            if faults is not None or member is not None:
                with device_span("matcha/heal"):
                    flat, alive, healed, gate, dropped = heal(
                        state, flat, t, member, counting)
            with device_span("comm/step"):
                flat, consumed = mix(state, flat, cursor, row, do_mix, alive,
                                     gate, counting)
            for c, v in enumerate(vacant):
                if v is not None:
                    # the vacant slots keep the rows they had before the
                    # step (the survivor mask made their gossip a self-loop)
                    flat[c].index_copy_(0, v, saved[c]["flat"])
                    _freeze_vacant(mesh_card_state(state, c), saved[c], v,
                                   rows)
            if member is not None and overlap_on:
                vacated = _card_sum(
                    [_vacate_pending(card, m, rows, ring_on, counting)
                     for card, m in zip(state.cards,
                                        split_like(member.alive, flat))],
                    first)
                if vacated is not None:
                    dropped = (vacated if dropped is None
                               else dropped + vacated)
            if do_mix or overlap_on or alive is not None:
                for card, block in zip(state.cards, flat):
                    flattener.unflatten_into(block, card.params)
            deviation, disagreement = _folded_deviation(flat, first, alive)
            metrics = {k: v for k, v in parts[0].items()
                       if not k.startswith("worker_")}
            metrics["disagreement"] = disagreement
            for key in ("loss", "accuracy"):
                if alive is None:
                    metrics[key] = torch.stack(
                        [part[key].to(first) for part in parts]).mean()
                else:
                    metrics[key] = _fleet_mean(torch.cat(
                        [part[f"worker_{key}"].to(first) for part in parts]),
                        alive)
            if alive is not None:
                metrics["healed"] = healed.sum()
                metrics["alive_workers"] = alive.sum()
            if tel is not None:
                age_bins = None
                if consumed is not None:
                    if first not in age_tables:
                        age_tables[first] = age_bin_table(staleness, first)
                    age_bins = age_tables[first]
                stale_dropped = dropped if ring_on else (
                    metrics.get("healed") if overlap_on else None)
                telemetry_step(
                    tel, telemetry, disagreement=disagreement,
                    # an elided step exchanges nothing: zero bytes
                    flags_t=flags_host[t] * np.float32(do_mix),
                    alive_count=metrics.get("alive_workers", n),
                    healed=metrics.get("healed"),
                    stale_dropped=stale_dropped, consumed_age=consumed,
                    worker_alive=alive, worker_disagreement=deviation,
                    age_bins=age_bins)
        return state, metrics

    return step


def _card_sum(values, first: torch.device):
    """The sum on ``first`` of the cards' 0-d counts; ``None`` when they
    are ``None``."""
    if values[0] is None:
        return None
    return torch.stack([v.to(first) for v in values]).sum()


def _folded_deviation(blocks, first: torch.device, alive=None):
    """``(worker_deviation_rows, disagreement)`` of the folded ``[N, D]``
    stack, on ``first``, from per-card partials
    (``parallel.worker_deviation`` across the cards): each card's ``[D]``
    column sum goes to ``first`` for the mean (with ``alive``, ``f32[N]``,
    the survivors' mean, ``parallel.masked_mean_rows``), the mean back to
    each card, and each card's ``[L]`` sums of squared deviations (0 for
    a quarantined row) to ``first`` in worker order.  Between real cards
    that moves ``2·C·D + N`` floats, not ``N·D``; the sums run in another
    order than the one-tensor function's."""
    n = sum(b.shape[0] for b in blocks)
    if alive is None:
        mean = torch.stack([b.sum(dim=0).to(first) for b in blocks]).sum(
            dim=0) / n
        gates = [None] * len(blocks)
    else:
        mean = masked_mean_rows(blocks, alive)
        gates = split_like(alive, blocks)
    sums = []
    for b, g in zip(blocks, gates):
        centered = b - mean.to(b.device)
        if g is not None:
            centered = torch.where(g.reshape(-1, *([1] * (b.ndim - 1))) > 0,
                                   centered, torch.zeros_like(centered))
        sums.append((centered * centered).reshape(b.shape[0], -1)
                    .sum(dim=1).to(first))
    sq = torch.cat(sums)
    d = mean.numel()
    count = n if alive is None else torch.clamp(alive.sum(), min=1.0)
    return torch.sqrt(sq / d), torch.sqrt(sq.sum() / (count * d))


def make_mesh_eval_fn(state: MeshTrainState):
    """Build ``evaluate(x, y) -> (loss[N], acc[N])`` over a mesh: each card
    evaluates the whole batch with its L workers (``x`` copied to cards on
    another device), the rows gathered onto card 0 in worker order."""
    fns = [make_eval_fn(card.model) for card in state.cards]
    devices = state.mesh.devices

    def evaluate(x: torch.Tensor, y: torch.Tensor):
        outs = [fn(x.to(dev), y.to(dev)) for fn, dev in zip(fns, devices)]
        return (torch.cat([loss.to(devices[0]) for loss, _ in outs]),
                torch.cat([acc.to(devices[0]) for _, acc in outs]))

    return evaluate


def make_eval_fn(model: nn.Module):
    """Build ``evaluate(x, y) -> (loss[N], acc[N])`` on device tensors:
    every worker evaluates the whole batch ``x: [B, ...]``."""

    def evaluate(x: torch.Tensor, y: torch.Tensor):
        n = model.num_workers
        model.eval()
        with torch.no_grad():
            logits = model(x.unsqueeze(0).expand((n,) + tuple(x.shape)))
            labels = y.unsqueeze(0).expand(n, -1)
            return (cross_entropy_loss(logits, labels),
                    top_k_accuracy(logits, labels))

    return evaluate
