"""Train state and the (SGD + gossip) step.

Port of ``matcha_tpu/train/state.py``: ``make_optimizer`` (:100),
``init_train_state`` (:114), ``make_train_step`` (:167, with
``grad_chunk``, the pipelined schedule and local-step elision) and
``make_eval_fn`` (:672).  Faults, elastic membership, run control and
telemetry are not ported yet.

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
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from ..communicator import Communicator
from ..models.layers import init_workers
from ..ops import WorkerFlattener
from ..parallel import worker_disagreement
from ..utils import cross_entropy_loss, top_k_accuracy

__all__ = ["OptimizerSpec", "TrainState", "fresh_mix_pending",
           "init_train_state", "make_eval_fn", "make_optimizer",
           "make_train_step"]


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
    # filled or after an elided issue), () below K = 2.  Never
    # checkpointed: a resume rebuilds it from the cursor.
    mix_ages: Any = ()

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    @property
    def batch_stats(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_buffers())


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
        return torch.optim.SGD(list(params), lr=float(self.lr_schedule(0)),
                               momentum=self.momentum,
                               weight_decay=self.weight_decay,
                               nesterov=self.nesterov)


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
    init_workers(model, seed)
    if sync_init:
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(p.mean(dim=0, keepdim=True).expand_as(p))
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
):
    """Build ``step(state, xb, yb) -> (state, metrics)``.

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
    """
    flags_host = np.asarray(flags, np.float32)  # [T, M]
    n = flattener.num_workers
    if overlap not in ("off", "1step"):
        raise ValueError(f"overlap must be 'off' or '1step', got {overlap!r}")
    overlap_on = overlap == "1step"
    staleness = int(staleness)
    if staleness < 1:
        raise ValueError(f"staleness must be >= 1, got {staleness}")
    if staleness > 1 and not overlap_on:
        raise ValueError("staleness > 1 needs overlap='1step': the eager "
                         "path has no pending ring to age deltas through")
    ring_on = overlap_on and staleness > 1
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
    comm_flags = {}  # device -> tensor, placed at first use
    if grad_chunk is not None and not 1 <= grad_chunk <= n:
        raise ValueError(f"grad_chunk {grad_chunk} must be in [1, {n}]")
    if grad_chunk is not None and n % grad_chunk:
        raise ValueError(f"grad_chunk {grad_chunk} must divide num_workers "
                         f"{n}")
    slabs = [(0, n)] if grad_chunk is None else [
        (lo, lo + grad_chunk) for lo in range(0, n, grad_chunk)]

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

    def mix(state: TrainState, flat: torch.Tensor, row) -> torch.Tensor:
        """The consensus transform of this step on ``flat``; returns the
        state the step leaves visible (the pending deltas in ``state``)."""
        do_mix = state.step % local_steps == 0
        if ring_on:
            slot = state.step % staleness
            ages = state.mix_ages
            ages.add_((ages >= 0).to(ages.dtype))
            ring = state.mix_pending
            flat = communicator.apply_mix(flat, ring[:, slot])
            if do_mix:
                delta, state.comm_carry = communicator.begin_mix(
                    flat, state.comm_carry, row)
                ring[:, slot] = delta
                ages[:, slot] = 0
            else:
                ring[:, slot] = 0.0
                ages[:, slot] = -1
            return flat
        if overlap_on:
            flat = communicator.apply_mix(flat, state.mix_pending)
            if do_mix:
                state.mix_pending, state.comm_carry = communicator.begin_mix(
                    flat, state.comm_carry, row)
            else:
                state.mix_pending = torch.zeros_like(flat)
            return flat
        if do_mix:
            flat, state.comm_carry = communicator.step(
                flat, state.comm_carry, row)
        return flat

    def step(state: TrainState, xb: torch.Tensor, yb: torch.Tensor):
        model, opt = state.model, state.optimizer
        dev = communicator.flags_device(xb.device)
        if dev not in comm_flags:
            comm_flags[dev] = torch.as_tensor(comm_flags_host, device=dev)
        model.train()
        opt.zero_grad(set_to_none=True)
        losses, logits = forward_backward(model, xb, yb)
        lr = float(optimizer.lr_schedule(state.step))
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()

        t = min(state.step, flags_host.shape[0] - 1)
        params = state.params
        with torch.no_grad():
            flat = mix(state, flattener.flatten(params), comm_flags[dev][t])
            flattener.unflatten_into(flat, params)
            metrics = {
                "loss": losses.mean(),
                "accuracy": top_k_accuracy(logits, yb).mean(),
                "disagreement": worker_disagreement(flat),
                "lr": float(lr_schedule(state.step)) if lr_schedule else 0.0,
                "active_matchings": float(flags_host[t].sum()),
            }
        state.step += 1
        return state, metrics

    return step


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
