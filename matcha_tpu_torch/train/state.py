"""Train state and the (SGD + gossip) step.

Port of ``matcha_tpu/train/state.py`` on its eager path (no overlap,
faults, elastic membership, run control, telemetry or local-step elision):
``make_optimizer`` (:100), ``init_train_state`` (:114), ``make_train_step``
(:167, with ``grad_chunk``) and ``make_eval_fn`` (:672).

The JAX step vmaps a per-worker loss over the worker axis.  The port's
model holds all workers stacked, so one forward/backward serves them all:
the loss handed to autograd is the **sum** of the per-worker mean losses,
which gives every worker exactly the gradient of its own loss (a mean over
workers would scale each by 1/N).  Then torch-style SGD, then the
communicator's consensus transform on the flattened ``[N, D]`` parameter
stack.  Batch-norm statistics are per-worker buffers and are not gossiped.

PyTorch updates in place: the step mutates the state it is given (model
parameters, optimizer momentum, the step cursor) and returns it.
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

__all__ = ["OptimizerSpec", "TrainState", "init_train_state", "make_eval_fn",
           "make_optimizer", "make_train_step"]


@dataclasses.dataclass
class TrainState:
    model: nn.Module  # worker-stacked parameters and BN buffers, [N, ...]
    optimizer: torch.optim.Optimizer  # holds the momentum (opt_state)
    comm_carry: Any
    step: int  # host-side schedule cursor

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


def init_train_state(model: nn.Module, num_workers: int,
                     optimizer: OptimizerSpec, communicator: Communicator,
                     seed: int = 0, sync_init: bool = True,
                     device=None) -> tuple[TrainState, WorkerFlattener]:
    """Per-worker independent inits (worker ``w`` seeded ``seed + w``),
    made on the CPU so they are the same on every device, then the
    reference's initial AllReduce sync when ``sync_init``."""
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
    state = TrainState(
        model=model,
        optimizer=optimizer.init(model.parameters()),
        comm_carry=communicator.init(flattener.flatten(params)),
        step=0,
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
    """
    flags_host = np.asarray(flags, np.float32)  # [T, M]
    flags_dev = {}  # device -> tensor, placed at first use
    n = flattener.num_workers
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

    def step(state: TrainState, xb: torch.Tensor, yb: torch.Tensor):
        model, opt = state.model, state.optimizer
        dev = communicator.flags_device(xb.device)
        if dev not in flags_dev:
            flags_dev[dev] = torch.as_tensor(flags_host, device=dev)
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
            flat = flattener.flatten(params)
            flat, state.comm_carry = communicator.step(
                flat, state.comm_carry, flags_dev[dev][t])
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
