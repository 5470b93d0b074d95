"""The training loop.

Port of ``matcha_tpu/train/loop.py``: ``build_schedule`` (:79),
``build_dataset`` (:105) and ``train`` (:132) on the slice-1 path.  It
builds topology → schedule → communicator → model → data → optimizer,
syncs the initial replicas, then runs the epochs.  Differences by design:

* A plain Python step loop in place of the scanned epoch.  Step metrics
  accumulate on the device and are read once per epoch, together with the
  divergence check; the learning rate and the flag row come from host
  arrays, so no step reads the device.
* The training set and the test set are placed on the device once; each
  step gathers its ``[N, B, ...]`` batch there with the loader's indices
  (the host path is kept for augmentation, which is numpy).
* The comm-split timer re-runs each epoch's gossip chain in isolation,
  through ``Communicator.run``, and charges its wall-clock to
  ``comm_time``; it synchronizes the card before every clock read.

Not ported yet (``TrainConfig`` refuses them): the Recorder and its journal,
checkpoints, rollback recovery, faults, elastic membership, telemetry and
the drift monitor, overlap/staleness and local steps.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..communicator import make_decen
from ..data import (
    WorkerBatches,
    normalized_zero,
    partition_indices,
    synthetic_classification,
    synthetic_images,
)
from ..models import select_model
from ..schedule import Schedule, fixed_schedule, matcha_schedule
from ..topology import decompose, graph_size, make_graph, select_graph
from ..utils import resolve_device, synchronize
from .config import TrainConfig
from .lr import make_lr_schedule
from .state import (
    TrainState,
    init_train_state,
    make_eval_fn,
    make_optimizer,
    make_train_step,
)

__all__ = ["TrainResult", "TrainingDiverged", "build_dataset",
           "build_schedule", "train"]


class TrainingDiverged(RuntimeError):
    """Raised when an epoch produces a non-finite loss or train state
    (parameters, batch-norm statistics or momentum)."""


def build_schedule(config: TrainConfig, iterations: int) -> Schedule:
    """Topology + schedule from config (the reference's train_mpi.py:69-75)."""
    if config.graphid is not None:
        decomposed = select_graph(config.graphid)
        size = graph_size(config.graphid)
        if size != config.num_workers:
            raise ValueError(
                f"graphid {config.graphid} is a {size}-worker topology but "
                f"num_workers={config.num_workers}; set graphid=None to use a "
                f"generator topology of any size"
            )
    else:
        edges = make_graph(config.topology, config.num_workers, seed=config.seed)
        decomposed = decompose(edges, config.num_workers, seed=config.seed)
        size = config.num_workers

    if config.matcha:
        return matcha_schedule(
            decomposed, size, iterations, budget=config.budget, seed=config.seed
        )
    return fixed_schedule(
        decomposed, size, iterations, budget=config.budget,
        mode=config.fixed_mode, seed=config.seed,
    )


def build_dataset(config: TrainConfig):
    kwargs = config.dataset_kwargs or {}
    if config.dataset == "synthetic":
        return synthetic_classification(seed=config.seed, **kwargs)
    if config.dataset == "synthetic_image":
        return synthetic_images(seed=config.seed, **kwargs)
    if config.datasetRoot is not None:
        from ..data import load_npz

        return load_npz(config.datasetRoot, dataset=config.dataset)
    raise NotImplementedError(
        f"dataset '{config.dataset}' is not ported yet: the port builds "
        f"'synthetic' and 'synthetic_image', or loads an .npz through "
        f"datasetRoot (ROADMAP.md)")


@dataclasses.dataclass
class TrainResult:
    state: TrainState
    schedule: Schedule
    history: List[Dict]  # one dict per epoch, the JAX package's keys


def train(config: TrainConfig, device=None) -> TrainResult:
    """Run ``config`` on ``device`` (default: the CUDA card; a host without
    one raises unless ``device="cpu"`` is asked for)."""
    dev = resolve_device(device)
    # f32 means f32, as in the JAX package: no TF32 in matmuls or convs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    dataset = build_dataset(config)
    parts = partition_indices(
        len(dataset.x_train), config.num_workers, seed=config.seed,
        non_iid=config.non_iid, labels=dataset.y_train,
    )
    loader = WorkerBatches(
        dataset.x_train, dataset.y_train, parts, config.batch_size,
        seed=config.seed, augment=config.augment,
        pad_value=normalized_zero(config.dataset),
    )
    bpe = loader.batches_per_epoch
    schedule = build_schedule(config, config.epochs * bpe + 1)
    if config.alpha_override is not None:
        schedule = dataclasses.replace(schedule,
                                       alpha=float(config.alpha_override))
    flags = np.asarray(schedule.flags, np.float32)

    communicator = make_decen(
        schedule, config.gossip_backend, device=dev,
        block_d=config.gossip_block_d, w_window=config.gossip_w_window,
        wire_dtype=config.wire_dtype)
    model = select_model(config.model, config.dataset,
                         num_classes=dataset.num_classes,
                         num_workers=config.num_workers,
                         input_shape=dataset.x_train.shape[1:])
    lr_schedule = make_lr_schedule(
        config.lr, bpe, base_lr=config.base_lr, warmup=config.warmup,
        warmup_epochs=config.warmup_epochs, decay_epochs=config.decay_epochs,
        decay_factor=config.decay_factor)
    optimizer = make_optimizer(lr_schedule, config.momentum,
                               config.weight_decay, config.nesterov)
    state, flattener = init_train_state(
        model, config.num_workers, optimizer, communicator, seed=config.seed,
        sync_init=config.sync_init, device=dev)
    step_fn = make_train_step(optimizer, communicator, flattener, flags,
                              lr_schedule)
    evaluate = make_eval_fn(model)
    comm_timer = (_make_comm_timer(communicator, flattener, dev)
                  if config.measure_comm_split else None)

    x_train = None if config.augment else torch.as_tensor(dataset.x_train,
                                                          device=dev)
    y_train = torch.as_tensor(dataset.y_train, device=dev).long()
    x_test = torch.as_tensor(dataset.x_test, device=dev)
    y_test = torch.as_tensor(dataset.y_test, device=dev).long()

    history: List[Dict] = []
    for epoch in range(config.epochs):
        synchronize(dev)
        t0 = time.perf_counter()
        dev_sums: Dict[str, torch.Tensor] = {}
        host_sums: Dict[str, float] = {}
        count = 0
        for xb, yb in _epoch_batches(loader, epoch, x_train, y_train, dev):
            state, metrics = step_fn(state, xb, yb)
            for k, v in metrics.items():
                if isinstance(v, torch.Tensor):
                    dev_sums[k] = dev_sums[k] + v if k in dev_sums else v
                else:
                    host_sums[k] = host_sums.get(k, 0.0) + v
            count += 1
        finite = _state_finite(state)
        # the one deliberate per-epoch read: the step metrics and the
        # divergence check together
        keys = list(dev_sums)
        read = torch.stack([dev_sums[k] for k in keys]
                           + [finite.to(torch.float32)]).tolist()
        epoch_time = time.perf_counter() - t0
        epoch_metrics = {k: read[i] / count for i, k in enumerate(keys)}
        epoch_metrics.update({k: v / count for k, v in host_sums.items()})

        if config.halt_on_divergence and (
                not np.isfinite(epoch_metrics["loss"]) or read[-1] < 1.0):
            what = ("training loss " + str(epoch_metrics["loss"])
                    if not np.isfinite(epoch_metrics["loss"])
                    else "train state (params/BN stats/momentum)")
            raise TrainingDiverged(
                f"non-finite {what} in epoch {epoch} (lr={config.lr}, "
                f"communicator={config.communicator})")

        comm_time = comm_encode_time = 0.0
        if comm_timer is not None:
            window = flags[epoch * bpe:(epoch + 1) * bpe]
            split = comm_timer(state, window)
            comm_time = min(split["comm_time"], epoch_time)
            comm_encode_time = min(split["comm_encode_time"], comm_time)

        test_loss = test_acc = np.zeros(config.num_workers)
        if config.eval_every and (epoch + 1) % config.eval_every == 0:
            eval_batch = config.eval_batch or max(16, 1024 // config.num_workers)
            test_loss, test_acc = _evaluate_in_batches(
                evaluate, x_test, y_test, eval_batch)

        history.append({
            "epoch": epoch,
            **epoch_metrics,
            "test_acc_mean": float(np.mean(test_acc)),
            "test_loss_mean": float(np.mean(test_loss)),
            "epoch_time": epoch_time,
            "comm_time": comm_time,
            "comm_encode_time": comm_encode_time,
            "comm_exchange_time": comm_time - comm_encode_time,
        })
    return TrainResult(state, schedule, history)


def _epoch_batches(loader: WorkerBatches, epoch: int,
                   x_train: Optional[torch.Tensor], y_train: torch.Tensor,
                   dev: torch.device):
    """The loader's ``[N, B, ...]`` batches on ``dev``: gathered on the
    device from the placed training set, or (with augmentation, which is
    host numpy) copied from the host batch."""
    if x_train is None:
        for xb, yb in loader.epoch(epoch):
            yield (torch.as_tensor(xb, device=dev),
                   torch.as_tensor(yb, device=dev).long())
        return
    for idx in loader.epoch_indices(epoch):
        idx = torch.as_tensor(idx, device=dev)
        yield x_train[idx], y_train[idx]


def _state_finite(state: TrainState) -> torch.Tensor:
    """0-d bool: every parameter, BN buffer and momentum buffer is finite."""
    tensors = list(state.model.parameters()) + list(state.model.buffers())
    tensors += [s["momentum_buffer"] for s in state.optimizer.state.values()
                if s.get("momentum_buffer") is not None]
    return torch.stack([torch.isfinite(t).all() for t in tensors]).all()


def _make_comm_timer(communicator, flattener, dev: torch.device,
                     sample_steps: int = 32):
    """Gossip-only chain, timed on the host clock after a synchronize.

    Scaling to the full epoch uses the *marginal* per-step cost: two window
    lengths (k and 2k) are timed and the difference isolates the per-step
    rate from the fixed launch overhead, paid once per chain.  Estimate:
    ``t(n) ≈ t_2k + marginal·(n−2k)``; an epoch of at most 2k steps is
    timed whole.  Every timed chain runs once to warm up first.  Returns
    ``{"comm_time", "comm_encode_time"}`` (encode 0.0: no compression)."""

    def chain(state, flags):
        flat = flattener.flatten(state.params)
        out, _ = communicator.run(flat, flags, state.comm_carry)
        return out

    def timed(state, flags_window, m: int) -> float:
        flags = torch.as_tensor(flags_window[:m], dtype=torch.float32,
                                device=dev)
        chain(state, flags)  # warm-up
        synchronize(dev)
        t0 = time.perf_counter()
        chain(state, flags)
        synchronize(dev)
        return time.perf_counter() - t0

    def timer(state, flags_window) -> Dict[str, float]:
        n = len(flags_window)
        k = min(sample_steps, max(n // 2, 1))
        if n <= 2 * k:
            comm = timed(state, flags_window, n)
        else:
            t1 = timed(state, flags_window, k)
            t2 = timed(state, flags_window, 2 * k)
            comm = t2 + max(t2 - t1, 0.0) / k * (n - 2 * k)
        return {"comm_time": comm, "comm_encode_time": 0.0}

    return timer


def _evaluate_in_batches(evaluate, x_test: torch.Tensor, y_test: torch.Tensor,
                         batch: int):
    """Every worker on the whole test set, ``batch`` examples per call;
    weighted sums stay on the device and are read once."""
    loss_sum = acc_sum = None
    for i in range(0, len(x_test), batch):
        xl, yl = x_test[i:i + batch], y_test[i:i + batch]
        loss, acc = evaluate(xl, yl)
        w = float(len(yl))
        loss_sum = loss * w if loss_sum is None else loss_sum + loss * w
        acc_sum = acc * w if acc_sum is None else acc_sum + acc * w
    read = (torch.stack([loss_sum, acc_sum]) / float(len(x_test))).cpu().numpy()
    return read[0].astype(np.float64), read[1].astype(np.float64)
