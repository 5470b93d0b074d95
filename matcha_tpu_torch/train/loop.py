"""The training loop.

Port of ``matcha_tpu/train/loop.py``: ``build_schedule`` (:79),
``build_dataset`` (:105) and ``train`` (:132) on its eager path.  It
builds topology → schedule → communicator → model → data → optimizer,
syncs the initial replicas (or restores a checkpoint), then runs the
epochs; each epoch ends with the evaluation, the Recorder's row and event
(CSVs flushed every 10 epochs and at the end when ``save``), and a
checkpoint every ``checkpoint_every`` epochs.  Differences by design:

* A plain Python step loop in place of the scanned epoch.  Step metrics
  accumulate on the device and are read once per epoch, together with the
  divergence check; the learning rate and the flag row come from host
  arrays, so no step reads the device.
* The training set and the test set are placed on the device once; each
  step gathers its ``[N, B, ...]`` batch there with the loader's indices
  (the host path is kept for augmentation, which is numpy).
* The comm-split timer re-runs each epoch's gossip chain in isolation,
  through ``Communicator.run``, and charges its wall-clock to
  ``comm_time``; it synchronizes the card before every clock read.  A
  backend with a ``multi_step`` (perm, fused) runs each timed chain as one
  kernel launch; under ``fused`` that is the only place the fused W-stack
  kernel runs, since every training step mixes with the dense product.
  CHOCO's compress path is timed alone too (``comm_encode_time``).  As in
  the JAX package, the ``none`` communicator runs no timer.
* CHOCO's compression warmup (``compress_warmup_epochs``): each distinct
  ramped ratio gets its own communicator, step and timer, built at its
  first epoch; the ``{x̂, s}`` carry crosses the stages unchanged.
* A checkpoint is copied from the card to the host only at its cadence,
  by ``torch.save`` (``train/checkpoint.py``).
* cuDNN runs its deterministic algorithms, so a run on the card is
  reproducible and a resumed run equals the uninterrupted one bitwise.
* The pipelined schedule (``overlap``, ``staleness``, ``local_steps``), as
  the JAX loop runs it: the flag stream is thinned to every L-th row for
  the step and the comm-split timer alike (:188-200); a ``staleness > 1``
  decen run executes the damped α of ``plan.stale_alpha_rescale``
  (:338-356); a restored pending state is reconciled with this run's
  depth (``_reconcile_mix_pending``, :1352); and ``train()`` drains the
  in-flight deltas before it returns (:1281-1316).  The port issues
  ``begin_mix`` on the same CUDA stream as the step, so nothing overlaps
  on the card yet.
* Resilience and elastic membership, as the JAX loop runs them: a fault
  plan compiled against the schedule (its link outages folded into the
  flag stream, :173-202, its ``plan`` journaled, :670-680); a membership
  trace replayed by the ``ElasticController`` at each epoch boundary, with
  the (re)join bootstrap and the ``membership`` event (:916-953), and
  through a resume (``replay_to``, the checkpoint's membership sidecar,
  ``reconcile_restored``, :568-600); the per-worker divergence detector
  over the whole state with its quarantine exemptions (:997-1023); and
  rollback recovery (:1030-1140): a copy of the state on the device each
  epoch while the budget lasts, the emergency checkpoint, the consumed
  NaN events, the learning-rate backoff and one α re-derivation.  The
  evaluation leaves NaN gaps for dead and vacant rows (:1174-1187).

* The planner's hooks, as the JAX loop has them: a plan artifact resolved
  into the config at entry (:141-147); the gossip backend resolved once
  for a decen run, ``auto`` through the planner's gate on the measured
  ratio given or read from ``gossip_measured_source`` (:270-298); the
  decision journaled as a ``backend`` event right after ``run_start`` or
  ``resume`` (:755-759).
* The observability plane, as the JAX loop runs it: the telemetry spec
  built once and the accumulator made fresh at entry, on resume, after
  every flush and for a rollback's retry (:360-375, :442, :602, :1233);
  its tensors ride the epoch's one read, and the flush is journaled as
  ``telemetry`` (:1220-1233); the composed ρ (``_compose_predicted``,
  :681-727) in ``run_start``/``resume``, and the drift monitor of a
  decen run (:729-738), re-based with the journal's ``predicted`` on a
  membership re-plan (:925-945) and on a recovery's α re-derivation
  (:1101-1120); with ``save``, one heartbeat a host and epoch under
  ``{run}/health/``, its anomalies and the heartbeat sink's ``recovery``
  events (:627-636, :1239-1262); and the live membership source
  (:238-246), seeded from the journal on a resume (:577-592).
* Performance observability, as the JAX loop has it: with ``telemetry``
  the cost ledger (:616-621) measures the first call of each distinct
  program (the step, the comm-split timer's chains, the evaluation, the
  drain) and journals one ``compile`` event for it; the heartbeat's
  ``peak_bytes`` is the ledger's largest (:1242); a step program seen
  with a second input signature is journaled as a ``retrace`` (:786-805).
  With ``trace_dir`` one epoch, ``min(trace_epoch, epochs − 1)``, runs in
  a ``torch.profiler`` window with its one read (:965-972); the window
  closes after the epoch's clock is read, so the capture's export is not
  charged to the epoch.  Host phases carry ``annotate`` ranges
  (``matcha/checkpoint``, ``matcha/membership_bootstrap``,
  ``matcha/comm_split_timer``, ``matcha/recorder_flush``).
* The run controller's seam, as the JAX loop has it: ``boundary_hook``
  is called with a ``_BoundarySeam`` at the top of every epoch (:904-915)
  and may swap the knobs the step reads (``serve.ControlKnobs``, host
  values re-primed into ``state.control`` after the hook), re-base the
  drift monitor on a budget swap's probabilities (:711), edit config
  fields no step reads, checkpoint the last completed epoch and stop the
  run.  Under a hook the flag stream is not thinned by ``local_steps``
  (the knob gates the steps instead, :188-206), and the journal of a
  previous lifetime is reloaded even at epoch 0 (:645-660).  The chaos
  harness's ``epoch_boundary`` kill tap sits at the top of each epoch,
  before the hook, as in the JAX loop (:897-903).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..communicator import select_communicator
from ..communicator.decen import resolve_gossip_backend
from ..data import (
    WorkerBatches,
    normalized_zero,
    partition_indices,
    photo_patches,
    synthetic_classification,
    synthetic_images,
    uci_digits,
)
from ..elastic import (
    ElasticController,
    LiveMembershipSource,
    load_membership_trace,
    make_bootstrap_fn,
    membership_arrays,
)
from ..models import select_model
from ..obs.anomaly import AnomalyDetector
from ..obs.costs import CostLedger
from ..obs.drift import DriftMonitor, compose_predicted_rho
from ..obs.health import HeartbeatEmitter
from ..obs.journal import read_journal
from ..obs.telemetry import (
    Telemetry,
    make_telemetry_spec,
    telemetry_flush,
    telemetry_tensor,
)
from ..plan import apply_plan, load_measured_vs_ceiling
from ..resilience import load_fault_plan, resolve_degraded_alpha
from ..resilience.runtime import state_finite_rows
from ..schedule import (
    Schedule,
    fixed_schedule,
    matcha_schedule,
    solve_mixing_weight,
)
from ..serve.runtime import control_arrays
from ..topology import decompose, graph_size, make_graph, select_graph
from ..utils import annotate, resolve_device, synchronize, trace
from .checkpoint import (
    load_membership_sidecar,
    restore_with_fallback,
    save_checkpoint,
)
from .config import TrainConfig
from .lr import make_lr_schedule
from .recorder import Recorder
from .state import (
    TrainState,
    fresh_mix_pending,
    init_train_state,
    make_eval_fn,
    make_optimizer,
    make_train_step,
)

__all__ = ["TrainResult", "TrainingDiverged", "build_dataset",
           "build_schedule", "train"]


class TrainingDiverged(RuntimeError):
    """Raised when an epoch produces a non-finite loss or train state
    (parameters, batch-norm statistics, momentum, the communicator's carry
    or the pending deltas), per worker outside the quarantine.  With
    ``max_recoveries > 0`` the loop first rolls back to the epoch's
    snapshot, backs the learning rate off and re-derives α, and raises only
    once the budget is spent."""


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
    if config.dataset == "digits":
        return uci_digits(seed=config.seed, **kwargs)
    if config.dataset == "photo_patches":
        return photo_patches(seed=config.seed, **kwargs)
    if config.datasetRoot is None:
        raise ValueError(
            f"dataset '{config.dataset}' needs datasetRoot pointing at an "
            f".npz file (no dataset is downloaded)")
    from ..data import load_npz

    return load_npz(config.datasetRoot, dataset=config.dataset)


@dataclasses.dataclass
class TrainResult:
    state: TrainState
    recorder: Recorder
    schedule: Schedule
    history: List[Dict]  # one dict per epoch run, the JAX package's keys


def _reproducible_numerics() -> None:
    """f32 means f32, as in the JAX package: no TF32 in matmuls or convs.
    And a run is reproducible, as the JAX package's runs are: cuDNN takes
    its deterministic algorithms and does not benchmark for the fastest
    (their cost per step: ``PERF.md`` § 5)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def train(config: TrainConfig, resume_dir: Optional[str] = None,
          device=None, boundary_hook=None) -> TrainResult:
    """Run ``config`` on ``device`` (default: the CUDA card; a host without
    one raises unless ``device="cpu"`` is asked for).

    ``resume_dir`` (default ``config.resume``): a checkpoint directory.
    The newest intact generation is restored (a damaged one is quarantined
    and journaled, and the next-oldest tried) and the run goes on from the
    epoch after it; ``history`` then holds the epochs run here.

    With ``telemetry`` on the card, the cost ledger resets the allocator's
    peak counter (``torch.cuda.reset_peak_memory_stats``) before each
    program's first call: a caller that reads ``max_memory_allocated``
    around ``train()`` sees the peak since the last such call, not the
    run's.  The heartbeats' ``peak_bytes`` is the largest program
    footprint the ledger measured.

    ``boundary_hook``: the run controller's seam (``serve.trainer.
    TrainerHarness.on_boundary``), called with a ``_BoundarySeam`` before
    each epoch, again on a rollback's retry.  With identity knobs a
    supervised run is bitwise the unsupervised one."""
    dev = resolve_device(device)
    _reproducible_numerics()
    if config.plan:
        # the plan artifact's schedule choice (graph, budget, seed) enters
        # the config before anything reads those fields
        config = apply_plan(config)

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
    # the plan's α, what the drift monitor predicts with: alpha_override
    # executes another α, and the monitor is to see that discrepancy
    plan_alpha = float(schedule.alpha)
    if config.alpha_override is not None:
        schedule = dataclasses.replace(schedule,
                                       alpha=float(config.alpha_override))
    # the runtime fault plan, compiled against the schedule's horizon into
    # static per-step arrays as the flags are; a severed link is a flag
    # that does not fire, so link outages fold into the flag stream here
    faults = fault_plan = None
    if config.fault_plan is not None:
        fault_plan = load_fault_plan(config.fault_plan)
        faults = fault_plan.compile(schedule.iterations, config.num_workers,
                                    schedule.num_matchings)
    run_flags = np.asarray(schedule.flags, np.float32)
    if faults is not None:
        run_flags = run_flags * faults.link_up
    if config.local_steps > 1 and boundary_hook is None:
        # local steps: the exchange fires every L-th step only.  The step
        # launches nothing on the other steps (a host branch); thinning the
        # stream too makes the comm-split timer count zero for them.  The
        # checkpoint fingerprints the schedule as built.  Under a boundary
        # hook the stream stays whole: the controller's ``local_every``
        # knob, swappable at any boundary, gates the steps instead
        keep = np.arange(len(run_flags)) % config.local_steps == 0
        run_flags = run_flags * keep[:, None].astype(np.float32)
    # checkpoints fingerprint the schedule as built: a recovery may
    # re-derive α, which no config could reproduce at resume time
    schedule0 = schedule

    # the run controller's knobs: a host mirror of ``state.control``,
    # identity until a control document swaps them at a boundary, then
    # re-primed into the step's input; ``control_probs`` are a budget
    # swap's effective probabilities, which the drift monitor predicts with
    control_knobs: Optional[Dict] = None
    control_probs = None
    stop_requested = False
    if boundary_hook is not None:
        control_knobs = {
            "row_scale": np.ones(schedule.num_matchings, np.float32),
            "alpha_scale": 1.0,
            "local_every": max(int(config.local_steps), 1),
        }

    # elastic membership: the trace replays at epoch boundaries through the
    # host controller; the step sees only the pool mask and the α scale
    elastic_ctl = membership_source = None
    if config.membership_live is not None:
        # events derived from heartbeat liveness instead of a declaration;
        # the controller and everything after it are the same
        membership_source = LiveMembershipSource(
            config.membership_live, deadline=config.membership_deadline)
    elif config.membership_trace is not None:
        membership_source = load_membership_trace(config.membership_trace)
    if membership_source is not None:
        elastic_ctl = ElasticController(
            membership_source, config.num_workers,
            hysteresis=config.membership_hysteresis,
            bootstrap=config.membership_bootstrap)

    # the gossip backend, resolved once here (``auto`` through the
    # planner's gate, on the measured ratio given or read from a file) and
    # handed to every rebuild; the decision is journaled after run_start
    backend_decision = None
    gossip_backend = config.gossip_backend
    if config.communicator == "decen":
        measured = config.gossip_measured_vs_ceiling
        measured_src = None
        if measured is None and config.gossip_measured_source:
            measured, measured_src = load_measured_vs_ceiling(
                config.gossip_measured_source)
        backend_decision = resolve_gossip_backend(
            schedule, requested=config.gossip_backend,
            wire_dtype=config.wire_dtype, measured_vs_ceiling=measured)
        if measured_src is not None:
            backend_decision["measured_source"] = measured_src
        gossip_backend = backend_decision["chosen"]

    def make_comm(ratio: float):
        return select_communicator(
            config.communicator, schedule, ratio=ratio,
            consensus_lr=config.consensus_lr, backend=gossip_backend,
            compressor=config.compressor, seed=config.seed, device=dev,
            block_d=config.gossip_block_d, w_window=config.gossip_w_window,
            wire_dtype=config.wire_dtype)

    communicator = make_comm(config.compress_ratio)
    model = select_model(config.model, config.dataset,
                         num_classes=dataset.num_classes,
                         num_workers=config.num_workers,
                         input_shape=dataset.x_train.shape[1:],
                         remat=config.remat)
    # lr_scale is the recovery's backoff (1.0 until a rollback)
    lr_scale = 1.0

    def make_lr():
        return make_lr_schedule(
            config.lr * lr_scale, bpe, base_lr=config.base_lr * lr_scale,
            warmup=config.warmup, warmup_epochs=config.warmup_epochs,
            decay_epochs=config.decay_epochs,
            decay_factor=config.decay_factor)

    lr_schedule = make_lr()
    optimizer = make_optimizer(lr_schedule, config.momentum,
                               config.weight_decay, config.nesterov)
    state, flattener = init_train_state(
        model, config.num_workers, optimizer, communicator, seed=config.seed,
        sync_init=config.sync_init, device=dev, overlap=config.overlap,
        staleness=config.staleness)
    evaluate = make_eval_fn(model)
    stale_scale = _stale_scale(config, schedule)

    # the telemetry's exchange accounting, fixed for the run; the "none"
    # communicator moves nothing, so its byte ledger is all zero
    tel_spec = None
    if config.telemetry:
        tel_dec = (schedule.decomposed if config.communicator != "none"
                   else [[] for _ in schedule.decomposed])
        tel_spec = make_telemetry_spec(
            tel_dec, flattener.dim, wire_dtype=config.wire_dtype,
            overlap=config.overlap, staleness=config.staleness)

    def fresh_telemetry():
        return Telemetry.zeros(config.num_workers, config.staleness,
                               device=dev)

    bootstrap_fn = member_alive_np = None
    if elastic_ctl is not None:
        bootstrap_fn = make_bootstrap_fn(flattener, config.num_workers)
        member_alive_np = elastic_ctl.alive_mask() > 0

    def bootstrap_rows(state, joined, restored):
        """Boundary surgery for (re)entering slots: the donors are the
        continuing members, alive now and not themselves entering."""
        donors = elastic_ctl.alive_mask() * (1.0 - joined) * (1.0 - restored)
        return bootstrap_fn(state, joined, restored, donors)

    def fresh_membership():
        return membership_arrays(elastic_ctl.alive_mask(),
                                 elastic_ctl.alpha_scale, dev)

    def fresh_control():
        """The knobs' host mirror as the step's input, with the flag
        rows' device (one copy of ``row_scale``)."""
        return control_arrays(control_knobs["row_scale"],
                              control_knobs["alpha_scale"],
                              control_knobs["local_every"],
                              communicator.flags_device(dev))

    def membership_sidecar():
        """What a checkpoint records beside the state: who owns which pool
        slot, and the α re-plan in force."""
        if elastic_ctl is None:
            return None
        return {"view": elastic_ctl.view.to_json(),
                "alpha": elastic_ctl.alpha, "rho": elastic_ctl.rho,
                "alpha_scale": elastic_ctl.alpha_scale}

    # the cost ledger, made with the Recorder below; until then (and with
    # telemetry off) a program runs unmeasured
    cost_ledger = None

    def ledger_call(label: str, fn, *args):
        """``fn(*args)``, the first call of each distinct program measured
        and journaled by the cost ledger."""
        if cost_ledger is None:
            return fn(*args)
        return cost_ledger.call(label, fn, *args)

    def make_stage(comm):
        """(step, comm-split timer) over ``comm``, from the current
        ``optimizer`` (its learning rate), ``faults`` and ``schedule``."""
        step = make_train_step(optimizer, comm, flattener, run_flags,
                               lr_schedule, grad_chunk=config.grad_chunk,
                               overlap=config.overlap,
                               staleness=config.staleness,
                               stale_alpha_scale=stale_scale,
                               local_steps=config.local_steps,
                               faults=faults,
                               elastic=elastic_ctl is not None,
                               telemetry=tel_spec,
                               control=control_knobs is not None)
        timer = (_make_comm_timer(comm, flattener, dev, ledger_call)
                 if config.measure_comm_split
                 and config.communicator != "none" else None)
        return step, timer

    # CHOCO's compression warmup: epochs below compress_warmup_epochs run
    # at a linearly ramped drop ratio (0 at epoch 0, dense-rate consensus
    # while the replicas are far apart); each distinct ratio is its own
    # stage, and the {x̂, s} carry crosses the stages unchanged
    def effective_ratio(epoch: int) -> float:
        w = config.compress_warmup_epochs
        if not w or epoch >= w:
            return config.compress_ratio
        return config.compress_ratio * (epoch / w)

    stages = {config.compress_ratio: make_stage(communicator)}

    def rebuild_programs():
        """Rebuild the step and the timer of every stage from the current
        ``lr_scale``, ``schedule`` (α perhaps re-derived) and ``faults``
        (NaN events consumed): a recovery's retry runs the updated
        recipe."""
        nonlocal lr_schedule, optimizer, communicator, stale_scale
        stale_scale = _stale_scale(config, schedule)
        lr_schedule = make_lr()
        optimizer = make_optimizer(lr_schedule, config.momentum,
                                   config.weight_decay, config.nesterov)
        communicator = make_comm(config.compress_ratio)
        stages.clear()
        stages[config.compress_ratio] = make_stage(communicator)

    start_epoch = 0
    recovery_notices: List[Dict] = []
    if resume_dir is None:
        resume_dir = config.resume
    if resume_dir is not None:
        state, last_epoch = restore_with_fallback(
            resume_dir, state, schedule=schedule, notices=recovery_notices)
        start_epoch = last_epoch + 1
        state = _reconcile_mix_pending(state, config.overlap, communicator,
                                       flattener, config.num_workers,
                                       staleness=config.staleness)
        if elastic_ctl is not None:
            # the controller state this boundary had (the trace replays
            # deterministically), then the restored rows mapped onto the
            # current occupancy: a slot whose saved content belongs to
            # another worker (or to nobody) bootstraps from the members
            journal_path = os.path.join(
                config.savePath, f"{config.name}_{config.model}",
                "events.jsonl")
            if hasattr(membership_source, "seed_replay") \
                    and os.path.exists(journal_path):
                # a live source's poll cache died with the old process: its
                # decisions replay from the journal, not from today's clock
                membership_source.seed_replay(read_journal(journal_path),
                                              start_epoch)
            elastic_ctl.replay_to(start_epoch, schedule)
            member_alive_np = elastic_ctl.alive_mask() > 0
            side = load_membership_sidecar(resume_dir, last_epoch)
            joined, restored = elastic_ctl.reconcile_restored(
                (side or {}).get("view"))
            if joined.any() or restored.any():
                state = bootstrap_rows(state, joined, restored)
    if tel_spec is not None:
        state.telemetry = fresh_telemetry()
    recorder = Recorder(config, config.num_workers)
    # every distinct program this loop runs is measured once (its first
    # call) and journaled as a `compile` event, gated with the rest of
    # observability
    cost_ledger = CostLedger(recorder.log_event) if config.telemetry else None
    # the epoch's program carries the JAX package's label: one step here,
    # where the JAX loop scans the epoch
    step_label = "epoch_scan" if config.scan_epoch else "train_step"
    retrace_flagged: set = set()

    def watch_retrace(fn):
        """A step program seen with a second input signature (a data
        loader that drifts shape) is journaled once, with the fingerprint
        of the program that was added (its `compile` event's)."""
        if cost_ledger is None or id(fn) in retrace_flagged:
            return
        traces = cost_ledger.traces(step_label, fn)
        if traces > 1:
            retrace_flagged.add(id(fn))
            recorder.log_event(
                "retrace", label=step_label, traces=traces,
                fingerprint=cost_ledger.last_fingerprint(step_label))

    # one heartbeat an epoch under {run}/health/ and the anomaly detectors
    # over those records: host code on values the epoch's read brought
    health_emitter = anomaly_detector = None
    if config.health and config.save and config.telemetry:
        health_emitter = HeartbeatEmitter(
            os.path.join(recorder.folder, "health"), host="host0")
        anomaly_detector = AnomalyDetector()

    def member_workers(worker_stats):
        """The heartbeat's workers: member slots only (a vacant slot is
        nobody's worker)."""
        occupants = (elastic_ctl.view.occupants if elastic_ctl is not None
                     else [f"w{i}" for i in range(config.num_workers)])
        return {wid: {"slot": i,
                      "participation": worker_stats["worker_participation"][i],
                      "disagreement": worker_stats["worker_disagreement"][i]}
                for i, wid in enumerate(occupants) if wid is not None}

    if config.save and (start_epoch or (
            boundary_hook is not None
            and os.path.exists(recorder.journal.path))):
        # extend the CSVs and the journal of the run being resumed, cut
        # back to the restored epoch.  A supervised run reloads the journal
        # at epoch 0 too: a relaunch before the first checkpoint trains
        # from scratch, but the journal is the supervision record, and the
        # previous lifetimes' control and promotion decisions stay in it
        recorder.load_previous(start_epoch)
    for n in recovery_notices:
        recorder.log_event("recovery", scope="checkpoint",
                           action="quarantine", reason=n["reason"],
                           epoch=n["step"], quarantined=n["path"])
    if fault_plan is not None:
        plan_events = fault_plan.to_json()["events"]
        already = any(e.get("kind") == "plan"
                      and e.get("events") == plan_events
                      for e in recorder.faults)
        if not already:  # a resume reloaded the ledger: no duplicate
            recorder.log_fault(
                "plan", name=fault_plan.name, events=plan_events,
                expected_alive=[float(v) for v in faults.expected_alive()],
                expected_link_up=[float(v)
                                  for v in faults.expected_link_up()])
    def compose_predicted(sched: Schedule):
        """The plan's composed ρ for the mixing that runs on ``sched``
        (its probabilities, or a budget swap's ``control_probs``; the α it
        executes): the fault plan's expected availability times the
        membership's occupancy, its link reliability, the staleness-damped
        α, staleness and local steps."""
        fault_alive = (np.asarray(faults.expected_alive(), np.float64)
                       if faults is not None else None)
        member_alive = (np.asarray(elastic_ctl.alive_mask(), np.float64)
                        if elastic_ctl is not None else None)
        if fault_alive is None:
            worker_alive = member_alive
        elif member_alive is None:
            worker_alive = fault_alive
        else:
            worker_alive = fault_alive * member_alive
        pred = compose_predicted_rho(
            sched.laplacians(),
            sched.probs if control_probs is None else control_probs,
            plan_alpha * stale_scale,
            overlap=config.overlap, wire_dtype=config.wire_dtype,
            worker_alive=worker_alive,
            link_up=(np.asarray(faults.expected_link_up(), np.float64)
                     if faults is not None else None),
            staleness=config.staleness, local_steps=config.local_steps)
        pred.update(steps_per_epoch=int(bpe),
                    tolerance=float(config.drift_tolerance),
                    patience=int(config.drift_patience),
                    plan_alpha=float(plan_alpha),
                    stale_alpha_scale=float(stale_scale),
                    executed_alpha=float(sched.alpha) * float(stale_scale))
        return pred

    def rebase_drift(alpha: float, sched: Schedule) -> Optional[Dict]:
        """A re-plan's α is the plan from here on: the monitor re-bases
        on it, and the journal's ``predicted`` with it (``None`` without a
        monitor).  ``sched``: the schedule that runs from here."""
        nonlocal plan_alpha, predicted, drift_monitor
        plan_alpha = float(alpha)
        if drift_monitor is None:
            return None
        predicted = compose_predicted(sched)
        drift_monitor = DriftMonitor(
            predicted["rho"], int(bpe), tolerance=config.drift_tolerance,
            patience=config.drift_patience)
        return predicted

    predicted = drift_monitor = None
    if elastic_ctl is not None and elastic_ctl.alpha is not None:
        # a resume replayed membership re-plans: their α is in force
        plan_alpha = float(elastic_ctl.alpha)
    if config.telemetry and config.communicator == "decen":
        # the spectral bound models the decen mixing only
        predicted = compose_predicted(schedule)
        drift_monitor = DriftMonitor(
            predicted["rho"], int(bpe), tolerance=config.drift_tolerance,
            patience=config.drift_patience)
    if start_epoch:
        recorder.log_event("resume", epoch=start_epoch,
                           config=_config_snapshot(config),
                           predicted=predicted or {})
    else:
        recorder.log_event("run_start", config=_config_snapshot(config),
                           predicted=predicted or {})
    if backend_decision is not None:
        recorder.log_event("backend", **backend_decision)
    ckpt_dir = f"{config.savePath}/{config.name}_ckpt"

    x_train = None if config.augment else torch.as_tensor(dataset.x_train,
                                                          device=dev)
    y_train = torch.as_tensor(dataset.y_train, device=dev).long()
    x_test = torch.as_tensor(dataset.x_test, device=dev)
    y_test = torch.as_tensor(dataset.y_test, device=dev).long()

    # rollback recovery: the snapshot is a copy on the device, since the
    # step updates the state in place
    recoveries_used = 0
    alpha_rederived = emergency_written = False
    snapshot = None
    history: List[Dict] = []

    class _BoundarySeam:
        """The run controller's handle into the loop (JAX
        ``loop.py:807-894``).  Every mutator is a value change: knob
        updates ride ``state.control``, a drift re-base swaps host floats,
        and config edits touch fields no step reads, so no program is
        rebuilt.  The controller's side (``serve.trainer.TrainerHarness``)
        decides what to apply; the seam knows how."""

        def __init__(self):
            self.epoch = 0
            self.bpe = int(bpe)
            self.recorder = recorder
            self.schedule = schedule0
            self.flattener = flattener
            # the test set as the loop placed it on the device
            self.x_test = x_test
            self.y_test = y_test

        @property
        def config(self):
            return config

        @property
        def state(self):
            return state

        def set_control(self, row_scale=None, alpha_scale=None,
                        local_every=None):
            """Rewrite the knobs' host mirror; the loop top re-primes
            ``state.control`` before the epoch runs."""
            if row_scale is not None:
                control_knobs["row_scale"] = np.asarray(row_scale,
                                                        np.float32)
            if alpha_scale is not None:
                control_knobs["alpha_scale"] = float(alpha_scale)
            if local_every is not None:
                control_knobs["local_every"] = max(int(local_every), 1)

        def update_config(self, **fields):
            """Replace config fields no step reads (drift tolerance and
            patience, the local-step and budget bookkeeping), validated by
            ``TrainConfig`` through ``dataclasses.replace``."""
            nonlocal config
            config = dataclasses.replace(config, **fields)

        def rebase_drift(self, alpha=None, probs=None):
            """Re-base the drift monitor's plan after a swap: the
            re-solved (α, p) is the plan from here on, as for a recovery's
            and a membership's re-plans.  Returns the new prediction (the
            current one without a monitor)."""
            nonlocal plan_alpha, predicted, drift_monitor, control_probs
            if alpha is not None:
                plan_alpha = float(alpha)
            if probs is not None:
                control_probs = np.asarray(probs, np.float64)
            if drift_monitor is not None:
                predicted = compose_predicted(schedule)
                drift_monitor = DriftMonitor(
                    predicted["rho"], int(bpe),
                    tolerance=config.drift_tolerance,
                    patience=config.drift_patience)
            return predicted

        def checkpoint(self):
            """Checkpoint the last completed epoch on demand (before a
            restart or a stop), as the cadence does; ``None`` before any
            epoch completed."""
            if self.epoch == 0:
                return None
            with annotate("matcha/checkpoint"):
                save_checkpoint(ckpt_dir, state, self.epoch - 1,
                                schedule=schedule0,
                                membership=membership_sidecar())
            recorder.log_event("checkpoint", epoch=self.epoch - 1,
                               path=ckpt_dir)
            return ckpt_dir

        def request_stop(self):
            """Stop before the next epoch: the loop leaves for the drain
            and the final flush."""
            nonlocal stop_requested
            stop_requested = True

    seam = _BoundarySeam() if boundary_hook is not None else None
    epoch = start_epoch
    while epoch < config.epochs:
        # chaos barrier (a no-op unless armed): the campaign's kill at the
        # epoch boundary fires here, before any of this epoch's host-state
        # transitions
        from ..chaos.taps import maybe_kill

        maybe_kill("epoch_boundary")
        if boundary_hook is not None:
            # the control plane's one entry: pending control documents and
            # the promotion cadence, then the knobs re-primed.  A rollback's
            # retry comes back here; the hook is idempotent per boundary
            seam.epoch = epoch
            boundary_hook(seam)
            if stop_requested:
                break
            state.control = fresh_control()
        if elastic_ctl is not None:
            # membership changes here and nowhere else; advance() is
            # idempotent per epoch, so a rollback's retry does not apply a
            # transition twice (its bootstrap is in the snapshot)
            trans = elastic_ctl.advance(epoch, schedule)
            if trans is not None:
                member_alive_np = trans.new_alive > 0
                if trans.joined.any() or trans.restored.any():
                    with annotate("matcha/membership_bootstrap"):
                        state = bootstrap_rows(state, trans.joined,
                                               trans.restored)
                new_pred = (rebase_drift(trans.alpha, schedule)
                            if trans.replanned else None)
                recorder.log_event(
                    "membership", epoch=epoch,
                    old_alive=[float(v) for v in trans.old_alive],
                    new_alive=[float(v) for v in trans.new_alive],
                    trigger=list(trans.trigger), alpha=float(trans.alpha),
                    rho=None if trans.rho is None else float(trans.rho),
                    alpha_scale=float(trans.alpha_scale),
                    replanned=bool(trans.replanned),
                    predicted=new_pred or {})
            state.membership = fresh_membership()
        # with the budget spent the copy could never be used: not taken
        snapshot = (_snapshot_state(state)
                    if recoveries_used < config.max_recoveries else None)
        ratio = effective_ratio(epoch)
        if ratio not in stages:
            stages[ratio] = make_stage(make_comm(ratio))
        step_fn, comm_timer = stages[ratio]
        # the profiler window: exactly one epoch, its one read inside
        tracing = (config.trace_dir is not None
                   and epoch == min(config.trace_epoch, config.epochs - 1))
        synchronize(dev)
        t0 = time.perf_counter()
        dev_sums: Dict[str, torch.Tensor] = {}
        host_sums: Dict[str, float] = {}
        count = 0
        with (trace(config.trace_dir, device=dev) if tracing
              else contextlib.nullcontext()):
            for xb, yb in _epoch_batches(loader, epoch, x_train, y_train,
                                         dev):
                if count == 0:
                    # once an epoch is enough: the batches share a shape
                    state, metrics = ledger_call(step_label, step_fn, state,
                                                 xb, yb)
                else:
                    state, metrics = step_fn(state, xb, yb)
                for k, v in metrics.items():
                    if isinstance(v, torch.Tensor):
                        dev_sums[k] = dev_sums[k] + v if k in dev_sums else v
                    else:
                        host_sums[k] = host_sums.get(k, 0.0) + v
                count += 1
            # the one deliberate per-epoch read: the step metrics, the
            # per-worker divergence detector (the telemetry left out:
            # scratch, not model state) and the telemetry accumulator
            keys = list(dev_sums)
            reads = [torch.stack([dev_sums[k] for k in keys])]
            if config.halt_on_divergence:
                reads.append(state_finite_rows(
                    state, config.num_workers).to(torch.float32))
            tel_at = sum(int(r.numel()) for r in reads)
            if tel_spec is not None:
                reads.append(telemetry_tensor(state.telemetry))
            read = torch.cat(reads).tolist()
            epoch_time = time.perf_counter() - t0
        epoch_metrics = {k: read[i] / count for i, k in enumerate(keys)}
        epoch_metrics.update({k: v / count for k, v in host_sums.items()})

        if config.halt_on_divergence:
            loss_bad = not np.isfinite(epoch_metrics["loss"])
            finite_rows = np.asarray(read[len(keys):tel_at]) > 0
            # only the workers a `dead` event quarantines are exempt (they
            # are healed at revival), and the vacant pool slots (nobody's
            # state until a (re)join bootstraps them)
            relevant = np.ones(config.num_workers, bool)
            if faults is not None:
                cursor = max(min(state.step - 1, faults.iterations - 1), 0)
                relevant = faults.dead_alive[cursor] > 0
            if member_alive_np is not None:
                relevant = relevant & member_alive_np
            if loss_bad or bool(np.any(~finite_rows & relevant)):
                what = ("training loss " + str(epoch_metrics["loss"])
                        if loss_bad else "train state (params/BN stats/"
                        "momentum/comm carry)")
                if snapshot is not None \
                        and recoveries_used < config.max_recoveries:
                    # recover instead of abort: the last good state, the
                    # learning rate backed off, α re-derived once
                    recoveries_used += 1
                    _restore_snapshot(state, snapshot)
                    snapshot = None
                    if config.save and not emergency_written and epoch > 0:
                        path = f"{config.savePath}/{config.name}_emergency"
                        with annotate("matcha/checkpoint"):
                            save_checkpoint(path, state, epoch - 1,
                                            schedule=schedule0,
                                            membership=membership_sidecar())
                        emergency_written = True
                        recorder.log_fault("emergency_checkpoint",
                                           epoch=epoch, path=path)
                    if faults is not None:
                        # the chaos happened: the retried window must not
                        # fire its NaN injections again
                        faults = faults.without_nan_in(
                            epoch * bpe,
                            min((epoch + 1) * bpe, faults.iterations))
                    lr_scale *= config.recovery_lr_backoff
                    if not alpha_rederived:
                        alpha_rederived = True
                        schedule = _rederive_alpha(schedule, faults,
                                                   elastic_ctl, recorder,
                                                   epoch, rebase_drift)
                    rebuild_programs()
                    if tel_spec is not None:
                        # the retry counts from zero, as it does in JAX
                        # from the snapshot's fresh accumulator
                        state.telemetry = fresh_telemetry()
                    recorder.log_fault("rollback", epoch=epoch, reason=what,
                                       lr_scale=lr_scale,
                                       attempt=recoveries_used)
                    continue  # retry this epoch from the last good state
                # keep the curve leading into the blow-up
                recorder.add_epoch(
                    epoch_time=epoch_time, comp_time=epoch_time,
                    comm_time=0.0, train_acc=epoch_metrics["accuracy"],
                    train_loss=epoch_metrics["loss"],
                    test_acc=np.zeros(config.num_workers),
                    disagreement=epoch_metrics["disagreement"])
                if config.save:
                    with annotate("matcha/recorder_flush"):
                        recorder.save()
                budget = (f", {recoveries_used}/{config.max_recoveries} "
                          f"recoveries exhausted"
                          if config.max_recoveries else "")
                raise TrainingDiverged(
                    f"non-finite {what} in epoch {epoch} (lr={config.lr}, "
                    f"communicator={config.communicator}{budget})")

        comm_time = comm_encode_time = 0.0
        if comm_timer is not None:
            window = run_flags[epoch * bpe:(epoch + 1) * bpe]
            with annotate("matcha/comm_split_timer"):
                split = comm_timer(state, window)
            comm_time = min(split["comm_time"], epoch_time)
            comm_encode_time = min(split["comm_encode_time"], comm_time)

        test_loss = test_acc = np.zeros(config.num_workers)
        eval_alive = None
        if config.eval_every and (epoch + 1) % config.eval_every == 0:
            eval_batch = config.eval_batch or max(16, 1024 // config.num_workers)
            test_loss, test_acc = _evaluate_in_batches(
                evaluate, x_test, y_test, eval_batch, ledger=ledger_call)
            if faults is not None or member_alive_np is not None:
                # a plan-dead worker's or a vacant slot's state may be
                # garbage: its entries become explicit NaN gaps
                if faults is not None:
                    cursor = max(min(state.step - 1, faults.iterations - 1),
                                 0)
                    eval_alive = faults.dead_alive[cursor] > 0
                    if member_alive_np is not None:
                        eval_alive = eval_alive & member_alive_np
                else:
                    eval_alive = member_alive_np
                test_loss = np.where(eval_alive, test_loss, np.nan)
                test_acc = np.where(eval_alive, test_acc, np.nan)

        recorder.add_epoch(
            epoch_time=epoch_time,
            comp_time=epoch_time - comm_time,
            comm_time=comm_time,
            train_acc=epoch_metrics["accuracy"],
            train_loss=epoch_metrics["loss"],
            test_acc=test_acc,
            disagreement=epoch_metrics["disagreement"],
        )
        history.append({
            "epoch": epoch,
            **epoch_metrics,
            "test_acc_mean": _masked_mean(test_acc, eval_alive),
            "test_loss_mean": _masked_mean(test_loss, eval_alive),
            "epoch_time": epoch_time,
            "comm_time": comm_time,
            "comm_encode_time": comm_encode_time,
            "comm_exchange_time": comm_time - comm_encode_time,
        })
        if faults is not None and epoch_metrics.get("healed", 0.0) > 0:
            recorder.log_fault(
                "healed", epoch=epoch, rows=epoch_metrics["healed"] * bpe,
                mean_alive=epoch_metrics.get("alive_workers",
                                             float(config.num_workers)))

        if tel_spec is not None:
            tel = telemetry_flush(state.telemetry, read[tel_at:])
            state.telemetry = fresh_telemetry()
            # the per-worker stats feed the heartbeat, not the event
            worker_stats = {
                "worker_participation": tel.pop("worker_participation"),
                "worker_disagreement": tel.pop("worker_disagreement")}
            recorder.log_event("telemetry", epoch=epoch, **tel)
            if drift_monitor is not None:
                drift = drift_monitor.observe(epoch, tel["disagreement_mean"])
                if drift is not None:
                    recorder.log_event("drift", **drift)
            if health_emitter is not None:
                # step is host arithmetic; the peak is the cost ledger's
                # largest program footprint
                peak = (max((e.get("peak_bytes") or 0.0
                             for e in cost_ledger.programs), default=0.0)
                        if cost_ledger is not None else 0.0)
                hb = health_emitter.beat(
                    epoch=epoch, step=(epoch + 1) * bpe, steps=tel["steps"],
                    epoch_time=epoch_time, comm_time=comm_time,
                    workers=member_workers(worker_stats),
                    peak_bytes=peak or None)
                recorder.log_event("heartbeat", **hb)
                for a in anomaly_detector.observe(hb):
                    recorder.log_event("anomaly", **a)
                for ev in health_emitter.drain_recovery():
                    # the heartbeat sink degraded or came back: the run
                    # journal is the record a watcher reads then
                    recorder.log_event("recovery", scope="io",
                                       action=ev["action"],
                                       reason=ev["reason"], sink=ev["sink"],
                                       epoch=epoch)

        watch_retrace(step_fn)

        if config.save and recorder.epochs_recorded % 10 == 0:
            with annotate("matcha/recorder_flush"):
                recorder.save()
        if config.checkpoint_every \
                and (epoch + 1) % config.checkpoint_every == 0:
            t0 = time.perf_counter()
            with annotate("matcha/checkpoint"):
                nbytes = save_checkpoint(ckpt_dir, state, epoch,
                                         schedule=schedule0,
                                         membership=membership_sidecar())
            recorder.log_event("checkpoint", epoch=epoch, path=ckpt_dir,
                               seconds=time.perf_counter() - t0,
                               bytes=nbytes)
        epoch += 1
    snapshot = None
    if config.overlap == "1step":
        # the returned parameters are the fully mixed state; inside the
        # run (and in its checkpoints) the pending deltas stay in flight
        state = ledger_call("drain", _drain_mix_pending, state,
                            communicator, flattener)
    if config.save:
        with annotate("matcha/recorder_flush"):
            recorder.save()
    return TrainResult(state, recorder, schedule, history)


def _rederive_alpha(schedule: Schedule, faults, elastic_ctl, recorder,
                    epoch: int, rebase=None) -> Schedule:
    """A recovery's α re-derivation (JAX ``loop.py:1052-1122``): for the
    fault plan's expected availability and link reliability, composed with
    the membership's occupancy (``resolve_degraded_alpha``), else for the
    live set (``refold_for``), else for the schedule's own probabilities.
    Where the new α differs from the executed one (the schedule's α times
    the membership's scale), the schedule is rebound to it, the
    controller re-bases to scale 1 against it, ``rebase(new_alpha,
    schedule)`` re-bases the drift monitor (returning the new prediction,
    or ``None`` without a monitor), and an ``alpha_rederived`` fault is
    journaled with that prediction."""
    member_mask = (elastic_ctl.alive_mask() if elastic_ctl is not None
                   else None)
    if faults is not None:
        new_alpha, new_rho, _ = resolve_degraded_alpha(
            schedule, faults, worker_alive=member_mask)
    elif member_mask is not None:
        new_alpha, new_rho, _ = schedule.refold_for(member_mask)
    else:
        new_alpha, new_rho = solve_mixing_weight(schedule.laplacians(),
                                                 schedule.probs)
    executed = float(schedule.alpha) * (elastic_ctl.alpha_scale
                                        if elastic_ctl is not None else 1.0)
    if abs(new_alpha - executed) <= 1e-9:
        return schedule
    schedule = dataclasses.replace(schedule, alpha=float(new_alpha))
    if elastic_ctl is not None:
        # the composed solve subsumes the membership's re-fold
        elastic_ctl.alpha = float(new_alpha)
        elastic_ctl.rho = float(new_rho)
        elastic_ctl.alpha_scale = 1.0
    predicted = (rebase(float(new_alpha), schedule) if rebase is not None
                 else None)
    recorder.log_fault("alpha_rederived", epoch=epoch, old=executed,
                       new=float(new_alpha), rho=float(new_rho),
                       predicted=predicted)
    return schedule


def _clone_tree(tree):
    """A copy of every tensor of a carry-like value (a tensor, or a
    dict/tuple/list of them); anything else as it is."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_clone_tree(v) for v in tree)
    return tree


def _snapshot_state(state: TrainState) -> Dict:
    """A copy on the state's device of everything an epoch changes: the
    parameters, buffers, the optimizer's per-parameter state (momentum),
    the carry, the pending deltas and their ages, and the cursor.  The
    step updates in place, so a reference would not do."""
    model, opt = state.model, state.optimizer
    return {
        "params": [p.detach().clone() for p in model.parameters()],
        "buffers": [b.clone() for b in model.buffers()],
        "optimizer": [_clone_tree(dict(opt.state[p])) if p in opt.state
                      else None for p in model.parameters()],
        "comm_carry": _clone_tree(state.comm_carry),
        "mix_pending": _clone_tree(state.mix_pending),
        "mix_ages": _clone_tree(state.mix_ages),
        "step": int(state.step),
    }


def _restore_snapshot(state: TrainState, snapshot: Dict) -> TrainState:
    """Put a snapshot back into ``state`` (in place; the snapshot's tensors
    are consumed)."""
    model, opt = state.model, state.optimizer
    with torch.no_grad():
        for p, saved in zip(model.parameters(), snapshot["params"]):
            p.copy_(saved)
        for b, saved in zip(model.buffers(), snapshot["buffers"]):
            b.copy_(saved)
    for p, saved in zip(model.parameters(), snapshot["optimizer"]):
        if saved is None:
            opt.state.pop(p, None)
        else:
            opt.state[p] = saved
    state.comm_carry = snapshot["comm_carry"]
    state.mix_pending = snapshot["mix_pending"]
    state.mix_ages = snapshot["mix_ages"]
    state.step = snapshot["step"]
    return state


def _masked_mean(values, alive) -> float:
    """Mean of the entries of a per-worker evaluation series outside the
    quarantine (its NaN gaps)."""
    if alive is not None and alive.any():
        values = values[alive]
    return float(np.mean(values))


def _stale_scale(config: TrainConfig, schedule: Schedule) -> float:
    """The damping of the executed α under a ``staleness > 1`` pipeline
    (``plan.stale_alpha_rescale``): the MATCHA α is solved for the eager
    dynamics and overdrives a k-deep one.  Only decen is modelled; every
    other run executes its α undamped."""
    if config.staleness > 1 and config.communicator == "decen":
        from ..plan import stale_alpha_rescale

        scale, _ = stale_alpha_rescale(
            schedule.laplacians(), schedule.probs, float(schedule.alpha),
            staleness=config.staleness, local_steps=config.local_steps)
        return float(scale)
    return 1.0


def _apply_pending(state: TrainState, communicator, flattener) -> None:
    """Add every in-flight delta to the parameters: the one-step delta, or
    the ``[N, K, D]`` ring oldest-first, slot ``(cursor + i) mod K`` for
    i = 0..K−1 (``run_pipelined``'s drain order)."""
    pend = state.mix_pending
    params = state.params
    with torch.no_grad():
        flat = flattener.flatten(params)
        if pend.ndim == 2:
            flat = communicator.apply_mix(flat, pend)
        else:
            k = pend.shape[1]
            for i in range(k):
                flat = communicator.apply_mix(flat,
                                              pend[:, (state.step + i) % k])
        flattener.unflatten_into(flat, params)


def _drain_mix_pending(state: TrainState, communicator,
                       flattener) -> TrainState:
    """Apply the in-flight delta(s) to the parameters and empty the
    pipeline (JAX ``loop.py:1281-1316``)."""
    _apply_pending(state, communicator, flattener)
    state.mix_pending.zero_()
    if isinstance(state.mix_ages, torch.Tensor):
        state.mix_ages.fill_(-1)
    return state


def _reconcile_mix_pending(state: TrainState, overlap: str, communicator,
                           flattener, num_workers: int,
                           staleness: int = 1) -> TrainState:
    """Align a restored state's in-flight delta(s) with this run's
    ``overlap``/``staleness`` (JAX ``loop.py:1352``).

    * An eager checkpoint (``()``): prime a fresh zero pipeline, or stay
      eager.
    * Same depth: go on; the ring's ages, never checkpointed, are rebuilt
      from the cursor (slot s holds the delta issued at the last step
      t' < cursor with t' ≡ s mod K).
    * Resuming eagerly, or at another depth: drain every saved delta into
      the parameters, oldest-first (slot ``(cursor + i) mod K'``), then
      prime a fresh pipeline at the new depth.  Slots are the cursor mod
      K, so re-basing a ring in place would mis-age every delta."""
    dev = next(state.model.parameters()).device
    pend = state.mix_pending
    if isinstance(pend, torch.Tensor):
        saved_k = int(pend.shape[1]) if pend.ndim == 3 else 1
        if overlap == "1step" and saved_k == staleness:
            state.mix_ages = ()
            if staleness > 1:
                cursor = int(state.step)
                ages = np.full((num_workers, staleness), -1, np.int64)
                for s in range(staleness):
                    issued = cursor - 1 - ((cursor - 1 - s) % staleness)
                    if issued >= 0:
                        ages[:, s] = cursor - issued
                state.mix_ages = torch.as_tensor(ages, dtype=torch.int32,
                                                 device=dev)
            return state
        _apply_pending(state, communicator, flattener)
    state.mix_pending, state.mix_ages = fresh_mix_pending(
        overlap, staleness, num_workers, flattener.dim, dev)
    return state


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


def _make_comm_timer(communicator, flattener, dev: torch.device, ledger,
                     sample_steps: int = 32):
    """Gossip-only chain, timed on the host clock after a synchronize.

    Scaling to the full epoch uses the *marginal* per-step cost: two window
    lengths (k and 2k) are timed and the difference isolates the per-step
    rate from the fixed launch overhead, paid once per chain.  Estimate:
    ``t(n) ≈ t_2k + marginal·(n−2k)``; an epoch of at most 2k steps is
    timed whole.  Every timed chain runs once to warm up first.

    A communicator with an ``encode_probe`` (CHOCO) also has its compress
    path timed alone, chained on CHOCO's own ``x̂`` update, as the
    reference's encode-vs-sendrecv split (communicator.py:184-196).
    Returns ``{"comm_time", "comm_encode_time"}`` (encode 0.0 for an
    uncompressed exchange).  ``ledger(label, fn, *args)`` runs each
    warm-up, so the cost ledger measures each chain's first call
    (``gossip_chain``)."""

    def chain(state, flags):
        flat = flattener.flatten(state.params)
        out, _ = communicator.run(flat, flags, state.comm_carry)
        return out

    def encode_chain(state, flags):
        flat = flattener.flatten(state.params)
        probe = torch.zeros_like(flat)
        for _ in range(flags.shape[0]):
            probe = communicator.encode_probe(flat, probe)
        return probe

    def extrapolate(fn, state, flags_window) -> float:
        def timed(m: int) -> float:
            flags = torch.as_tensor(flags_window[:m], dtype=torch.float32,
                                    device=communicator.flags_device(dev))
            ledger("gossip_chain", fn, state, flags)  # warm-up
            synchronize(dev)
            t0 = time.perf_counter()
            fn(state, flags)
            synchronize(dev)
            return time.perf_counter() - t0

        n = len(flags_window)
        k = min(sample_steps, max(n // 2, 1))
        if n <= 2 * k:
            return timed(n)
        t1, t2 = timed(k), timed(2 * k)
        return t2 + max(t2 - t1, 0.0) / k * (n - 2 * k)

    def timer(state, flags_window) -> Dict[str, float]:
        out = {"comm_time": extrapolate(chain, state, flags_window),
               "comm_encode_time": 0.0}
        if communicator.encode_probe is not None:
            out["comm_encode_time"] = extrapolate(encode_chain, state,
                                                  flags_window)
        return out

    return timer


def _evaluate_in_batches(evaluate, x_test: torch.Tensor, y_test: torch.Tensor,
                         batch: int, ledger):
    """Every worker on the whole test set, ``batch`` examples per call;
    weighted sums stay on the device and are read once.  ``ledger(label,
    fn, *args)`` runs each call (``evaluate``: the batch and the tail are
    two programs)."""
    loss_sum = acc_sum = None
    for i in range(0, len(x_test), batch):
        xl, yl = x_test[i:i + batch], y_test[i:i + batch]
        loss, acc = ledger("evaluate", evaluate, xl, yl)
        w = float(len(yl))
        loss_sum = loss * w if loss_sum is None else loss_sum + loss * w
        acc_sum = acc * w if acc_sum is None else acc_sum + acc * w
    read = (torch.stack([loss_sum, acc_sum]) / float(len(x_test))).cpu().numpy()
    return read[0].astype(np.float64), read[1].astype(np.float64)


def _config_snapshot(config: TrainConfig) -> Dict:
    """JSON-safe view of the config for the journal's ``run_start`` and
    ``resume`` events (the ExpDescription's structured twin), as the JAX
    package writes it: non-scalar fields are stringified, not dropped."""
    out: Dict = {}
    for field in dataclasses.fields(config):
        v = getattr(config, field.name)
        if isinstance(v, (str, int, float, bool, type(None))):
            out[field.name] = v
        elif isinstance(v, (list, tuple)) and all(
                isinstance(x, (str, int, float, bool)) for x in v):
            out[field.name] = list(v)
        else:
            out[field.name] = str(v)
    return out
