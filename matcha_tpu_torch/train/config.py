"""Training configuration.

Port of ``matcha_tpu/train/config.py``: ``TrainConfig`` with the same fields
and the same validation.  Fields of features the port does not have yet
raise ``NotImplementedError`` when set to anything but their default (see
``_UNPORTED``); ``ROADMAP.md`` lists the order in which they land.
``gossip_backend`` takes ``auto`` (the default, as in the JAX package) and
the port's backends, ``perm``, ``dense``, ``fused``, ``gather``, ``skip``
and ``shard_map`` (the workers folded across a mesh of ``devices``
cards), and ``communicator`` takes
``decen``, ``choco``, ``centralized`` and ``none``.  A plan artifact
(``plan``), the measured input of ``auto``'s gate
(``gossip_measured_vs_ceiling``, ``gossip_measured_source``), a fault
plan, rollback recovery, a membership trace or the live membership source
(``membership_live``, a heartbeat directory), and the observability plane
(``telemetry``, ``health``, the drift monitor's ``drift_tolerance`` and
``drift_patience``) run, with the JAX package's defaults: telemetry and
health on; so does the profiler window (``trace_dir``, ``trace_epoch``:
one epoch under ``torch.profiler``).  ``devices`` is the mesh's size, as
in the JAX package: ``None`` means every visible card (one card when
``train()`` is given a card by its index, ``"cuda:0"``, or the CPU), and
every other field runs on a mesh as on one card.  Still refused
everywhere: ``scan_chunk``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from ..ops import COMPRESSOR_NAMES

__all__ = ["TrainConfig"]


@dataclasses.dataclass
class TrainConfig:
    # experiment identity (reference: --name/--description)
    name: str = "experiment"
    description: str = "matcha_tpu_torch run"

    # model / data (reference: --model, --dataset, --bs)
    model: str = "resnet20"
    dataset: str = "synthetic"
    batch_size: int = 32  # per worker
    non_iid: bool = False
    augment: bool = False
    datasetRoot: Optional[str] = None  # .npz path for real datasets
    # extra kwargs for the synthetic dataset functions (num_train, ...)
    dataset_kwargs: Optional[dict] = None

    # optimization (reference: --lr/--momentum/--epoch/--warmup/--nesterov)
    lr: float = 0.8
    momentum: float = 0.9
    weight_decay: float = 5e-4
    nesterov: bool = True
    epochs: int = 200
    warmup: bool = True
    warmup_epochs: int = 5
    base_lr: float = 0.1  # warmup start
    decay_epochs: Tuple[int, ...] = (100, 150)
    decay_factor: float = 0.1

    # topology / schedule (reference: --graphid/--budget/--matcha)
    num_workers: int = 8
    graphid: Optional[int] = 0  # zoo id; None -> use topology generator
    topology: str = "ring"  # generator kind when graphid is None
    matcha: bool = True
    budget: float = 0.5
    fixed_mode: str = "all"  # D-PSGD flag mode: all|bernoulli|alternating
    seed: int = 9001
    # a plan_torch.py artifact: train() resolves its graph, budget and seed
    # into the config at entry (plan.apply_plan)
    plan: Optional[str] = None

    # communicator
    communicator: str = "decen"  # decen|choco|centralized|none
    compress_ratio: float = 0.9
    compressor: str = "top_k"
    consensus_lr: float = 0.1
    compress_warmup_epochs: int = 0
    # gossip backend: auto (plan.cost.choose_gossip_backend picks perm or
    # dense), perm (the permutation-form CUDA kernel), dense (one matrix
    # product per step), fused (dense steps; chains through the fused
    # W-stack CUDA kernel), gather (the oracle) or skip (the oracle,
    # inactive matchings skipped on the host); shard_map (the workers
    # folded across a mesh, which auto picks there)
    gossip_backend: str = "auto"
    gossip_block_d: Optional[int] = None  # perm/fused kernel tile cap
    gossip_w_window: int = 1  # perm/fused steps per window (exact)
    # the auto gate's measured input: the dense formulation's
    # measured-vs-ceiling ratio, given as a number or read from a file
    # (a journal's roofline records, a {"record": ...} capture or a raw
    # roofline report: plan.cost.load_measured_vs_ceiling); the number
    # wins when both are set, and with neither auto picks dense below
    # 4096 workers
    gossip_measured_vs_ceiling: Optional[float] = None
    gossip_measured_source: Optional[str] = None
    # the pipelined schedule: "1step" consumes each step's exchange at the
    # next step; staleness K ≥ 2 (with "1step") ages the deltas through a
    # K-slot ring; local_steps L runs the exchange every L-th step only
    overlap: str = "off"  # off|1step
    staleness: int = 1
    local_steps: int = 1
    # dtype of the exchanged values at the gossip boundary; parameters and
    # the delta accumulation stay f32
    wire_dtype: str = "f32"  # f32|bf16

    # logging / checkpointing
    save: bool = False
    savePath: str = "runs"
    checkpoint_every: int = 0  # epochs; 0 = disabled
    resume: Optional[str] = None  # checkpoint dir to resume from
    eval_every: int = 1
    # test-set slice per evaluation call, per worker; 0 = auto-size
    eval_batch: int = 0

    # resilience
    fault_plan: Optional[object] = None
    max_recoveries: int = 0
    recovery_lr_backoff: float = 0.5

    # elastic membership
    membership_trace: Optional[object] = None
    membership_hysteresis: int = 0
    membership_bootstrap: str = "mean"
    membership_live: Optional[str] = None
    membership_deadline: float = 60.0

    # observability
    telemetry: bool = True
    health: bool = True
    drift_tolerance: float = 0.25
    drift_patience: int = 2
    trace_dir: Optional[str] = None
    trace_epoch: int = 1
    # initial-consensus sync (reference sync_allreduce)
    sync_init: bool = True
    # execute the schedule with this α instead of the solved one
    alpha_override: Optional[float] = None

    # execution
    remat: bool = False
    grad_chunk: Optional[int] = None
    scan_epoch: bool = True  # the port's step loop is a plain python loop
    scan_chunk: Optional[int] = None
    devices: Optional[int] = None  # mesh size; None → every visible card
    measure_comm_split: bool = True  # comm-split timer (one gossip chain/epoch)
    halt_on_divergence: bool = True  # raise TrainingDiverged on NaN

    def __post_init__(self):
        if self.communicator not in ("decen", "choco", "centralized", "none"):
            raise ValueError(f"bad communicator '{self.communicator}'")
        if self.compressor not in COMPRESSOR_NAMES:
            raise ValueError(f"bad compressor '{self.compressor}'; "
                             f"have {sorted(COMPRESSOR_NAMES)}")
        if self.num_workers < 2:
            raise ValueError("need at least 2 virtual workers")
        if not 0 <= self.budget <= 1:
            raise ValueError("budget must be in [0, 1]")
        if self.devices is not None and self.devices < 1:
            raise ValueError(f"devices must be >= 1, got {self.devices}")
        if self.scan_chunk is not None and self.scan_chunk < 1:
            # a negative value would silently degenerate to the unbounded
            # whole-epoch stack via the tail path — the opposite of what
            # the knob promises
            raise ValueError("scan_chunk must be None or >= 1")
        if self.grad_chunk is not None:
            if self.grad_chunk < 1:
                raise ValueError("grad_chunk must be None or >= 1")
            if self.num_workers % self.grad_chunk:
                raise ValueError(
                    f"grad_chunk {self.grad_chunk} must divide "
                    f"num_workers {self.num_workers}")
        if self.overlap not in ("off", "1step"):
            raise ValueError(
                f"overlap must be 'off' or '1step', got {self.overlap!r}")
        if self.staleness < 1:
            raise ValueError(f"staleness must be >= 1, got {self.staleness}")
        if self.staleness > 1 and self.overlap != "1step":
            raise ValueError(
                "staleness > 1 needs overlap='1step': the eager schedule "
                "has no pending ring to age mixing deltas through")
        if self.local_steps < 1:
            raise ValueError(
                f"local_steps must be >= 1, got {self.local_steps}")
        if self.wire_dtype not in ("f32", "bf16"):
            raise ValueError(
                f"wire_dtype must be 'f32' or 'bf16', got {self.wire_dtype!r}")
        if self.gossip_measured_vs_ceiling is not None \
                and not self.gossip_measured_vs_ceiling >= 0:
            raise ValueError(
                f"gossip_measured_vs_ceiling must be >= 0 (a "
                f"measured/ceiling ratio), got "
                f"{self.gossip_measured_vs_ceiling}")
        if self.compress_warmup_epochs < 0:
            raise ValueError("compress_warmup_epochs must be >= 0")
        if self.compress_warmup_epochs and self.communicator != "choco":
            raise ValueError(
                "compress_warmup_epochs only applies to the choco "
                "communicator (the only compressed one)")
        if self.max_recoveries < 0:
            raise ValueError("max_recoveries must be >= 0")
        if self.trace_epoch < 0:
            raise ValueError(
                f"trace_epoch must be >= 0, got {self.trace_epoch}")
        if not self.drift_tolerance > 0:
            raise ValueError(
                f"drift_tolerance must be > 0, got {self.drift_tolerance}")
        if self.drift_patience < 1:
            raise ValueError(
                f"drift_patience must be >= 1, got {self.drift_patience}")
        if self.alpha_override is not None and not self.alpha_override > 0:
            raise ValueError(
                f"alpha_override must be > 0, got {self.alpha_override}")
        if self.max_recoveries and not self.halt_on_divergence:
            raise ValueError(
                "max_recoveries needs halt_on_divergence=True — recovery is "
                "what the detector triggers; with detection off there is "
                "nothing to roll back from")
        if not 0.0 < self.recovery_lr_backoff <= 1.0:
            raise ValueError(
                f"recovery_lr_backoff must be in (0, 1], got "
                f"{self.recovery_lr_backoff}")
        if self.fault_plan is not None and self.communicator == "none":
            raise ValueError(
                "fault_plan needs a communicator: without gossip there are "
                "no links to fail and no peers to heal a worker from")
        if self.membership_hysteresis < 0:
            raise ValueError(
                f"membership_hysteresis must be >= 0, got "
                f"{self.membership_hysteresis}")
        if self.membership_bootstrap not in ("mean", "restore"):
            raise ValueError(
                f"membership_bootstrap must be 'mean' or 'restore', got "
                f"{self.membership_bootstrap!r}")
        if self.membership_trace is not None and self.communicator == "none":
            raise ValueError(
                "membership_trace needs a communicator: a joining worker "
                "bootstraps from its peers' consensus, which requires a "
                "mixing process to rejoin")
        if self.membership_live is not None:
            if self.membership_trace is not None:
                raise ValueError(
                    "membership_live and membership_trace are mutually "
                    "exclusive — one membership source per run (pass a "
                    "LiveMembershipSource as membership_trace for a "
                    "pre-built live source)")
            if self.communicator == "none":
                raise ValueError(
                    "membership_live needs a communicator: a joining worker "
                    "bootstraps from its peers' consensus, which requires a "
                    "mixing process to rejoin")
        if not self.membership_deadline > 0:
            raise ValueError(
                f"membership_deadline must be > 0, got "
                f"{self.membership_deadline}")
        unported = [f for f, default in _UNPORTED.items()
                    if getattr(self, f) != default]
        if unported:
            raise NotImplementedError(
                f"TrainConfig field(s) {unported} select features the "
                f"PyTorch port does not have yet (ROADMAP.md); leave them at "
                f"their defaults")


# fields of features not ported yet, with the only value the port accepts
_UNPORTED = {
    "scan_chunk": None,
}
