#!/usr/bin/env python
"""Command line of the PyTorch/CUDA port — the twin of ``train_tpu.py``.

Takes the flags the port has so far, with ``train_tpu.py``'s names and
defaults, plus ``--device`` (default ``cuda``; ``cpu`` runs the plain
PyTorch path).  Prints one JSON line per epoch.

MATCHA at budget 0.5 on the paper's 16-node ER graph (zoo id 4), ResNet-20,
gossip mixed by the perm kernel::

    python train_torch.py --model resnet20 --dataset synthetic_image \\
        --graphid 4 --numworkers 16 --budget 0.5 --bs 32 --epoch 10 \\
        --backend perm --wire-dtype f32

``--backend auto`` (the default, as in ``train_tpu.py``) lets the
planner's gate choose: ``perm`` from 4096 workers or when the dense form's
measured-vs-ceiling ratio (``--gossip-measured-ratio R``, or read from a
file by ``--gossip-measured-source FILE``) reaches 0.85, else ``dense``;
the decision is journaled as a ``backend`` event.  ``--plan plan.json``
(written by ``plan_torch.py sweep``) sets the graph, worker count, budget
and seed the planner chose::

    python plan_torch.py sweep --graphid 4 --budgets 0.25,0.5,0.75 \
        --out plan.json
    python train_torch.py --plan plan.json --model resnet20 \
        --dataset synthetic_image --bs 32 --epoch 10 --save

``--backend fused`` mixes each step with one dense product ``W_t @ x`` and
runs the comm-split timer's chains through the fused W-stack kernel;
``--backend dense`` is the dense product alone; ``--backend skip`` is the
gather oracle with inactive matchings skipped on the host.

On the card a run folds the workers card-major across every visible card
(``CUDA_VISIBLE_DEVICES`` picks the cards; one card, or a card count that
does not divide ``--numworkers``, is no mesh).  ``--backend shard_map``
(``auto``'s choice on a mesh) mixes the folded state in place: on-card
edges are row gathers, cross-card edges move a neighbour card's block;
``perm``, ``dense``, ``fused`` and ``gather`` gather the state onto the
first card for each mix (``shard_map`` on one card raises).  A mesh runs
every communicator and every option a one-card run takes: the pipeline
(``--overlap``, ``--staleness``), a fault plan and recovery, membership,
telemetry and health::

    CUDA_VISIBLE_DEVICES=0,1,2,3 python train_torch.py --model resnet20 \
        --dataset synthetic_image --graphid 4 --numworkers 16 \
        --backend shard_map --epoch 10
``--communicator centralized`` averages all workers every step (the
AllReduce baseline), ``--communicator none`` never mixes.

CHOCO-SGD (``--compress``, or ``--communicator choco``) gossips compressed
differences; ``--ratio 0.9`` keeps the top 10 % by magnitude, and
``--compress-warmup-epochs`` ramps the ratio up from 0::

    python train_torch.py --model resnet20 --dataset synthetic_image \
        --graphid -1 --topology erdos_renyi --numworkers 64 --budget 0.5 \
        --compress --ratio 0.9 --compressor top_k --consensus-lr 0.1

``--model`` takes ``resnet<depth>``, ``res``, ``VGG``/``vgg<depth>``,
``wrn``/``wrn-<depth>-<k>`` and ``mlp``; ``--remat`` recomputes each block
in the backward pass, and ``--grad-chunk C`` runs the forward/backward in
slabs of C workers (both trade time for memory, not the result).

``--save`` writes the Recorder's CSVs and the run journal
(``events.jsonl``) under ``{savePath}/{name}_{model}/``;
``--checkpoint-every K`` writes a checkpoint to ``{savePath}/{name}_ckpt``
every K epochs, and ``--resume DIR`` goes on from the newest one in DIR::

    python train_torch.py --model mlp --dataset digits --graphid 5 \
        --numworkers 8 --epoch 4 --save --checkpoint-every 1
    python train_torch.py --model mlp --dataset digits --graphid 5 \
        --numworkers 8 --epoch 8 --save --resume runs/experiment_ckpt

The pipelined schedule: ``--overlap 1step`` consumes each step's exchange
at the next step, ``--staleness K`` (with ``--overlap 1step``) ages the
exchanges through a K-slot ring, and ``--local-steps L`` exchanges on
every L-th step only::

    python train_torch.py --model resnet20 --dataset synthetic_image \
        --graphid 4 --numworkers 16 --overlap 1step --staleness 2 \
        --local-steps 2

Resilience and elastic membership: ``--fault-plan FILE`` injects a
declarative fault plan (dead workers, stragglers, NaN emitters, link
outages) and heals through it, ``--max-recoveries R`` rolls a diverged
epoch back (``--recovery-lr-backoff``), and ``--membership-trace FILE``
replays join/leave/rejoin events at epoch boundaries
(``--membership-hysteresis``, ``--membership-bootstrap``)::

    python train_torch.py --model mlp --dataset synthetic --graphid 5 \
        --numworkers 8 --epoch 3 --fault-plan plan.json --max-recoveries 1 \
        --device cpu
    python train_torch.py --model mlp --dataset synthetic --graphid 5 \
        --numworkers 8 --epoch 3 --membership-trace trace.json --device cpu

Observability is on, as in ``train_tpu.py``: each epoch journals its
``telemetry`` (and, for a decen run, a ``drift`` event when the measured
contraction leaves the plan's band: ``--drift-tolerance``,
``--drift-patience``); with ``--save`` each epoch also appends a heartbeat
under ``{savePath}/{name}_{model}/health/`` and journals the anomaly
detectors' findings.  ``--no-telemetry`` and ``--no-health`` switch them
off.  ``--membership-live DIR`` takes membership from a heartbeat
directory instead of a trace: a member silent for
``--membership-deadline`` seconds leaves, a returning one rejoins::

    python train_torch.py --model mlp --dataset synthetic --graphid 5 \
        --numworkers 8 --epoch 3 --save --membership-live runs/fleet/health \
        --device cpu

``--trace-dir DIR`` captures one epoch (``--trace-epoch``, default 1,
clamped to the run) in a ``torch.profiler`` window; ``obs_torch.py
profile DIR`` attributes its kernel rows to the step's phases::

    python train_torch.py --epoch 3 --save --trace-dir runs/trace

``digits`` and ``photo_patches`` need scikit-learn and PIL (and read
photographs shipped with matplotlib and pygame).
"""

from __future__ import annotations

import argparse
import json

from matcha_tpu_torch.ops import COMPRESSOR_NAMES
from matcha_tpu_torch.train import TrainConfig, train


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default="resnet20",
                   help="resnet<depth>, res, VGG, vgg<depth>, wrn, "
                        "wrn-<depth>-<k> or mlp")
    p.add_argument("--dataset", default="synthetic",
                   choices=["synthetic", "synthetic_image", "digits",
                            "photo_patches"])
    p.add_argument("--numworkers", type=int, default=8)
    p.add_argument("--graphid", type=int, default=0,
                   help="zoo graph id (0-5); -1 uses --topology")
    p.add_argument("--topology", default="ring",
                   help="generator topology when --graphid is -1")
    p.add_argument("--budget", type=float, default=0.5)
    p.add_argument("--matcha", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--bs", type=int, default=32, help="per-worker batch size")
    p.add_argument("--lr", type=float, default=0.8)
    p.add_argument("--epoch", type=int, default=200, dest="epochs")
    p.add_argument("--plan", default=None,
                   help="plan_torch.py artifact (plan.json): sets the graph, "
                        "worker count, budget, MATCHA mode and seed the "
                        "planner chose, over --graphid/--topology/"
                        "--numworkers/--budget/--matcha/--randomSeed")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "perm", "gather", "dense", "fused",
                            "skip", "shard_map"],
                   help="gossip backend of the decen communicator; auto "
                        "picks perm or dense by the planner's gate and "
                        "journals the decision as a `backend` event; "
                        "shard_map mixes the workers folded across the "
                        "visible cards")
    p.add_argument("--gossip-measured-ratio", type=float, default=None,
                   dest="gossip_measured_vs_ceiling",
                   help="the dense form's measured-vs-ceiling ratio, the "
                        "input of the --backend auto gate: >= 0.85 "
                        "picks perm")
    p.add_argument("--gossip-measured-source", default=None,
                   dest="gossip_measured_source",
                   help="file to read the auto gate's ratio from instead: "
                        "a run journal with roofline records, a "
                        "{\"record\": ...} capture or a roofline report "
                        "(dense/fused ratios only)")
    p.add_argument("--communicator", default="decen",
                   choices=["decen", "choco", "centralized", "none"])
    p.add_argument("--compress", action="store_true",
                   help="CHOCO-SGD: gossip compressed differences (the same "
                        "as --communicator choco)")
    p.add_argument("--ratio", type=float, default=0.9,
                   help="CHOCO compression ratio (keep the top 1-ratio)")
    p.add_argument("--compressor", default="top_k",
                   choices=list(COMPRESSOR_NAMES),
                   help="CHOCO message compressor")
    p.add_argument("--consensus-lr", type=float, default=0.1,
                   dest="consensus_lr", help="CHOCO's consensus step gamma")
    p.add_argument("--compress-warmup-epochs", type=int, default=0,
                   dest="compress_warmup_epochs",
                   help="ramp the CHOCO ratio from 0 to --ratio over this "
                        "many epochs (0: off)")
    p.add_argument("--remat", action="store_true",
                   help="recompute each block's activations in the backward "
                        "pass (same result, less memory)")
    p.add_argument("--grad-chunk", type=int, default=0, dest="grad_chunk",
                   help="run the forward/backward in slabs of this many "
                        "workers (0: all at once)")
    p.add_argument("--wire-dtype", default="f32", choices=["f32", "bf16"],
                   dest="wire_dtype")
    p.add_argument("--overlap", default="off", choices=["off", "1step"],
                   help="pipelined gossip: '1step' issues each step's "
                        "exchange (begin_mix) and consumes it at the next "
                        "step (one-step-stale mixing)")
    p.add_argument("--staleness", type=int, default=1,
                   help="pipeline depth K (needs --overlap 1step): deltas "
                        "issued at step t are consumed at t+K through a "
                        "[N, K, D] ring; K=1 is the one-step pipeline "
                        "bitwise, K>=2 damps the executed mixing weight "
                        "for the delay")
    p.add_argument("--local-steps", type=int, default=1, dest="local_steps",
                   help="local SGD steps per gossip exchange: the exchange "
                        "runs every L-th step only (composes with "
                        "--staleness: delays count in exchanges, "
                        "ceil(K/L))")
    p.add_argument("--fault-plan", default=None, dest="fault_plan",
                   help="JSON fault plan file (resilience.FaultPlan): dead "
                        "workers, stragglers, NaN emitters and link outages "
                        "over step ranges, injected deterministically into "
                        "the step; e.g. "
                        '\'{"events": [{"kind": "dead", "worker": 3, '
                        '"start": 100, "stop": 200}]}\'')
    p.add_argument("--max-recoveries", type=int, default=0,
                   dest="max_recoveries",
                   help="on a non-finite epoch: roll back to the epoch's "
                        "snapshot, back off the LR, re-derive alpha once, "
                        "and retry up to this many times before raising "
                        "(0: raise at once)")
    p.add_argument("--recovery-lr-backoff", type=float, default=0.5,
                   dest="recovery_lr_backoff",
                   help="LR scale applied per recovery attempt")
    p.add_argument("--membership-trace", default=None,
                   dest="membership_trace",
                   help="JSON membership trace file "
                        "(elastic.MembershipTrace): join/leave/rejoin "
                        "events of named workers applied at epoch "
                        "boundaries over the static pool of --numworkers "
                        "slots, alpha re-folded per live set; e.g. "
                        '\'{"events": [{"kind": "leave", "epoch": 2, '
                        '"worker": "w3"}]}\'')
    p.add_argument("--membership-hysteresis", type=int, default=0,
                   dest="membership_hysteresis",
                   help="epochs the membership must hold still before "
                        "alpha is re-folded for the new live set (0: at "
                        "once); the alive mask always applies at once")
    p.add_argument("--membership-bootstrap", default="mean",
                   choices=["mean", "restore"], dest="membership_bootstrap",
                   help="join/rejoin policy: 'mean' bootstraps every "
                        "(re)entering worker from the continuing members' "
                        "mean; 'restore' lets a rejoiner keep its own "
                        "frozen rows when still finite")
    p.add_argument("--membership-live", default=None,
                   dest="membership_live",
                   help="heartbeat directory to drive membership from "
                        "LIVE instead of a declared trace (a run's "
                        "health/ dir on a shared FS): a member missing "
                        "its --membership-deadline leaves, a reappearing "
                        "worker rejoins — same controller, hysteresis, "
                        "and re-folds as --membership-trace; mutually "
                        "exclusive with it")
    p.add_argument("--membership-deadline", type=float, default=60.0,
                   dest="membership_deadline",
                   help="seconds without a heartbeat before a member is "
                        "presumed gone (with --membership-live)")
    p.add_argument("--no-health", action="store_true",
                   help="disable the live health plane (per-epoch "
                        "heartbeat records under {run}/health/ and the "
                        "streaming anomaly detectors); heartbeats ride "
                        "--save + telemetry and are pure host work, so "
                        "this exists for A/B, not speed")
    p.add_argument("--no-telemetry", action="store_true",
                   help="disable the in-step counters and the live "
                        "planner-drift monitor; the events.jsonl run "
                        "journal itself rides --save and keeps recording "
                        "epoch/fault/checkpoint events. Telemetry is a "
                        "handful of scalar adds on the device read once "
                        "per epoch, so this exists for A/B measurement, "
                        "not for speed")
    p.add_argument("--drift-tolerance", type=float, default=0.25,
                   dest="drift_tolerance",
                   help="relative band over the predicted per-epoch "
                        "contraction factor before an epoch counts as "
                        "out-of-plan")
    p.add_argument("--drift-patience", type=int, default=2,
                   dest="drift_patience",
                   help="consecutive out-of-band epochs before a drift "
                        "event is journaled")
    p.add_argument("--trace-dir", default=None, dest="trace_dir",
                   help="capture one epoch (--trace-epoch) as a "
                        "torch.profiler trace under this dir — the "
                        "executed-kernel record obs_torch.py profile "
                        "parses for the comm/comp split and overlap")
    p.add_argument("--trace-epoch", type=int, default=1, dest="trace_epoch",
                   help="which epoch to trace (clamped to the run; default "
                        "1, past the first calls' kernel builds)")
    p.add_argument("--randomSeed", "--seed", type=int, default=9001,
                   dest="seed")
    p.add_argument("--name", default="experiment")
    p.add_argument("--save", action="store_true",
                   help="write the Recorder's CSVs and the run journal")
    p.add_argument("--savePath", default="runs")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   dest="checkpoint_every",
                   help="epochs between checkpoints (0: none)")
    p.add_argument("--resume", default=None,
                   help="checkpoint directory to resume from")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    communicator = args.communicator
    if args.compress:
        if communicator not in ("decen", "choco"):
            p.error(f"--compress and --communicator {communicator} are "
                    f"mutually exclusive")
        communicator = "choco"
    cfg = TrainConfig(
        model=args.model, dataset=args.dataset, num_workers=args.numworkers,
        graphid=None if args.graphid < 0 else args.graphid,
        topology=args.topology, matcha=args.matcha, budget=args.budget,
        batch_size=args.bs, lr=args.lr, epochs=args.epochs,
        plan=args.plan, gossip_backend=args.backend,
        gossip_measured_vs_ceiling=args.gossip_measured_vs_ceiling,
        gossip_measured_source=args.gossip_measured_source,
        communicator=communicator,
        compress_ratio=args.ratio, compressor=args.compressor,
        consensus_lr=args.consensus_lr,
        compress_warmup_epochs=args.compress_warmup_epochs,
        remat=args.remat, grad_chunk=args.grad_chunk or None,
        wire_dtype=args.wire_dtype, overlap=args.overlap,
        staleness=args.staleness, local_steps=args.local_steps,
        seed=args.seed, name=args.name,
        save=args.save, savePath=args.savePath,
        checkpoint_every=args.checkpoint_every, resume=args.resume,
        fault_plan=args.fault_plan, max_recoveries=args.max_recoveries,
        recovery_lr_backoff=args.recovery_lr_backoff,
        membership_trace=args.membership_trace,
        membership_hysteresis=args.membership_hysteresis,
        membership_bootstrap=args.membership_bootstrap,
        membership_live=args.membership_live,
        membership_deadline=args.membership_deadline,
        telemetry=not args.no_telemetry, health=not args.no_health,
        drift_tolerance=args.drift_tolerance,
        drift_patience=args.drift_patience,
        trace_dir=args.trace_dir, trace_epoch=args.trace_epoch)
    return cfg, args.device


def main(argv=None):
    cfg, device = parse_args(argv)
    result = train(cfg, device=device)
    for h in result.history:
        print(json.dumps({k: round(v, 5) if isinstance(v, float) else v
                          for k, v in h.items()}))


if __name__ == "__main__":
    main()
