#!/usr/bin/env python
"""Run a training job of the PyTorch/CUDA port as a supervised service.

The port's counterpart of ``serve_tpu.py``, with the same commands and
flags, and ``run --device cuda|cpu`` (default: the card; a host without
CUDA fails in the trainer rather than train on the CPU).

``run`` starts the daemon: a ``serve.Controller`` supervising the train
loop across crashes (bounded restart budget, decorrelated backoff,
checkpoint resume), applying versioned ``control.json`` hot-swaps at
epoch boundaries, promoting consensus-mean checkpoints behind a signed
manifest, and answering ``/healthz`` / ``/status`` / ``/promoted`` over
stdlib HTTP.  ``control`` publishes a control document atomically;
``verify`` audits a serving directory end-to-end (exit 1 on tamper).

Examples
--------
Serve a 2-epoch MLP smoke run with promotion every epoch::

    python serve_torch.py run --config serve.json --port 8321 \
        --promote-every 1 --device cpu

Hot-swap the communication budget of the live run::

    python serve_torch.py control --out runs/control.json --version 1 \
        --budget 0.25

Stop it cleanly, then audit what was promoted::

    python serve_torch.py control --out runs/control.json --version 2 --stop
    python serve_torch.py verify runs/experiment_serving
"""

from __future__ import annotations

import argparse
import json
import signal
import sys


def cmd_run(args) -> int:
    with open(args.config) as f:
        config = json.load(f)
    if args.name:
        config["name"] = args.name
    if args.epochs is not None:
        config["epochs"] = args.epochs
    if args.save_path:
        config["savePath"] = args.save_path

    from matcha_tpu_torch.serve import Controller, ServeConfig, ServeEndpoint

    controller = Controller(ServeConfig(
        config=config,
        control_path=args.control,
        serving_dir=args.serving_dir,
        promote_every=args.promote_every,
        promote_margin=args.promote_margin,
        promote_keep=args.promote_keep,
        eval_batch=args.eval_batch,
        restart_budget=args.restart_budget,
        backoff=args.backoff,
        jitter_seed=args.jitter_seed,
        refill_epochs=args.refill_epochs,
        crash_window=args.crash_window,
        device=args.device,
    ))
    endpoint = None
    if not args.no_endpoint:
        name = config.get("name", "experiment")
        endpoint = ServeEndpoint({name: controller},
                                 host=args.host, port=args.port).start()
        print(f"serve_torch: endpoint on http://{args.host}:{endpoint.port} "
              f"(/healthz /status /promoted)", flush=True)
    print(f"serve_torch: supervising run_dir={controller.run_dir} "
          f"control={controller.control_path} "
          f"serving={controller.serving_dir}", flush=True)

    def _terminate(signum, frame):
        print(f"serve_torch: signal {signum}, shutting down", flush=True)
        controller.shutdown()

    signal.signal(signal.SIGTERM, _terminate)
    signal.signal(signal.SIGINT, _terminate)
    try:
        rc = controller.run()
    finally:
        if endpoint is not None:
            endpoint.stop()
    print(f"serve_torch: supervision ended with exit {rc} "
          f"(lifetimes={controller.lifetimes}, "
          f"restarts={controller.restarts_used})", flush=True)
    return rc


def cmd_control(args) -> int:
    doc = {"version": args.version}
    if args.stop:
        doc["stop"] = True
    for field in ("budget", "local_steps", "staleness", "drift_tolerance",
                  "drift_patience", "membership_hysteresis",
                  "membership_bootstrap"):
        value = getattr(args, field)
        if value is not None:
            doc[field] = value

    from matcha_tpu_torch.serve import write_control

    write_control(args.out, doc)
    body = json.dumps({k: v for k, v in doc.items() if k != "version"},
                      sort_keys=True)
    print(f"serve_torch: published control v{args.version} to {args.out}: "
          f"{body}")
    return 0


def cmd_verify(args) -> int:
    from matcha_tpu_torch.serve import PromotionTampered, verify_promoted

    try:
        manifest = verify_promoted(args.serving_dir)
    except PromotionTampered as e:
        print(f"serve_torch: VERIFICATION FAILED — {e}", file=sys.stderr)
        return 1
    print(f"serve_torch: verified {args.serving_dir}: epoch "
          f"{manifest['epoch']} step {manifest['step']} "
          f"test_acc={manifest['metrics'].get('test_acc'):.4f} "
          f"hash={manifest['content_hash'][:16]}…")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("run", help="start the supervised daemon")
    s.add_argument("--config", required=True,
                   help="JSON file of TrainConfig fields")
    s.add_argument("--name", default=None, help="override config name")
    s.add_argument("--epochs", type=int, default=None,
                   help="override config epochs")
    s.add_argument("--save-path", default=None, help="override savePath")
    s.add_argument("--control", default=None,
                   help="control document path (default {savePath}/control.json)")
    s.add_argument("--serving-dir", default=None,
                   help="promotion target (default {savePath}/{name}_serving)")
    s.add_argument("--promote-every", type=int, default=0,
                   help="epochs between promotion evals (0 disables)")
    s.add_argument("--promote-margin", type=float, default=0.0,
                   help="tolerated test_acc drop before rollback")
    s.add_argument("--promote-keep", type=int, default=3)
    s.add_argument("--eval-batch", type=int, default=256)
    s.add_argument("--restart-budget", type=int, default=3)
    s.add_argument("--backoff", type=float, default=1.0)
    s.add_argument("--jitter-seed", type=int, default=None,
                   help="pin the decorrelated backoff jitter (chaos replay)")
    s.add_argument("--refill-epochs", type=int, default=0,
                   help="checkpointed epochs per restored crash credit "
                        "(0 disables budget refill)")
    s.add_argument("--crash-window", type=float, default=0.0,
                   help="crash-loop window seconds (0 = backoff max): two "
                        "same-signature crashes inside it quarantine the "
                        "checkpoint generation they resumed from")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=0,
                   help="endpoint port (0 = ephemeral, printed at start)")
    s.add_argument("--no-endpoint", action="store_true")
    s.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="the trainer's device (default: the CUDA card)")
    s.set_defaults(fn=cmd_run)

    s = sub.add_parser("control", help="publish a control document")
    s.add_argument("--out", required=True, help="control.json path")
    s.add_argument("--version", type=int, required=True)
    s.add_argument("--stop", action="store_true")
    s.add_argument("--budget", type=float, default=None)
    s.add_argument("--local-steps", type=int, default=None,
                   dest="local_steps")
    s.add_argument("--staleness", type=int, default=None)
    s.add_argument("--drift-tolerance", type=float, default=None,
                   dest="drift_tolerance")
    s.add_argument("--drift-patience", type=int, default=None,
                   dest="drift_patience")
    s.add_argument("--membership-hysteresis", type=int, default=None,
                   dest="membership_hysteresis")
    s.add_argument("--membership-bootstrap", default=None,
                   choices=["mean", "restore"],
                   dest="membership_bootstrap")
    s.set_defaults(fn=cmd_control)

    s = sub.add_parser("verify", help="audit a serving directory's manifest")
    s.add_argument("serving_dir")
    s.set_defaults(fn=cmd_verify)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
