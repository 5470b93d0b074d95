#!/usr/bin/env python
"""Seeded host-plane fault campaigns against the port's serve daemon.

The port's counterpart of ``chaos_tpu.py``, with the same commands and
flags, and ``--device {cuda,cpu}`` (default: the card).  Runs
deterministic fault campaigns against the daemon's own stack (the
``Controller`` → ``python -m matcha_tpu_torch.serve.trainer`` subprocess
``serve_torch.py run`` drives) and judges every trial with the pinned
invariant suite.  The trainers run on the card unless ``--device cpu``
asks for the CPU; without it a host with no CUDA fails before any trial
starts.

Commands
--------
``campaign [--trials N] [--seed0 K] [--workdir DIR] [--md PATH]``
    Run N seeded trials (seeds K..K+N-1 → injector families round-robin
    via ``seed % len(FAMILIES)``).  ``--md`` writes the report.  Exit 1
    when any trial fails.

``replay --seed S [--workdir DIR]``
    Re-run one seed's exact fault schedule (same seed, same schedule,
    same verdict).  Exit mirrors the verdict.

``shrink --seed S [--workdir DIR]``
    Greedily minimize a FAILING seed's fault schedule: every spec
    parameter is walked back toward its default while the trial still
    fails; prints the minimal reproducing spec as JSON.

``families``
    List the injector families and which seeds (mod) land on each.

Examples
--------
::

    python chaos_torch.py campaign --trials 14 --md runs/chaos.md
    python chaos_torch.py replay --seed 7 --device cpu
"""

import argparse
import json
import os
import sys


def _log(msg: str) -> None:
    print(msg, flush=True)


def cmd_campaign(args) -> int:
    from matcha_tpu_torch.chaos import run_campaign
    from matcha_tpu_torch.chaos.campaign import render_report

    seeds = range(args.seed0, args.seed0 + args.trials)
    campaign = run_campaign(seeds, args.workdir, log=_log,
                            device=args.device)
    report = render_report(campaign)
    if args.md:
        os.makedirs(os.path.dirname(os.path.abspath(args.md)),
                    exist_ok=True)
        with open(args.md, "w") as f:
            f.write(report)
        _log(f"chaos: report written to {args.md}")
    print(report)
    return 0 if campaign["ok"] else 1


def cmd_replay(args) -> int:
    from matcha_tpu_torch.chaos import run_trial, schedule_for_seed

    spec = schedule_for_seed(args.seed)
    _log(f"chaos: replaying seed {args.seed}: {json.dumps(spec.to_json())}")
    trial = run_trial(spec, args.workdir, log=_log, device=args.device)
    print(json.dumps({k: trial[k] for k in
                      ("seed", "family", "rc", "restarts_used",
                       "lifetimes", "ok", "violations")}, indent=2))
    return 0 if trial["ok"] else 1


def cmd_shrink(args) -> int:
    from matcha_tpu_torch.chaos import schedule_for_seed, shrink

    spec = schedule_for_seed(args.seed)
    minimal = shrink(spec, args.workdir, log=_log, device=args.device)
    print(json.dumps(minimal.to_json(), indent=2))
    return 0


def cmd_families(args) -> int:
    from matcha_tpu_torch.chaos import FAMILIES

    for i, family in enumerate(FAMILIES):
        print(f"seed % {len(FAMILIES)} == {i:2d} → {family}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    def trial_flags(s):
        s.add_argument("--workdir", default="runs/chaos")
        s.add_argument("--device", choices=("cuda", "cpu"), default=None,
                       help="where the trainers run (default: the card; "
                            "a host without CUDA fails)")

    s = sub.add_parser("campaign", help="run N seeded trials")
    s.add_argument("--trials", type=int, default=26)
    s.add_argument("--seed0", type=int, default=0)
    s.add_argument("--md", default=None, help="write the report artifact")
    trial_flags(s)
    s.set_defaults(fn=cmd_campaign)

    s = sub.add_parser("replay", help="re-run one seed exactly")
    s.add_argument("--seed", type=int, required=True)
    trial_flags(s)
    s.set_defaults(fn=cmd_replay)

    s = sub.add_parser("shrink", help="minimize a failing seed's schedule")
    s.add_argument("--seed", type=int, required=True)
    trial_flags(s)
    s.set_defaults(fn=cmd_shrink)

    s = sub.add_parser("families", help="list injector families")
    s.set_defaults(fn=cmd_families)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
