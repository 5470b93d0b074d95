#!/usr/bin/env python
"""Observability CLI of the PyTorch port: read a run's journal, price the
gossip programs on the card's peaks, attribute a profiler trace.

The port's counterpart of ``obs_tpu.py``, with its commands, flags and
exit codes, importing nothing of JAX: it reads what a run of
``train_torch.py`` wrote (``events.jsonl``, ``health/``, a ``--trace-dir``
capture) on a host without JAX.

Commands
--------
``summary RUN [--md PATH]``
    One-screen report: config and plan header, the per-epoch table (loss,
    disagreement, wire bytes, matchings, alive floor, heals, timings), the
    fault/drift/retrace events, the cost ledger's programs.

``tail RUN [-n N]``
    The last N journal events, one per line.

``drift RUN [--rho R] [--tolerance T] [--patience K] [--steps-per-epoch S]``
    Replay the planner-drift analysis over the journal; exit 1 when drift
    is detected, 0 within the band.

``compare SRC... [--md PATH]``
    One table across run dirs / journals, ``BENCH_r*.json`` records,
    ``MULTICHIP_r*.json`` stamps and ``measured_link_costs.json``
    artifacts; exit 2 when nothing is comparable.

``roofline [--backend dense|fused|perm|both] [--workers N] [--dim D |
--model M] [--chip C] [--t-steps T] [--measured R | --source SRC]
[--md PATH]``
    Price the gossip program at the shape (``FlopCounterMode`` and the
    kernels' hand models, the program's boundary bytes, from shapes on
    the ``meta`` device) and divide by the chip's peaks: compute-bound and
    HBM-bound steps/s, the measured-vs-ceiling ratio with ``--measured``.
    ``--chip`` defaults to the card (exit 2 without one); ``--chip cpu``
    takes the provisional row.  Exit 1 when a ceiling is not finite.

``capacity [--dim D | --model M] [--workers N,N] [--chip C] [--md PATH]``
    The HBM capacity table: persistent state bytes and cards needed per
    (communicator, N).

``profile TRACE... [--md PATH] [--journal PATH]``
    Attribute an executed ``torch.profiler`` trace's kernel rows to the
    step's phases (``comm/*``, ``matcha/*``) through the ranges around
    their launches, and report the comm/comp overlap.  Exit 2 when a trace
    has no device rows (a CPU capture).

``watch RUN [--once] [--interval S] [--deadline S] [--md PATH]``
    (alias ``health``)  Fleet status from ``RUN/health/``; ``--once``
    exits 1 when anything is flagged, 0 when healthy, 2 without
    heartbeats.

``attribute RUN [--out COSTS.json] [--md PATH] [--journal PATH]``
    Measured per-matching link costs from the journal; ``--out`` writes a
    planlint-checked ``measured_link_costs.json``.  Exit 1 when nothing is
    identifiable, 2 on an unusable journal.

``timeline RUN [--out trace.json]``
    The journal and heartbeat files as one Perfetto/Chrome trace,
    validated before it is written; exit 1 on a validation failure.

``RUN`` is a run directory (holding ``events.jsonl``) or a journal path.
"""

from __future__ import annotations

import argparse
import sys


def _load(source: str):
    from matcha_tpu_torch.obs import read_journal, resolve_journal_path

    path = resolve_journal_path(source)
    return read_journal(path), path


def cmd_summary(args) -> int:
    from matcha_tpu_torch.obs.report import (render_summary,
                                             render_summary_markdown)

    events, path = _load(args.run)
    print(render_summary(events, source=path))
    if args.md:
        with open(args.md, "w") as f:
            f.write(render_summary_markdown(events, source=path))
        print(f"# markdown written to {args.md}", file=sys.stderr)
    return 0


def cmd_tail(args) -> int:
    from matcha_tpu_torch.obs import read_journal_tail, resolve_journal_path
    from matcha_tpu_torch.obs.report import render_tail

    # bounded reverse read: "what just happened" must cost O(tail), not
    # O(run length) — a long run's journal is megabytes of history
    events = read_journal_tail(resolve_journal_path(args.run), args.n)
    print(render_tail(events, n=args.n))
    return 0


def cmd_drift(args) -> int:
    from matcha_tpu_torch.obs import drift_report

    events, path = _load(args.run)
    report = drift_report(events, rho=args.rho, tolerance=args.tolerance,
                          patience=args.patience,
                          steps_per_epoch=args.steps_per_epoch)
    print(f"journal: {path}")
    print(f"predicted: rho={report['rho']:.6g} over "
          f"{report['steps_per_epoch']} steps/epoch -> per-epoch factor "
          f"{report['predicted_factor']:.4g} "
          f"(band <= {report['band']:.4g}, patience {report['patience']})")
    pairs = zip(report["epochs"][1:], report["measured_factors"])
    factors = "  ".join(f"e{ep}:{f:.3g}" for ep, f in pairs)
    print(f"measured factors: {factors}")
    print(f"checked epochs: {report['checked_epochs']}, "
          f"violations: {report['violations']}")
    if report.get("rebases"):
        print(f"plan re-based {report['rebases']}x mid-run (alpha "
              f"re-derivation / config-changed resume); rho above is the "
              f"final segment's")
    for trip in report["trips"]:
        print(f"DRIFT (replayed): epoch {trip['epoch']} measured "
              f"{trip['measured_factor']:.4g} > band {report['band']:.4g}")
    for e in report["journaled"]:
        print(f"DRIFT (journaled live): epoch {e.get('epoch')} measured "
              f"{e.get('measured_factor'):.4g}")
    print("verdict: " + ("within the predicted tolerance band"
                         if report["consistent"] else "PLANNER DRIFT"))
    return 0 if report["consistent"] else 1


def cmd_compare(args) -> int:
    from matcha_tpu_torch.obs.report import compare_sources, render_compare

    rows, problems = compare_sources(args.sources)
    if not rows:
        print("nothing comparable found", file=sys.stderr)
        for p in problems:
            print(f"# {p}", file=sys.stderr)
        return 2
    print(render_compare(rows, problems))
    if args.md:
        with open(args.md, "w") as f:
            f.write(render_compare(rows, problems, markdown=True) + "\n")
        print(f"# markdown written to {args.md}", file=sys.stderr)
    return 0


def _resolve_dim(args) -> int:
    if args.dim:
        return args.dim
    from matcha_tpu_torch.obs.costs import flat_param_dim

    return flat_param_dim(args.model, args.dataset, num_classes=args.classes)


def _resolve_measured(args):
    """``(steps_per_sec, backend)`` — explicit ``--measured`` (backend =
    the ``--measured-backend`` flag), or the first rate row a ``--source``
    (bench journal / BENCH_r*.json / run dir) yields, with the record's
    own ``backend`` field carried along so the ratio is attributed to the
    kernel that was actually measured, never assumed."""
    if args.measured is not None:
        return float(args.measured), getattr(args, "measured_backend", None)
    if not args.source:
        return None, None
    from matcha_tpu_torch.obs.report import compare_sources

    rows, problems = compare_sources([args.source])
    for p in problems:
        print(f"# {p}", file=sys.stderr)
    for row in rows:
        if row.get("value") and row.get("unit") == "gossip_steps_per_sec":
            return float(row["value"]), row.get("backend")
    # name what WAS there and what would have worked — "no record" alone
    # sends the operator diffing JSON shapes by hand
    found = sorted({str(r.get("unit")) for r in rows}) or ["nothing"]
    print(f"# no gossip_steps_per_sec record in {args.source} (found "
          f"units: {', '.join(found)}); accepted source shapes: a bench "
          f"journal / run dir with `bench` events carrying "
          f"unit=gossip_steps_per_sec, a BENCH_r*.json bench capture "
          f"(record/parsed/tail wrappers ok), or a bench_live_r*.json "
          f"record", file=sys.stderr)
    return None, None


def _normalize_measured_backend(label):
    """Map a bench record's ``backend`` field onto the roofline backend
    vocabulary: the cpu-fallback provisional is a dense f32 measurement;
    unknown labels return None (unattributable)."""
    if label is None:
        return None
    label = str(label)
    for key in ("perm", "fused", "dense"):
        if key in label:
            return key
    if "cpu-fallback" in label:
        return "dense"
    return None


def cmd_roofline(args) -> int:
    import math

    from matcha_tpu_torch.obs.costs import (
        render_roofline_compare_markdown,
        render_roofline_markdown,
        roofline_compare,
        roofline_report,
    )
    from matcha_tpu_torch.topology import decompose, graph_size, make_graph, \
        select_graph

    if args.graphid is not None:
        decomposed = select_graph(args.graphid)
        n = graph_size(args.graphid)
    else:
        n = args.workers
        decomposed = decompose(make_graph(args.topology, n, seed=1), n, seed=1)
    dim = _resolve_dim(args)
    measured, measured_from = _resolve_measured(args)
    # attribute the measured rate to the kernel that produced it: the
    # explicit --measured-backend flag wins, else the source record's own
    # `backend` field — a rate must never be quoted against another
    # backend's ceiling (the denominator mis-citation
    # measured_vs_ceiling_backend exists to prevent)
    m_backend = args.measured_backend or _normalize_measured_backend(
        measured_from)
    shape = dict(t_steps=args.t_steps)

    def finite(rep) -> bool:
        return all(math.isfinite(rep[k]) and rep[k] > 0 for k in
                   ("flops_per_step", "hbm_bytes_per_step",
                    "compute_bound_steps_per_sec",
                    "hbm_bound_steps_per_sec"))

    if args.backend == "both":
        if measured is not None and m_backend not in ("fused", "perm"):
            print(f"# measured rate came from backend "
                  f"{measured_from!r} — not a chain kernel; comparison "
                  f"emitted without a measured row (pass "
                  f"--measured-backend to override)", file=sys.stderr)
            measured = None
        report = roofline_compare(n, dim, decomposed,
                                  wire_dtype=args.wire_dtype,
                                  chip=args.chip,
                                  measured_steps_per_sec=measured,
                                  measured_backend=m_backend or "perm",
                                  **shape)
        md = render_roofline_compare_markdown(report,
                                              source=args.source or "")
        # a non-finite PERM ceiling fails exactly like the historical
        # dense path: the comparison is only evidence when both sides
        # extracted real numbers
        ok = finite(report["fused"]) and finite(report["perm"])
        journal_payload = {"roofline_compare": report,
                           "unit": "roofline_compare"}
    else:
        report = roofline_report(n, dim, decomposed,
                                 wire_dtype=args.wire_dtype,
                                 chip=args.chip,
                                 measured_steps_per_sec=measured,
                                 backend=args.backend, **shape)
        if measured is not None and m_backend is not None:
            # origin of the rate, recorded next to the denominator: a
            # fused rate against the dense report is the intended
            # formulation-gate pairing (same 2·N²·D compute bound), but
            # the record must say so rather than imply a same-backend
            # measurement
            report["measured_backend"] = m_backend
            if m_backend != args.backend:
                print(f"# note: measured rate comes from the "
                      f"{m_backend!r} backend; this report's ceilings "
                      f"price {args.backend!r} (the record carries both "
                      f"labels)", file=sys.stderr)
        md = render_roofline_markdown(report, source=args.source or "")
        ok = finite(report)
        journal_payload = {"roofline": report, "unit": "roofline_report"}
    print(md)
    if args.md:
        with open(args.md, "w") as f:
            f.write(md)
        print(f"# markdown written to {args.md}", file=sys.stderr)
    if args.journal and ok:
        # gated on finiteness: a failed extraction must not write NaN
        # tokens (non-strict JSON) into a session journal the compare /
        # summary renderers will read later
        from matcha_tpu_torch.obs import append_journal_record

        append_journal_record(args.journal, "bench", record=journal_payload)
    if not ok:
        print("obs_torch: roofline produced non-finite ceilings (nothing "
              "journaled)", file=sys.stderr)
    return 0 if ok else 1


def cmd_capacity(args) -> int:
    from matcha_tpu_torch.obs.costs import (capacity_report,
                                            render_capacity_markdown)

    workers = [int(w) for w in args.workers.split(",") if w.strip()]
    report = capacity_report(_resolve_dim(args), workers=workers,
                             communicators=tuple(
                                 c for c in args.communicators.split(",")
                                 if c.strip()),
                             chip=args.chip)
    md = render_capacity_markdown(report)
    print(md)
    if args.md:
        with open(args.md, "w") as f:
            f.write(md)
        print(f"# markdown written to {args.md}", file=sys.stderr)
    return 0


def cmd_profile(args) -> int:
    from matcha_tpu_torch.obs.xprof import (profile_report,
                                            render_profile_markdown)

    reports = [profile_report(src) for src in args.traces]
    md = render_profile_markdown(reports)
    print(md)
    if args.md:
        with open(args.md, "w") as f:
            f.write(md)
        print(f"# markdown written to {args.md}", file=sys.stderr)
    if args.journal:
        from matcha_tpu_torch.obs import append_journal_record

        for r in reports:
            append_journal_record(args.journal, "profile", **r)
    return 0


def cmd_attribute(args) -> int:
    import json

    from matcha_tpu_torch.obs.attribution import (
        attribute_run,
        attribution_event_fields,
        link_costs_artifact,
        render_attribution,
    )

    events, path = _load(args.run)
    report = attribute_run(events, steps_per_epoch=args.steps_per_epoch,
                           ridge=args.ridge, num_chips=args.chips)
    print(render_attribution(report))
    if args.md:
        with open(args.md, "w") as f:
            f.write(render_attribution(report, markdown=True))
        print(f"# markdown written to {args.md}", file=sys.stderr)
    identifiable = any(report["identifiable"])
    if args.out:
        if identifiable:
            with open(args.out, "w") as f:
                json.dump(link_costs_artifact(report), f, indent=1,
                          sort_keys=True)
                f.write("\n")
            # same self-check discipline as plan_torch sweep: never emit an
            # artifact the committed-artifact verifier would reject
            from matcha_tpu_torch.analysis import (lint_plan_file,
                                                   render_plan_text)

            violations, _ = lint_plan_file(args.out)
            if violations:
                print(render_plan_text(violations, [args.out]),
                      file=sys.stderr)
                print(f"# wrote {args.out}, but it FAILS planlint — do "
                      f"not commit", file=sys.stderr)
                return 1
            print(f"# wrote {args.out}", file=sys.stderr)
        else:
            print(f"# not writing {args.out}: nothing identifiable",
                  file=sys.stderr)
    if args.journal and identifiable:
        from matcha_tpu_torch.obs import append_journal_record

        append_journal_record(args.journal, "attribution",
                              **attribution_event_fields(report))
    if not identifiable:
        print(f"obs_torch: attribution unidentifiable — "
              f"{report['reason'] or 'no separable matching'}",
              file=sys.stderr)
        return 1
    return 0


def cmd_timeline(args) -> int:
    import json

    from matcha_tpu_torch.obs.timeline import (
        render_timeline_summary,
        timeline_for_run,
        validate_trace,
    )

    trace = timeline_for_run(args.run)
    problems = validate_trace(trace)
    for p in problems:
        print(f"obs_torch: timeline invalid: {p}", file=sys.stderr)
    if problems:
        print(f"obs_torch: {len(problems)} validation problem(s) — nothing "
              f"written", file=sys.stderr)
        return 1
    with open(args.out, "w") as f:
        json.dump(trace, f, separators=(",", ":"), allow_nan=False)
    print(render_timeline_summary(trace))
    print(f"# trace written to {args.out}", file=sys.stderr)
    return 0


def cmd_watch(args) -> int:
    import time

    from matcha_tpu_torch.obs.health import fleet_verdict, render_watch

    def once() -> int:
        # the 0/1/2 exit contract lives in fleet_verdict
        rc, status = fleet_verdict(args.run, deadline=args.deadline,
                                   tail=args.tail)
        if status is None:
            print(f"obs_torch: no heartbeat evidence under {args.run}",
                  file=sys.stderr)
            return rc
        print(render_watch(status))
        if args.md:
            with open(args.md, "w") as f:
                f.write(render_watch(status, markdown=True))
            print(f"# markdown written to {args.md}", file=sys.stderr)
        return rc

    if args.once:
        return once()
    try:
        while True:  # the live dashboard loop; ^C is the exit path
            rc = once()
            print(f"# refresh in {args.interval:.0f}s (^C to stop; "
                  f"current verdict rc={rc})", file=sys.stderr)
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("summary", help="one-screen run report")
    s.add_argument("run", help="run dir (with events.jsonl) or journal path")
    s.add_argument("--md", default=None, help="also write a markdown report")
    s.set_defaults(fn=cmd_summary)

    s = sub.add_parser("tail", help="last N journal events")
    s.add_argument("run")
    s.add_argument("-n", type=int, default=20)
    s.set_defaults(fn=cmd_tail)

    s = sub.add_parser("drift", help="measured contraction vs predicted rho")
    s.add_argument("run")
    s.add_argument("--rho", type=float, default=None,
                   help="override the journal's predicted rho (what-if)")
    s.add_argument("--tolerance", type=float, default=None)
    s.add_argument("--patience", type=int, default=None)
    s.add_argument("--steps-per-epoch", type=int, default=None,
                   dest="steps_per_epoch")
    s.set_defaults(fn=cmd_drift)

    s = sub.add_parser("compare", help="table across runs / bench records")
    s.add_argument("sources", nargs="+",
                   help="run dirs, journal files, BENCH_r*.json or "
                        "MULTICHIP_r*.json records")
    s.add_argument("--md", default=None)
    s.set_defaults(fn=cmd_compare)

    def _shape_flags(s):
        s.add_argument("--dim", type=int, default=0,
                       help="flat parameter dimension D; 0 derives it from "
                            "--model, built on the meta device (shapes "
                            "only)")
        s.add_argument("--model", default="resnet20")
        s.add_argument("--dataset", default="synthetic_image")
        s.add_argument("--classes", type=int, default=10)
        s.add_argument("--chip", default=None,
                       help="chip table key (h100) or 'cpu' for the "
                            "provisional placeholders; default: the card "
                            "(exit 2 without one)")

    s = sub.add_parser("roofline",
                       help="counted-cost ceilings vs chip peaks")
    _shape_flags(s)
    s.add_argument("--workers", type=int, default=256,
                   help="virtual workers N (ignored with --graphid)")
    s.add_argument("--topology", default="geometric",
                   help="generator topology (north star: geometric)")
    s.add_argument("--graphid", type=int, default=None,
                   help="zoo topology id instead of the generator")
    s.add_argument("--wire-dtype", default="bf16", choices=["f32", "bf16"],
                   dest="wire_dtype")
    s.add_argument("--t-steps", type=int, default=200, dest="t_steps",
                   help="chain length the fused and perm chains are "
                        "amortized over")
    s.add_argument("--backend", default="dense",
                   choices=["dense", "fused", "perm", "both"],
                   help="whose program to price: the dense per-step matmul "
                        "(historical default), the fused W-stack chain, "
                        "the permutation-form flag-stream chain, or the "
                        "perm-vs-fused comparison (exit 1 when any ceiling "
                        "is non-finite, perm included)")
    s.add_argument("--measured", type=float, default=None,
                   help="measured steps/s for the vs-ceiling ratio")
    s.add_argument("--measured-backend", default=None,
                   choices=["dense", "fused", "perm"],
                   dest="measured_backend",
                   help="which backend produced the measured rate "
                        "(default: the --source record's own `backend` "
                        "field).  `--backend both` withholds the measured "
                        "row for non-chain (dense/cpu-fallback) sources; "
                        "single-backend reports always emit the ratio but "
                        "record BOTH labels (measured_backend + "
                        "measured_vs_ceiling_backend) and note "
                        "cross-backend pairings")
    s.add_argument("--source", default=None,
                   help="bench journal / BENCH_r*.json / run dir to read "
                        "the measured rate from instead of --measured")
    s.add_argument("--md", default=None)
    s.add_argument("--journal", default=None,
                   help="also append the report as a bench event here")
    s.set_defaults(fn=cmd_roofline)

    s = sub.add_parser("capacity",
                       help="HBM capacity table from the state's bytes")
    _shape_flags(s)
    s.add_argument("--workers", default="256,64",
                   help="comma-separated worker counts (table rows)")
    s.add_argument("--communicators", default="decen,choco",
                   help="comma-separated communicator column set")
    s.add_argument("--md", default=None)
    s.set_defaults(fn=cmd_capacity)

    for name in ("watch", "health"):  # one command, both spellings
        s = sub.add_parser(name,
                           help="live fleet status from heartbeat files")
        s.add_argument("run", help="run dir (holding health/) or a "
                                   "heartbeat directory")
        s.add_argument("--once", action="store_true",
                       help="print one table and exit (1 when any worker "
                            "is flagged — the CI form)")
        s.add_argument("--interval", type=float, default=10.0,
                       help="refresh period in seconds without --once")
        s.add_argument("--deadline", type=float, default=60.0,
                       help="seconds without a heartbeat before a host "
                            "counts as deadline-missed")
        s.add_argument("--tail", type=int, default=8,
                       help="heartbeat records per host to re-run the "
                            "detectors over (bounded reverse read)")
        s.add_argument("--md", default=None,
                       help="also write the table as a markdown artifact")
        s.set_defaults(fn=cmd_watch)

    s = sub.add_parser("attribute",
                       help="measured per-matching/per-link costs from "
                            "the journal (exit 1 when unidentifiable)")
    s.add_argument("run", help="run dir (with events.jsonl) or journal path")
    s.add_argument("--out", default=None,
                   help="write the planlint-verifiable "
                        "measured_link_costs.json here")
    s.add_argument("--ridge", type=float, default=1e-8,
                   help="ridge penalty on the per-matching coefficients")
    s.add_argument("--chips", type=int, default=1,
                   help="folded chip count for the per-link hop weighting")
    s.add_argument("--steps-per-epoch", type=int, default=None,
                   dest="steps_per_epoch",
                   help="override the journal's recorded steps/epoch")
    s.add_argument("--md", default=None,
                   help="also write the report as a markdown artifact")
    s.add_argument("--journal", default=None,
                   help="also append a schema-v4 `attribution` event here")
    s.set_defaults(fn=cmd_attribute)

    s = sub.add_parser("timeline",
                       help="export the run as a Perfetto/Chrome trace")
    s.add_argument("run", help="run dir (with events.jsonl and optionally "
                               "health/) or journal path")
    s.add_argument("--out", default="trace.json",
                   help="trace_event JSON output path (default trace.json)")
    s.set_defaults(fn=cmd_timeline)

    s = sub.add_parser("profile",
                       help="overlap truth from executed profiler traces")
    s.add_argument("traces", nargs="+",
                   help="trace dirs (a --trace-dir capture) or "
                        "*.trace.json.gz files")
    s.add_argument("--md", default=None)
    s.add_argument("--journal", default=None,
                   help="also append one `profile` event per trace here")
    s.set_defaults(fn=cmd_profile)

    args = p.parse_args(argv)
    try:
        return args.fn(args)
    except (FileNotFoundError, ValueError) as e:
        print(f"obs_torch: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
