#!/usr/bin/env python
"""Offline schedule planner of the PyTorch port: pick the MATCHA budget
before training.  The twin of ``plan_tpu.py``, with its subcommands, flags
and output, on ``matcha_tpu_torch.plan``.

Subcommands
-----------
``rho``     closed-form contraction bound and Monte-Carlo empirical rate for
            one (topology, budget) point, with the degraded-fleet
            (``--worker-alive``, ``--link-drop``) and pipelined
            (``--overlap``, ``--staleness``, ``--local-steps``,
            ``--wire-dtype``) views::

                python plan_torch.py rho --graphid 2 --budget 0.5 --mc-trials 8

``simulate``  the Monte-Carlo consensus trajectory beside the bound::

                python plan_torch.py simulate --graphid 5 --budget 0.5

``cost``    per-matching hop-cost ledger of the workers folded onto
            ``--chips`` cards::

                python plan_torch.py cost --graphid 2 --chips 4

``sweep``   budgets × topologies, ranked by predicted wall-clock to the
            target consensus; writes the plan artifact train_torch.py
            consumes, checked through planlint first::

                python plan_torch.py sweep --graphid 2 \
                    --budgets 0.1,0.25,0.5,1.0 --out plan.json
                python train_torch.py --plan plan.json --model resnet20 ...

            ``--calibrate benchmarks/budget_sweep.json`` fits the cost model
            from a committed measurement table instead of unit costs.

``elasticity``  score elastic-membership policies (re-plan eagerly or with
            hysteresis K; bootstrap from the mean or restore own rows)
            against a churn trace, with the Monte-Carlo simulator::

                python plan_torch.py elasticity --graphid 5 --budget 0.5 \
                    --trace churn.json --out elasticity_plan.json
                python train_torch.py --membership-trace churn.json \
                    --membership-hysteresis K --membership-bootstrap mean|restore

            The artifact is plan-format (``matcha_tpu.plan/1``): planlint
            verifies its solver claims, and the chosen candidate names the
            winning policy.

``verify``  hold a plan's predicted disagreement decay to the Recorder CSVs
            of a run (``train_torch.py --save``)::

                python plan_torch.py verify --plan plan.json \
                    --run-dir runs/experiment_resnet20 --steps-per-epoch 32

            A run directory with a fault ledger (written under
            ``--fault-plan``) is held to the degraded bound.

Everything here is host numpy and scipy; no card is needed.
"""

from __future__ import annotations

import argparse
import json
import sys

from matcha_tpu_torch.plan import (
    CostModel,
    calibrate_cost_model,
    expected_comm_units,
    load_measured_comm_times,
    load_plan,
    matching_comm_units,
    plan_candidate,
    resolve_topology,
    save_plan,
    simulate_consensus,
    stale_contraction_rho,
    sweep,
    verify_plan_run,
    wire_disagreement_floor,
    wire_quantization_eps,
)


def _add_topology_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--graphid", type=int, default=None,
                   help="zoo topology id (0-5); omit to use --topology")
    p.add_argument("--topology", default=None,
                   help="generator kind (ring|torus|erdos_renyi|geometric|...)")
    p.add_argument("--numworkers", type=int, default=16,
                   help="worker count for generator topologies")
    p.add_argument("--seed", type=int, default=9001,
                   help="graph-generation and flag-stream seed "
                        "(train_torch.py --randomSeed equivalent)")


def _add_overlap_args(sp: argparse.ArgumentParser) -> None:
    sp.add_argument("--overlap", default="off", choices=["off", "1step"],
                    help="predict for the pipelined (one-step-stale) "
                         "schedule train_torch.py --overlap runs")
    sp.add_argument("--wire-dtype", default="f32", choices=["f32", "bf16"],
                    dest="wire_dtype",
                    help="model the narrowed gossip wire as bounded "
                         "per-step noise (bf16: eps = 2^-8)")
    sp.add_argument("--staleness", type=int, default=1,
                    help="bounded-staleness pipeline depth K (implies "
                         "--overlap 1step when > 1): deltas issued at step "
                         "t are consumed at t+K; the bound composes the "
                         "delayed-recurrence inflation per eigenmode "
                         "(train_torch.py --staleness)")
    sp.add_argument("--staleness-dist", default=None, dest="staleness_dist",
                    help="consume-age distribution 'd:p,d:p' (e.g. "
                         "'1:0.75,4:0.25' — a period-4 straggler whose "
                         "deltas arrive three rounds late); overrides "
                         "--staleness")
    sp.add_argument("--local-steps", type=int, default=1, dest="local_steps",
                    help="local SGD steps per gossip exchange: consensus "
                         "contracts at rho^(1/L) per step (exact for the "
                         "thinned stream); staleness delays count in "
                         "exchange units ceil(K/L)")


def _staleness_spec(args):
    """Resolve (--staleness, --staleness-dist) into the predictor spec,
    forcing the pipelined schedule on when a real delay is asked for."""
    from matcha_tpu_torch.plan import parse_staleness_spec

    spec = (parse_staleness_spec(args.staleness_dist)
            if args.staleness_dist else int(args.staleness))
    delays = spec if isinstance(spec, dict) else {spec: 1.0}
    overlap = args.overlap
    if max(delays) > 1:
        overlap = "1step"  # staleness > 1 IS the pipelined schedule
    return spec, overlap


def _topology_specs(args) -> list:
    if args.graphid is not None:
        return [{"graphid": args.graphid}]
    if args.topology:
        return [{"topology": args.topology, "num_workers": args.numworkers}]
    raise SystemExit("pass --graphid or --topology")


def _cost_model(args) -> CostModel:
    if getattr(args, "calibrate", None):
        from matcha_tpu_torch.schedule.solvers import solve_activation_probabilities
        from matcha_tpu_torch.topology import matching_laplacians

        # The measured seconds come from whatever (topology, chips) the
        # calibration file's runs used; pairing them with THIS plan's
        # predicted hop units is only a valid fit when the two match.  The
        # sweep summary doesn't record its graph, so this is an assumption
        # the caller owns — say so instead of fitting silently.
        print(f"# calibrating from {args.calibrate}: assumes its runs used "
              f"the topology/--chips being planned here", file=sys.stderr)
        samples = []
        budgets = []
        for spec in _topology_specs(args):
            decomposed, size, _ = resolve_topology(spec, args.seed)
            Ls = matching_laplacians(decomposed, size)
            units_of = matching_comm_units(decomposed, size, args.chips)
            for budget, seconds in load_measured_comm_times(args.calibrate):
                probs = solve_activation_probabilities(
                    Ls, budget, iters=args.solver_iters)
                samples.append(
                    (expected_comm_units(probs, units_of), seconds))
                budgets.append(float(budget))
        # provenance rides the model into the artifact: which measurement
        # file and which budget rows fed the coefficients
        return calibrate_cost_model(
            samples, source=args.calibrate,
            fit={"calibration_file": args.calibrate,
                 "budgets": sorted(set(budgets)), "chips": args.chips})
    return CostModel()


def cmd_rho(args) -> int:
    # validate the cheap flags before the expensive candidate evaluation
    # (the MC simulation dominates this command's cost)
    if not 0.0 <= args.link_drop <= 1.0:
        raise SystemExit(f"--link-drop must be in [0,1], got {args.link_drop}")
    alive_vals = None
    if args.worker_alive is not None:
        alive_vals = [float(v) for v in args.worker_alive.split(",")]
        if not all(0.0 <= v <= 1.0 for v in alive_vals):
            raise SystemExit(f"--worker-alive values must be in [0,1], got "
                             f"{args.worker_alive}")
    (spec,) = _topology_specs(args)
    decomposed, size, norm = resolve_topology(spec, args.seed)
    cand = plan_candidate(
        decomposed, size, args.budget, seed=args.seed, target=args.target,
        num_chips=args.chips, solver_iters=args.solver_iters,
        mc_trials=args.mc_trials, mc_steps=args.mc_steps, graph_spec=norm)
    if alive_vals is not None or args.link_drop:
        # degraded-fleet view: ρ of the expected mixing under per-worker
        # availability and/or i.i.d. link drops (resilience fault model)
        import numpy as np

        from matcha_tpu_torch.plan import degraded_contraction_rho
        from matcha_tpu_torch.topology import matching_laplacians

        alive = None
        if alive_vals is not None:
            alive = np.asarray(alive_vals[0] if len(alive_vals) == 1
                               else alive_vals)
        cand["degraded"] = {
            "worker_alive": None if alive is None else alive.tolist(),
            "link_drop": args.link_drop,
            "rho": degraded_contraction_rho(
                matching_laplacians(decomposed, size),
                np.asarray(cand["probs"]), cand["alpha"],
                worker_alive=alive, link_up=1.0 - args.link_drop),
        }
    stale_spec, overlap = _staleness_spec(args)
    delays = stale_spec if isinstance(stale_spec, dict) else {stale_spec: 1.0}
    if overlap != "off" or args.wire_dtype != "f32" or args.local_steps > 1:
        # pipelined-schedule view: the staleness-
        # adjusted ρ for --overlap 1step / --staleness K / --local-steps L
        # (+ bf16 wire noise).  When the degraded-fleet flags are also
        # given, the adjustments are applied ON TOP of the degraded mixing
        # (masked Laplacians + effective probs) — the views compose into
        # the one ρ the faulty async bf16 run actually has, instead of
        # numbers that are each missing half the story.
        import numpy as np

        from matcha_tpu_torch.plan import degraded_solver_inputs, \
            stale_alpha_rescale
        from matcha_tpu_torch.topology import matching_laplacians

        stale_Ls, stale_p = degraded_solver_inputs(
            matching_laplacians(decomposed, size),
            np.asarray(cand["probs"]),
            worker_alive=alive if alive_vals is not None else None,
            link_up=(1.0 - args.link_drop) if args.link_drop else None,
        ) if (alive_vals is not None or args.link_drop) else (
            matching_laplacians(decomposed, size), np.asarray(cand["probs"]))
        # the damping scale the executor would apply (train/loop.py:
        # _stale_scale) and the ρ at the damped α — reported next to the
        # undamped bound so "what would this run actually contract at"
        # and "what does raw staleness cost" are both answerable
        scale, scaled_rho = stale_alpha_rescale(
            stale_Ls, stale_p, cand["alpha"], staleness=stale_spec,
            local_steps=args.local_steps)
        cand["stale"] = {
            "overlap": overlap,
            "staleness": (max(delays) if len(delays) == 1 else
                          {str(d): p for d, p in delays.items()}),
            "local_steps": int(args.local_steps),
            "wire_dtype": args.wire_dtype,
            "wire_eps": wire_quantization_eps(args.wire_dtype),
            "composed_with_degraded": bool(alive_vals is not None
                                           or args.link_drop),
            "rho": stale_contraction_rho(
                stale_Ls, stale_p, cand["alpha"],
                overlap=overlap, wire_dtype=args.wire_dtype,
                staleness=stale_spec, local_steps=args.local_steps),
            "stale_alpha_scale": scale,
            "rho_at_scaled_alpha": scaled_rho,
            # the rate claim is valid only above this RMS disagreement
            # (relative to parameter RMS): below it the bf16 wire's value
            # resolution is exhausted and contraction stalls — consensus
            # targets under (floor/e0)^2 are unreachable at this wire
            "disagreement_floor_rel": wire_disagreement_floor(
                args.wire_dtype),
        }
    if args.out:
        # plan-format artifact (the async what-if as a committable,
        # planlint-verifiable record): base candidate keys re-derive under
        # PL001–PL008 exactly as a sweep's do; the stale view rides as an
        # additive key.  Self-checked through planlint like sweep — a
        # drifted solver/artifact must fail at write time, not review time.
        from matcha_tpu_torch.analysis import lint_plan_file, render_plan_text
        from matcha_tpu_torch.plan import PlanArtifact

        artifact = PlanArtifact(chosen=cand, candidates=[cand],
                                target_consensus=args.target,
                                num_chips=args.chips,
                                cost_model=CostModel().to_json())
        save_plan(artifact, args.out)
        plan_violations, _ = lint_plan_file(args.out)
        if plan_violations:
            print(render_plan_text(plan_violations, [args.out]),
                  file=sys.stderr)
            print(f"# wrote {args.out}, but it FAILS planlint — do not "
                  f"commit", file=sys.stderr)
            return 1
        print(f"# wrote {args.out}", file=sys.stderr)
    print(json.dumps(cand, indent=1))
    return 0


def cmd_cost(args) -> int:
    (spec,) = _topology_specs(args)
    decomposed, size, norm = resolve_topology(spec, args.seed)
    from matcha_tpu_torch.parallel.folded import build_folded_plan
    from matcha_tpu_torch.topology import matchings_to_perms

    plan = build_folded_plan(matchings_to_perms(decomposed, size), args.chips)
    print(json.dumps({
        **norm,
        "num_chips": args.chips,
        "rows_per_chip": plan.rows_per_chip,
        "per_matching": [
            {"matching": j,
             "parts": [{"offset": o, "slots": s, "ring_hops": h}
                       for (o, s, h) in parts],
             "hop_units": float(sum(h for (_, _, h) in parts))}
            for j, parts in enumerate(plan.hop_accounting())
        ],
    }, indent=1))
    return 0


def cmd_sweep(args) -> int:
    budgets = [float(b) for b in args.budgets.split(",")]
    artifact = sweep(
        _topology_specs(args), budgets, seed=args.seed, target=args.target,
        num_chips=args.chips, cost_model=_cost_model(args),
        solver_iters=args.solver_iters, mc_trials=args.mc_trials,
        mc_steps=args.mc_steps)
    save_plan(artifact, args.out)
    # planlint self-check: a sweep must never emit an artifact the verifier
    # (planlint, which tier-1 runs over benchmarks/) would reject —
    # catching a solver/artifact drift at write time, not at review time
    from matcha_tpu_torch.analysis import lint_plan_file, render_plan_text

    plan_violations, _ = lint_plan_file(args.out)
    if plan_violations:
        print(render_plan_text(plan_violations, [args.out]), file=sys.stderr)
        print(f"# wrote {args.out}, but it FAILS planlint — do not commit",
              file=sys.stderr)
        return 1
    best = artifact.chosen
    print(f"# wrote {args.out}", file=sys.stderr)
    print(json.dumps({
        "chosen_budget": best["budget"],
        "rho": best["rho"],
        "steps_to_target": best["steps_to_target"],
        "predicted_seconds_to_target": best["predicted_seconds_to_target"],
        "ranking": [
            {"budget": c["budget"], "rho": c["rho"],
             "predicted_seconds_to_target": c["predicted_seconds_to_target"]}
            for c in artifact.candidates
        ],
    }, indent=1))
    return 0


def cmd_elasticity(args) -> int:
    from matcha_tpu_torch.elastic import load_membership_trace
    from matcha_tpu_torch.elastic.policy import (
        elasticity_artifact,
        score_elasticity_policies,
    )
    from matcha_tpu_torch.plan.autotune import resolve_topology

    try:
        hysteresis = sorted({int(h) for h in args.hysteresis.split(",")})
    except ValueError:
        raise SystemExit(f"--hysteresis must be a comma list of ints, got "
                         f"{args.hysteresis!r}")
    if any(h < 0 for h in hysteresis):
        raise SystemExit("--hysteresis values must be >= 0")
    trace = load_membership_trace(args.trace)
    (spec,) = _topology_specs(args)
    decomposed, size, norm = resolve_topology(spec, args.seed)
    report = score_elasticity_policies(
        decomposed, size, args.budget, trace, seed=args.seed,
        epochs=args.epochs, steps_per_epoch=args.steps_per_epoch,
        trials=max(args.mc_trials, 1), hysteresis=hysteresis,
        solver_iters=args.solver_iters)
    out_path = args.out
    if out_path:
        artifact = elasticity_artifact(report, norm, target=args.target)
        save_plan(artifact, out_path)
        # same self-check as sweep: never emit an artifact the committed-
        # plan verifier would reject
        from matcha_tpu_torch.analysis import lint_plan_file, render_plan_text

        plan_violations, _ = lint_plan_file(out_path)
        if plan_violations:
            print(render_plan_text(plan_violations, [out_path]),
                  file=sys.stderr)
            print(f"# wrote {out_path}, but it FAILS planlint — do not "
                  f"commit", file=sys.stderr)
            return 1
        print(f"# wrote {out_path}", file=sys.stderr)
    best = report["policies"][0]
    print(json.dumps({
        **norm, "budget": args.budget,
        "pool_alpha": report["pool"]["alpha"],
        "pool_rho": report["pool"]["rho"],
        "trace": trace.name,
        "chosen_policy": {"replan": best["replan"],
                          "hysteresis": best["hysteresis"],
                          "bootstrap": best["bootstrap"]},
        "ranking": [
            {"replan": p["replan"], "bootstrap": p["bootstrap"],
             "score": p["score"], "final_error": p["final_error"]}
            for p in report["policies"]
        ],
    }, indent=1))
    return 0


def cmd_verify(args) -> int:
    artifact = load_plan(args.plan)
    report = verify_plan_run(artifact, args.run_dir, args.steps_per_epoch,
                             rank=args.rank)
    ok = bool(report["consistent"])
    if args.link_costs:
        # the measured-link-costs companion (the attribution plane's): the
        # artifact must pass its own planlint rules (PL009–011) AND belong
        # to the plan being verified — same matching count, or the measured
        # θ prices a schedule this plan never runs
        from matcha_tpu_torch.analysis import lint_link_costs_data
        from matcha_tpu_torch.plan import load_measured_link_costs

        try:
            data, label = load_measured_link_costs(args.link_costs)
            violations = [f"{v.rule} {v.message}"
                          for v in lint_link_costs_data(data, label)]
        except Exception as e:
            # an unreadable / wrong-format / tampered artifact is a verify
            # FAILURE in the report, never a traceback that swallows the
            # run-consistency verdict computed above
            data, label = {}, str(args.link_costs)
            violations = [f"PL009 artifact unusable: "
                          f"{type(e).__name__}: {e}"]
        plan_m = len(artifact.chosen.get("probs", []))
        costs_m = len(data.get("per_matching", []))
        link_report = {
            "path": label,
            "violations": violations,
            "matchings": costs_m,
            "plan_matchings": plan_m,
            "identifiable": sum(1 for r in data.get("per_matching", [])
                                if isinstance(r, dict)
                                and r.get("identifiable")),
        }
        if costs_m != plan_m:
            link_report["violations"].append(
                f"PL010 link-costs artifact prices {costs_m} matchings but "
                f"the plan's chosen candidate has {plan_m}")
        report["link_costs"] = link_report
        ok = ok and not link_report["violations"]
    print(json.dumps(report, indent=1))
    return 0 if ok else 1


def cmd_simulate(args) -> int:
    (spec,) = _topology_specs(args)
    decomposed, size, norm = resolve_topology(spec, args.seed)
    from matcha_tpu_torch.schedule.solvers import (
        solve_activation_probabilities,
        solve_mixing_weight,
    )
    from matcha_tpu_torch.topology import matching_laplacians

    Ls = matching_laplacians(decomposed, size)
    probs = solve_activation_probabilities(Ls, args.budget,
                                           iters=args.solver_iters)
    alpha, rho = solve_mixing_weight(Ls, probs)
    stale_spec, overlap = _staleness_spec(args)
    if isinstance(stale_spec, dict):
        raise SystemExit("simulate runs the executor's point-delay ring; "
                         "use --staleness K (distributions are a rho-only "
                         "what-if)")
    if stale_spec > 1:
        # simulate what the executor would run: the damped α (the solved α
        # oscillates under deep delay — plan.spectral.stale_alpha_rescale)
        from matcha_tpu_torch.plan import stale_alpha_rescale

        scale, _ = stale_alpha_rescale(Ls, probs, alpha,
                                       staleness=stale_spec,
                                       local_steps=args.local_steps)
        alpha = alpha * scale
    sim = simulate_consensus(decomposed, size, probs, alpha,
                             steps=args.mc_steps, trials=args.mc_trials,
                             seed=args.seed, laplacians=Ls,
                             overlap=overlap, wire_dtype=args.wire_dtype,
                             staleness=stale_spec,
                             local_steps=args.local_steps)
    print(json.dumps({
        **norm, "budget": args.budget, "alpha": alpha,
        "overlap": overlap, "wire_dtype": args.wire_dtype,
        "staleness": stale_spec, "local_steps": args.local_steps,
        "rho_bound": sim.rho_bound,
        "mc_empirical_rate": sim.empirical_rate(),
        "mean_decay_curve": [float(v) for v in sim.mean_decay_curve()],
        "predicted_bound_curve": [float(v)
                                  for v in sim.predicted_bound_curve()],
    }, indent=1))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    common = dict(target=1e-3, chips=1, solver_iters=3000)

    def add_common(sp, mc_default=0):
        _add_topology_args(sp)
        sp.add_argument("--target", type=float, default=common["target"],
                        help="consensus-error contraction target (squared)")
        sp.add_argument("--chips", type=int, default=common["chips"],
                        help="fold N workers onto this many cards for the "
                             "hop-cost model")
        sp.add_argument("--solver-iters", type=int,
                        default=common["solver_iters"], dest="solver_iters")
        sp.add_argument("--mc-trials", type=int, default=mc_default,
                        dest="mc_trials",
                        help="Monte-Carlo trials (0 = closed form only)")
        sp.add_argument("--mc-steps", type=int, default=80, dest="mc_steps")

    sp = sub.add_parser("rho", help="contraction bound for one point")
    add_common(sp)
    sp.add_argument("--budget", type=float, default=0.5)
    sp.add_argument("--worker-alive", default=None, dest="worker_alive",
                    help="per-worker availability for the degraded-rho view: "
                         "one float (uniform) or a comma list of N floats "
                         "(a runtime fault plan's expected_alive)")
    sp.add_argument("--link-drop", type=float, default=0.0, dest="link_drop",
                    help="i.i.d. link drop probability for the degraded-rho "
                         "view (matches schedule.with_link_failures / a "
                         "flaky_link fault event)")
    _add_overlap_args(sp)
    sp.add_argument("--out", default=None,
                    help="write the candidate (incl. the staleness view) "
                         "as a plan-format artifact, self-checked through "
                         "planlint like sweep's output")
    sp.set_defaults(fn=cmd_rho)

    sp = sub.add_parser("simulate", help="Monte-Carlo consensus trajectory")
    add_common(sp, mc_default=8)
    sp.add_argument("--budget", type=float, default=0.5)
    _add_overlap_args(sp)
    sp.set_defaults(fn=cmd_simulate)

    sp = sub.add_parser("cost", help="per-matching hop-cost ledger")
    _add_topology_args(sp)
    sp.add_argument("--chips", type=int, default=4)
    sp.set_defaults(fn=cmd_cost)

    sp = sub.add_parser("sweep", help="rank budgets, write the plan artifact")
    add_common(sp)
    sp.add_argument("--budgets", default="0.1,0.25,0.5,1.0")
    sp.add_argument("--out", default="plan.json")
    sp.add_argument("--calibrate", default=None,
                    help="budget_sweep.json to fit the cost model from; its "
                         "runs must come from the same topology and --chips "
                         "being planned, or the fit is meaningless")
    sp.set_defaults(fn=cmd_sweep)

    sp = sub.add_parser("elasticity",
                        help="score join/leave/rejoin policies vs a churn "
                             "trace; write a planlint-verifiable artifact")
    add_common(sp, mc_default=4)
    sp.add_argument("--budget", type=float, default=0.5)
    sp.add_argument("--trace", required=True,
                    help="membership trace JSON (the same file "
                         "train_torch.py --membership-trace consumes)")
    sp.add_argument("--epochs", type=int, default=None,
                    help="simulated epochs (default: trace horizon + 3)")
    sp.add_argument("--steps-per-epoch", type=int, default=16,
                    dest="steps_per_epoch")
    sp.add_argument("--hysteresis", default="0,2",
                    help="comma list of re-plan hysteresis values to score "
                         "(0 = eager)")
    sp.add_argument("--out", default=None,
                    help="write the plan-format elasticity artifact here")
    sp.set_defaults(fn=cmd_elasticity)

    sp = sub.add_parser("verify", help="plan vs a real run's Recorder CSVs")
    sp.add_argument("--plan", required=True)
    sp.add_argument("--run-dir", required=True, dest="run_dir")
    sp.add_argument("--steps-per-epoch", type=int, required=True,
                    dest="steps_per_epoch")
    sp.add_argument("--rank", type=int, default=0)
    sp.add_argument("--link-costs", default=None, dest="link_costs",
                    help="measured_link_costs.json (the attribution plane's) "
                         "to verify against this plan: PL009-011 + "
                         "matching-count cross-check; failures exit 1")
    sp.set_defaults(fn=cmd_verify)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
