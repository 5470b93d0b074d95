"""Link-level attribution: measured per-matching costs from the journal.

Port of ``matcha_tpu/obs/attribution.py``, host numpy on the port's own
``schedule/``, ``topology/`` and ``parallel/folded.py``.  It reads a run's
``events.jsonl`` and adds no device read:

1. The journaled ``run_start`` config pins the schedule generator (graph,
   budget, seed, sampler), so the ``[T, M]`` activation flag stream is
   regenerated bit for bit.
2. Folding the stream per epoch gives the design matrix ``A[E, M]`` of
   per-matching activation counts; the journal's per-epoch comm seconds
   (``epoch`` events, or the heartbeats' comm split) are the response.
3. A ridge fit ``y ≈ c₀·1 + A·θ`` gives per-matching seconds with
   confidence intervals and an identifiability verdict: a matching whose
   count never varies, or moves in lockstep with others, is reported
   unidentifiable instead of as noise.
4. Matching seconds split onto member links through the folded plan's
   chip-offset accounting, weighted ``1 + ring_hops`` per edge.

The result is the planlint-verifiable ``measured_link_costs.json``
artifact (PL009–PL011), which ``plan.cost.CostModel.from_measured_link_costs``
reads, and the ``attribution`` journal event.  The same per-epoch evidence
answers the critical-path question: which host gated each epoch barrier
and what the straggler tax cost against the median host.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .journal import fmt_value, latest_per_epoch

__all__ = [
    "LINK_COSTS_FORMAT",
    "reconstruct_schedule_arrays",
    "design_matrix",
    "estimate_matching_seconds",
    "attribute_run",
    "attribution_event_fields",
    "link_costs_artifact",
    "critical_path_report",
    "render_attribution",
]

#: Artifact format tag — same ``matcha_tpu.`` family as the plan artifact so
#: a drifted tag still lands in the planlint scan (PL009) instead of
#: vanishing from it.
LINK_COSTS_FORMAT = "matcha_tpu.link_costs/1"

_Z95 = 1.959964  # two-sided 95% normal quantile


def _run_start(events: Sequence[dict]) -> dict:
    start = next((e for e in events if e.get("kind") == "run_start"), None)
    if start is None:
        raise ValueError("journal has no run_start event — cannot "
                         "reconstruct the schedule (pre-v1 journal?)")
    return start


def reconstruct_schedule_arrays(config: dict, iterations: int):
    """Regenerate ``(flags, probs, decomposed, size)`` from a journaled
    ``run_start`` config.

    This is the exact generator ``train.build_schedule`` runs — zoo graph or
    seeded generator topology, MATCHA solver or fixed mode, and the seeded
    ``schedule.base.sample_flags`` Bernoulli stream — so the reconstructed
    ``[T, M]`` stream is the one the compiled step actually consumed (the
    cross-check against journaled ``matchings_mean`` is in
    :func:`attribute_run`).  Host-side numpy only; no device.

    Known limit, stated rather than silently wrong: a run under a fault
    plan with *link* outages executed ``flags·link_up`` — the thinning is
    not reconstructed here, and the matchings_mean cross-check is what
    catches the mismatch.
    """
    from ..schedule.fixed import fixed_schedule
    from ..schedule.matcha import matcha_schedule
    from ..topology import decompose, graph_size, make_graph, select_graph

    graphid = config.get("graphid")
    seed = int(config.get("seed", 0))
    if graphid is not None:
        decomposed = select_graph(int(graphid))
        size = graph_size(int(graphid))
    else:
        size = int(config["num_workers"])
        edges = make_graph(config["topology"], size, seed=seed)
        decomposed = decompose(edges, size, seed=seed)
    if config.get("matcha", True):
        schedule = matcha_schedule(decomposed, size, iterations,
                                   budget=float(config.get("budget", 0.5)),
                                   seed=seed)
    else:
        schedule = fixed_schedule(decomposed, size, iterations,
                                  budget=float(config.get("budget", 1.0)),
                                  mode=config.get("fixed_mode", "all"),
                                  seed=seed)
    return schedule.flags, schedule.probs, decomposed, size


def design_matrix(flags: np.ndarray, steps_per_epoch: int,
                  epochs: Sequence[int]) -> np.ndarray:
    """``f64[E, M]`` per-epoch activation counts — epoch ``e`` folds flag
    rows ``[e·spe, (e+1)·spe)``, the exact window the train loop executes
    (``loop.py``'s ``run_flags[epoch*bpe:(epoch+1)*bpe]``)."""
    flags = np.asarray(flags, dtype=np.float64)
    spe = int(steps_per_epoch)
    if spe <= 0:
        raise ValueError(f"steps_per_epoch must be positive, got {spe}")
    A = np.zeros((len(epochs), flags.shape[1]), dtype=np.float64)
    for i, e in enumerate(epochs):
        lo = int(e) * spe
        if lo >= flags.shape[0]:
            raise ValueError(
                f"epoch {e} starts at step {lo} but the reconstructed "
                f"schedule has only {flags.shape[0]} steps")
        A[i] = flags[lo:lo + spe].sum(axis=0)
    return A


def estimate_matching_seconds(A: np.ndarray, y: np.ndarray,
                              ridge: float = 1e-8,
                              collinear_tol: float = 1e-8) -> dict:
    """Ridge fit ``y ≈ c₀ + A·θ`` with a per-matching identifiability mask.

    Identifiability is decided before any number is reported:

    * a column with zero variance across epochs is collinear with the
      intercept — its cost cannot be separated from the per-epoch base;
    * columns spanning a rank-deficient centered design (e.g. two matchings
      whose activation counts move in lockstep, or fewer epochs than
      matchings) are flagged via the SVD null space — every column with
      weight in a ~zero-singular-value direction is unidentifiable;
    * an all-zero response means the run recorded no comm signal at all
      (``measure_comm_split`` off) — *nothing* is identifiable, and the
      reason says so, because fitting exact zeros and reporting "links are
      free" would be noise laundered into fact.

    Only the identifiable columns enter the solve; the rest report ``None``
    seconds.  The intercept is never penalized (ridge shrinks marginal
    costs toward 0, not the base toward 0).  Negative fitted coefficients
    clamp to 0 — the :func:`plan.cost.calibrate_cost_model` rule: a
    negative cost is measurement noise, and PL010 rightly refuses it in
    the artifact.  Returns the flat fit dict ``attribute_run`` embeds.
    """
    A = np.asarray(A, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    E, M = A.shape
    if y.shape != (E,):
        raise ValueError(f"response {y.shape} vs design {A.shape}")
    out = {
        "matchings": int(M),
        "epochs_used": int(E),
        "identifiable": [False] * M,
        "per_matching_seconds": [None] * M,
        "stderr": [None] * M,
        "ci95": [None] * M,
        "base_seconds": float(np.mean(y)) if E else 0.0,
        "base_stderr": None,
        "residual_rms": None,
        "design_rank": 0,
        "condition": None,
        "reason": None,
        "ridge": float(ridge),
    }
    if E < 2:
        out["reason"] = "need at least 2 epochs to separate base from links"
        return out
    if not np.any(y != 0.0):
        out["reason"] = ("no comm signal: every epoch recorded 0 comm "
                         "seconds (measure_comm_split off?)")
        return out
    centered = A - A.mean(axis=0, keepdims=True)
    varying = np.ptp(A, axis=0) > 0.0
    if not varying.any():
        out["reason"] = ("constant design: every epoch activated every "
                         "matching identically — per-matching costs are "
                         "collinear with the per-epoch base")
        return out
    # null-space sweep over the varying columns: any column with weight in
    # a ~zero-singular-value direction trades off against others freely
    sub = centered[:, varying]
    _, s, Vt = np.linalg.svd(sub, full_matrices=True)
    smax = float(s[0]) if s.size else 0.0
    rank = int(np.sum(s > collinear_tol * max(smax, 1.0)))
    ident_sub = np.ones(sub.shape[1], dtype=bool)
    if rank < sub.shape[1]:
        null_weight = np.linalg.norm(Vt[rank:, :], axis=0)
        ident_sub = null_weight <= 1e-6
    identifiable = np.zeros(M, dtype=bool)
    identifiable[np.flatnonzero(varying)[ident_sub]] = True
    out["design_rank"] = rank
    out["condition"] = (float(smax / s[rank - 1]) if rank >= 1 else None)
    if not identifiable.any():
        out["reason"] = ("rank-deficient design: no matching's activation "
                         "count is separable in the observed flag stream")
        return out

    # fit over ALL varying columns (ridge keeps the rank-deficient solve
    # well-posed and picks the minimum-norm solution) and *report* only the
    # identifiable coordinates: dropping collinear columns before the solve
    # would bias every identifiable estimate they correlate with, while the
    # min-norm solution determines the identifiable coordinates exactly
    var_idx = np.flatnonzero(varying)
    X = np.concatenate([np.ones((E, 1)), A[:, var_idx]], axis=1)
    penalty = np.diag([0.0] + [float(ridge)] * len(var_idx))
    G = X.T @ X + penalty
    theta = np.linalg.solve(G, X.T @ y)
    resid = y - X @ theta
    dof = max(E - (1 + rank), 1)
    sigma2 = float(resid @ resid) / dof
    Ginv = np.linalg.inv(G)
    cov = sigma2 * (Ginv @ (X.T @ X) @ Ginv)
    stderr = np.sqrt(np.clip(np.diag(cov), 0.0, None))

    # negative fitted coefficients clamp to 0, same rule (and reason) as
    # plan.cost.calibrate_cost_model: a slightly-negative base or marginal
    # matching cost is timer noise, and an artifact carrying it would fail
    # its own PL010 verifier — so `attribute --out` would exit 1 on exactly
    # the ordinary noisy runs it exists for.  The stderr/ci95 of a clamped
    # coordinate are kept from the raw fit: "indistinguishable from 0,
    # within this band" stays honest.
    out["identifiable"] = [bool(b) for b in identifiable]
    out["base_seconds"] = max(float(theta[0]), 0.0)
    out["base_stderr"] = float(stderr[0])
    out["residual_rms"] = float(np.sqrt(np.mean(resid ** 2)))
    for k, j in enumerate(var_idx):
        if identifiable[j]:
            out["per_matching_seconds"][j] = max(float(theta[1 + k]), 0.0)
            out["stderr"][j] = float(stderr[1 + k])
            out["ci95"][j] = float(_Z95 * stderr[1 + k])
    return out


def _edge_hops(u: int, v: int, size: int, num_chips: int) -> int:
    """Bidirectional-ring hops between the chips holding workers u and v
    under the folded chip-major layout (``build_folded_plan``'s rule)."""
    C = int(num_chips)
    L = size // C
    d = ((v // L) - (u // L)) % C
    return min(d, C - d)


def _per_link(decomposed, size: int, per_matching_seconds,
              num_chips: int = 1) -> List[dict]:
    """Decompose matching seconds onto member links.

    Membership and hop pricing come from the folded execution plan: each
    edge's share of its matching's seconds is ``(1 + ring_hops)`` weighted —
    a chip-local edge costs the on-chip gather share, an inter-chip edge
    additionally absorbs its ``ppermute`` hops.  ``num_chips=1`` (every edge
    local) degrades to a uniform split.  Unidentifiable matchings carry
    ``None`` per link — the verdict propagates, it is not averaged away.
    """
    if size % max(int(num_chips), 1):
        raise ValueError(f"N={size} not divisible by num_chips={num_chips}")
    links: List[dict] = []
    for j, matching in enumerate(decomposed):
        edges = [tuple(int(x) for x in e) for e in matching]
        if not edges:
            continue
        secs = per_matching_seconds[j]
        hops = [_edge_hops(u, v, size, num_chips) for (u, v) in edges]
        weights = np.asarray([1.0 + h for h in hops], dtype=np.float64)
        shares = weights / weights.sum()
        for (u, v), h, share in zip(edges, hops, shares):
            links.append({
                "u": u, "v": v, "matching": j, "hops": int(h),
                "seconds": None if secs is None else float(secs * share),
            })
    return links


def _folded_hop_check(decomposed, size: int, num_chips: int) -> bool:
    """Pin the hop arithmetic to the execution plan itself: per matching,
    the distinct nonzero-offset hop sum must equal
    ``FoldedPlan.matching_hop_units``."""
    from ..parallel.folded import build_folded_plan
    from ..topology import matchings_to_perms

    perms = matchings_to_perms([list(m) for m in decomposed], size)
    plan_units = build_folded_plan(perms, num_chips).matching_hop_units()
    C, L = int(num_chips), size // int(num_chips)
    for j, matching in enumerate(decomposed):
        offs = {((int(v) // L) - (int(u) // L)) % C for (u, v) in matching}
        mine = sum(min(d, C - d) for d in offs if d)
        if abs(mine - float(plan_units[j])) > 1e-9:
            return False
    return True


def _comm_series(events: Sequence[dict], epochs: Sequence[int]
                 ) -> Tuple[np.ndarray, str]:
    """Per-epoch comm seconds + a source tag.

    ``epoch`` events carry the run's two-program comm split; when every one
    is zero (``measure_comm_split`` off) the heartbeat mirror is the
    fallback — summed across hosts per epoch, since the barrier waits for
    the sum of every host's exchange time.
    """
    ep = latest_per_epoch(events, "epoch")
    y = np.asarray([float((ep.get(e) or {}).get("comm_time") or 0.0)
                    for e in epochs], dtype=np.float64)
    if np.any(y != 0.0):
        return y, "journal:epoch.comm_time"
    hb = latest_per_epoch(events, "heartbeat",
                          key=lambda e: str(e.get("host")))
    if hb:
        by_epoch: Dict[int, float] = {}
        for (e, _host), rec in hb.items():
            by_epoch[e] = by_epoch.get(e, 0.0) + float(
                rec.get("comm_time") or 0.0)
        y = np.asarray([by_epoch.get(e, 0.0) for e in epochs], np.float64)
        if np.any(y != 0.0):
            return y, "journal:heartbeat.comm_time"
    return y, "journal:epoch.comm_time"


def attribute_run(events: Sequence[dict], *,
                  comm_seconds=None,
                  steps_per_epoch: Optional[int] = None,
                  ridge: float = 1e-8,
                  num_chips: int = 1,
                  source: Optional[str] = None) -> dict:
    """The attribution plane end-to-end over one journal's event list.

    Reconstructs the flag stream from the journaled schedule seed, folds it
    into the per-epoch design matrix, regresses the per-epoch comm seconds
    (``comm_seconds`` overrides — a planted scenario or an external timer —
    as a list aligned with the journal's epoch order), and returns the full
    report: fit + identifiability + per-link decomposition + the
    matchings_mean cross-check + the critical-path table when heartbeats
    exist.  Raises ``ValueError`` when the journal cannot support the
    estimate at all (no run_start, no epochs).
    """
    start = _run_start(events)
    config = start.get("config", {})
    predicted = start.get("predicted", {})
    spe = int(steps_per_epoch or predicted.get("steps_per_epoch") or 0)
    if spe <= 0:
        _, steps = _telemetry_steps(events)
        spe = int(steps[0]) if steps else 0
    if spe <= 0:
        raise ValueError("cannot resolve steps_per_epoch: pass it "
                         "explicitly (journal predates the predicted "
                         "record and has no telemetry)")
    epochs = sorted(latest_per_epoch(events, "epoch"))
    if not epochs:
        epochs = sorted(latest_per_epoch(events, "telemetry"))
    if len(epochs) < 2:
        raise ValueError(f"journal holds {len(epochs)} epoch record(s); "
                         f"attribution needs at least 2")
    iterations = (max(epochs) + 1) * spe + 1
    flags, probs, decomposed, size = reconstruct_schedule_arrays(
        config, iterations)
    A = design_matrix(flags, spe, epochs)

    if comm_seconds is not None:
        y = np.asarray(list(comm_seconds), dtype=np.float64)
        if y.shape != (len(epochs),):
            raise ValueError(f"comm_seconds has {y.shape[0]} entries for "
                             f"{len(epochs)} journal epochs")
        src = source or "override"
    else:
        y, src = _comm_series(events, epochs)
        if source:
            src = source

    fit = estimate_matching_seconds(A, y, ridge=ridge)

    # cross-check the reconstruction against the journaled telemetry: the
    # device-side counter's per-epoch mean active matchings must equal the
    # reconstructed design row means (a mismatch means the executed stream
    # was not the one reconstructed — link-fault thinning, foreign seed)
    tel = latest_per_epoch(events, "telemetry")
    errs = [abs(float(A[i].sum()) / spe
                - float(tel[e].get("matchings_mean") or 0.0))
            for i, e in enumerate(epochs) if e in tel]
    flags_check = {
        "epochs_checked": len(errs),
        "max_abs_err": float(max(errs)) if errs else None,
        "consistent": bool(not errs or max(errs) <= 1e-6),
    }

    report = {
        "source": src,
        "schedule": {
            "graphid": config.get("graphid"),
            "topology": config.get("topology"),
            "num_workers": int(size),
            "budget": float(config.get("budget", 0.0)),
            "seed": int(config.get("seed", 0)),
            "matcha": bool(config.get("matcha", True)),
            "num_matchings": int(len(decomposed)),
        },
        "steps_per_epoch": spe,
        "num_chips": int(num_chips),
        "epochs": [int(e) for e in epochs],
        "activations": [float(a) for a in A.sum(axis=0)],
        "probs": [float(p) for p in probs],
        "flags_check": flags_check,
        "hop_check_vs_folded_plan": _folded_hop_check(
            decomposed, size, num_chips),
        **fit,
        "per_link": _per_link(decomposed, size,
                              fit["per_matching_seconds"], num_chips),
    }
    cp = critical_path_report(events, fit=fit, design=A, epochs=epochs)
    if cp["rows"]:
        report["critical_path"] = cp
    return report


def _telemetry_steps(events):
    from .journal import epoch_series

    return epoch_series(events, "telemetry", "steps")


def link_costs_artifact(report: dict) -> dict:
    """The committable ``measured_link_costs.json`` payload (PL009–PL011).

    A pure projection of the attribution report — same numbers, artifact
    framing: format tag, per-matching table, per-link table, and the
    identifiability block planlint re-checks.
    """
    return {
        "format": LINK_COSTS_FORMAT,
        "source": report["source"],
        "schedule": dict(report["schedule"]),
        "steps_per_epoch": int(report["steps_per_epoch"]),
        "num_chips": int(report["num_chips"]),
        "epochs_used": int(report["epochs_used"]),
        "ridge": float(report["ridge"]),
        "base_seconds": float(report["base_seconds"]),
        "base_stderr": report["base_stderr"],
        "residual_rms": report["residual_rms"],
        "design_rank": int(report["design_rank"]),
        "condition": report["condition"],
        "reason": report["reason"],
        "per_matching": [
            {"matching": j,
             "seconds": report["per_matching_seconds"][j],
             "stderr": report["stderr"][j],
             "ci95": report["ci95"][j],
             "identifiable": bool(report["identifiable"][j]),
             "activations": float(report["activations"][j])}
            for j in range(report["matchings"])
        ],
        "per_link": [dict(l) for l in report["per_link"]],
    }


def attribution_event_fields(report: dict) -> dict:
    """The schema-v4 ``attribution`` journal payload for one report."""
    return {
        "epochs_used": int(report["epochs_used"]),
        "matchings": int(report["matchings"]),
        "identifiable": [bool(b) for b in report["identifiable"]],
        "base_seconds": float(report["base_seconds"]),
        "per_matching_seconds": [
            None if s is None else float(s)
            for s in report["per_matching_seconds"]],
        "source": str(report["source"]),
    }


# ---------------------------------------------------------------- critical path

def critical_path_report(events: Sequence[dict], *,
                         heartbeats_by_host: Optional[Dict[str, List[dict]]]
                         = None,
                         fit: Optional[dict] = None,
                         design: Optional[np.ndarray] = None,
                         epochs: Optional[Sequence[int]] = None) -> dict:
    """Per-epoch barrier attribution: who gated, and what it cost.

    Every epoch boundary is a fleet-wide barrier, so the epoch takes as
    long as its slowest host; the *straggler tax* is that host's epoch
    seconds minus the fleet median — the wall-clock a perfectly balanced
    fleet would have saved.  Evidence is the per-host heartbeat mirror
    (``comp_time + comm_time``); pass ``heartbeats_by_host`` (the
    ``read_heartbeats`` shape) to analyze live files instead of the
    journal.  With an estimator ``fit`` + ``design`` the gating epoch is
    additionally attributed to the identifiable matching that contributed
    the most estimated seconds that epoch (``None`` when nothing is
    identifiable — the verdict is never invented).
    """
    per_epoch_host: Dict[int, Dict[str, float]] = {}
    if heartbeats_by_host:
        for host, records in heartbeats_by_host.items():
            for rec in records:
                e = int(rec.get("epoch", -1))
                per_epoch_host.setdefault(e, {})[host] = (
                    float(rec.get("comp_time") or 0.0)
                    + float(rec.get("comm_time") or 0.0))
    else:
        hb = latest_per_epoch(events, "heartbeat",
                              key=lambda e: str(e.get("host")))
        for (e, host), rec in hb.items():
            per_epoch_host.setdefault(int(e), {})[host] = (
                float(rec.get("comp_time") or 0.0)
                + float(rec.get("comm_time") or 0.0))

    theta = None
    if fit is not None and design is not None and epochs is not None:
        theta = np.asarray([
            s if (s is not None and ident) else np.nan
            for s, ident in zip(fit["per_matching_seconds"],
                                fit["identifiable"])], dtype=np.float64)
        epoch_row = {int(e): i for i, e in enumerate(epochs)}

    rows = []
    tax_by_host: Dict[str, float] = {}
    for e in sorted(per_epoch_host):
        hosts = per_epoch_host[e]
        times = np.asarray(list(hosts.values()), dtype=np.float64)
        gate = max(hosts, key=lambda h: hosts[h])
        median = float(np.median(times))
        tax = max(float(hosts[gate]) - median, 0.0)
        tax_by_host[gate] = tax_by_host.get(gate, 0.0) + tax
        top_matching = top_matching_seconds = None
        if theta is not None and e in epoch_row and np.any(
                np.isfinite(theta)):
            contrib = design[epoch_row[e]] * theta
            if np.any(np.isfinite(contrib)):
                j = int(np.nanargmax(contrib))
                if np.isfinite(contrib[j]):
                    top_matching = j
                    top_matching_seconds = float(contrib[j])
        rows.append({
            "epoch": int(e),
            "gated_by": gate,
            "gate_seconds": float(hosts[gate]),
            "median_seconds": median,
            "tax_seconds": tax,
            "top_matching": top_matching,
            "top_matching_seconds": top_matching_seconds,
        })
    return {
        "rows": rows,
        "total_tax_seconds": float(sum(r["tax_seconds"] for r in rows)),
        "tax_by_host": {h: float(v) for h, v in sorted(tax_by_host.items())},
    }


# ---------------------------------------------------------------- rendering

_fmt = fmt_value


def render_attribution(report: dict, markdown: bool = False) -> str:
    """Terminal / markdown view of one attribution report."""
    sched = report["schedule"]
    topo = (f"graphid {sched['graphid']}" if sched.get("graphid") is not None
            else f"{sched.get('topology')}-{sched['num_workers']}")
    n_ident = sum(1 for b in report["identifiable"] if b)
    head = (f"link attribution: {topo}, budget {sched['budget']:g}, "
            f"{report['matchings']} matchings, "
            f"{report['epochs_used']} epochs ({report['source']})")
    verdict = (f"{n_ident}/{report['matchings']} matchings identifiable"
               + (f" — {report['reason']}" if report["reason"] else ""))
    cols = ("matching", "seconds", "ci95", "identifiable", "activations")

    def cells(j):
        return (str(j), _fmt(report["per_matching_seconds"][j]),
                _fmt(report["ci95"][j]),
                "yes" if report["identifiable"][j] else "NO",
                _fmt(report["activations"][j], 6))

    rows = [cells(j) for j in range(report["matchings"])]
    cp = report.get("critical_path")
    if markdown:
        lines = ["# Link attribution", "", f"- {head}",
                 f"- verdict: **{verdict}**",
                 f"- base: {_fmt(report['base_seconds'])} s/epoch, "
                 f"residual rms {_fmt(report['residual_rms'])}", "",
                 "| " + " | ".join(cols) + " |",
                 "|" + "|".join("---" for _ in cols) + "|"]
        lines += ["| " + " | ".join(r) + " |" for r in rows]
        if cp:
            lines += ["", "## Critical path", "",
                      f"- total straggler tax: "
                      f"**{_fmt(cp['total_tax_seconds'])} s** "
                      f"(by host: {json.dumps(cp['tax_by_host'])})"]
            lines += [f"- e{r['epoch']}: gated by **{r['gated_by']}** "
                      f"({_fmt(r['gate_seconds'])} s vs median "
                      f"{_fmt(r['median_seconds'])} s, tax "
                      f"{_fmt(r['tax_seconds'])} s"
                      + (f"; top matching {r['top_matching']}"
                         if r["top_matching"] is not None else "") + ")"
                      for r in cp["rows"]]
        return "\n".join(lines) + "\n"
    widths = [max(len(c), *(len(r[i]) for r in rows)) if rows else len(c)
              for i, c in enumerate(cols)]
    lines = [head,
             f"base {_fmt(report['base_seconds'])} s/epoch, residual rms "
             f"{_fmt(report['residual_rms'])}",
             " ".join(c.ljust(w) for c, w in zip(cols, widths))]
    lines += [" ".join(c.ljust(w) for c, w in zip(r, widths)) for r in rows]
    if cp:
        lines.append(f"critical path: total tax "
                     f"{_fmt(cp['total_tax_seconds'])} s")
        for r in cp["rows"]:
            lines.append(
                f"  e{r['epoch']}: {r['gated_by']} "
                f"({_fmt(r['gate_seconds'])} s, tax "
                f"{_fmt(r['tax_seconds'])} s"
                + (f", top matching {r['top_matching']}"
                   if r["top_matching"] is not None else "") + ")")
    lines.append(f"verdict: {verdict}")
    return "\n".join(lines)
