"""planlint — numeric verification of committed plan artifacts.

A copy of ``matcha_tpu/analysis/planlint.py`` on the port's planner, with
the same checks, the same messages and the same format tags, so the two
packages give the same verdict on the same file.  A plan JSON
(``matcha_tpu.plan/1``, written by ``plan_torch.py sweep``) is a
reviewed input to training: ``apply_plan`` resolves its budget, graph and
seed straight into the run, so a tampered or bit-rotted artifact is a
schedule fault no unit test sees.  Every check re-derives what the
artifact claims through the code training runs
(``plan.autotune.resolve_topology`` → the ``topology`` builders):

=======  ==================================================================
PL001    artifact structure (format tag, chosen/candidate keys)
PL002    the topology regenerates: the graph spec resolves, and the worker
         and matching counts match the stored solver outputs
PL003    matchings are matchings (vertex-disjoint edges) and their
         permutation tables are involutions
PL004    every mixing draw ``W_S = I − α·Σ_{j∈S} L_j`` is symmetric doubly
         stochastic to 1e-6 (symmetry and the sums are linear in the draw,
         so the singleton draws and the all-on draw cover all 2^M
         subsets; entry nonnegativity is not required)
PL005    α lies in ``[0, 2/λ_max(E[L])]``
PL006    stored predictions re-derive: ρ from (L, p, α), steps-to-target
         from ρ, the expected comm fraction from p
PL007    probabilities feasible: ``0 ≤ p ≤ 1``, ``Σp ≤ M·budget``
PL008    chosen is a candidate and ranks first under the (score, budget)
         order
=======  ==================================================================

The ``measured_link_costs.json`` family (``matcha_tpu.link_costs/1``,
per-matching and per-link seconds measured by the JAX package's
attribution plane) verifies under its own rules:

=======  ==================================================================
PL009    structure (format tag, schedule block, per-matching table)
PL010    costs sane and anchored to the regenerated plan: matching ids
         0..M−1, finite non-negative seconds and base, every per-link row
         an edge of its matching, link shares summing to the matching's
         seconds
PL011    identifiability honest: unidentifiable matchings carry null
         seconds, identifiable ones finite non-negative stderr/ci95, no
         ci95 ≥ 100× the estimate + base
=======  ==================================================================

Tolerances are 1e-6 absolute unless a check says otherwise.
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "LINK_COSTS_FORMAT",
    "Violation",
    "PLAN_CHECKS",
    "discover_plan_files",
    "lint_link_costs_data",
    "lint_plan_data",
    "lint_plan_file",
    "lint_plan_paths",
    "render_plan_text",
]

@dataclasses.dataclass(frozen=True)
class Violation:
    """One rule hit, anchored to a file:line: a copy of
    ``matcha_tpu/analysis/engine.py: Violation`` (:66), so the port's
    findings compare equal to the JAX package's."""

    rule: str
    path: str
    line: int
    col: int
    message: str

    def key(self) -> Tuple[str, str, int]:
        """Baseline identity: rule + file + line."""
        return (self.rule, self.path, self.line)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


#: the measured-link-costs format tag (``matcha_tpu.obs.attribution``)
LINK_COSTS_FORMAT = "matcha_tpu.link_costs/1"

PLAN_CHECKS = {
    "PL001": "artifact structure (format tag, chosen/candidate keys)",
    "PL002": "topology regenerates to the stored worker/matching counts",
    "PL003": "matchings vertex-disjoint; perm tables are involutions",
    "PL004": "every mixing draw symmetric doubly stochastic (1e-6)",
    "PL005": "alpha within the spectral validity window [0, 2/λmax(E[L])]",
    "PL006": "stored rho/steps/comm-fraction re-derive from (L, p, alpha)",
    "PL007": "activation probabilities feasible for the stored budget",
    "PL008": "chosen is a candidate and ranks first by (score, budget)",
    "PL009": "link-costs artifact structure (format, schedule, tables)",
    "PL010": "link costs non-negative and anchored to the regenerated plan",
    "PL011": "identifiability honest (null when unidentifiable, sane CIs)",
}

_TOL = 1e-6


def _v(rule: str, path: str, message: str, line: int = 0) -> Violation:
    return Violation(rule=rule, path=path, line=line, col=0, message=message)


def _candidate_label(i: Optional[int]) -> str:
    return "chosen" if i is None else f"candidates[{i}]"


def _check_candidate(cand: dict, target: float, path: str,
                     label: str) -> List[Violation]:
    from ..plan.autotune import resolve_topology
    from ..plan.spectral import steps_to_consensus
    from ..schedule.solvers import contraction_rho
    from ..topology import (
        matching_laplacians,
        matchings_to_perms,
        validate_matching,
    )

    out: List[Violation] = []
    required = {"num_workers", "budget", "seed", "alpha", "probs", "rho"}
    missing = sorted(required - set(cand))
    if missing:
        return [_v("PL001", path, f"{label}: missing keys {missing}")]

    # ---- PL002: the generating topology must regenerate -------------------
    try:
        decomposed, size, _ = resolve_topology(cand, int(cand["seed"]))
    except Exception as e:  # unknown graphid / generator / bad spec
        return [_v("PL002", path,
                   f"{label}: topology spec does not resolve: {e}")]
    probs = np.asarray(cand["probs"], dtype=np.float64)
    if size != int(cand["num_workers"]):
        out.append(_v("PL002", path,
                      f"{label}: topology resolves to {size} workers but "
                      f"artifact stores num_workers={cand['num_workers']}"))
    if len(decomposed) != probs.shape[0]:
        out.append(_v(
            "PL002", path,
            f"{label}: topology decomposes into {len(decomposed)} matchings "
            f"but artifact stores {probs.shape[0]} probabilities — the "
            f"solver outputs do not belong to this graph"))
        return out  # everything downstream indexes matchings by j

    # ---- PL003: matchings + involutions -----------------------------------
    for j, matching in enumerate(decomposed):
        try:
            validate_matching(matching, size)
        except ValueError as e:
            out.append(_v("PL003", path,
                          f"{label}: matching {j} invalid: {e}"))
    perms = matchings_to_perms(decomposed, size)
    for j in range(perms.shape[0]):
        pi = perms[j]
        if not np.array_equal(pi[pi], np.arange(size)):
            out.append(_v(
                "PL003", path,
                f"{label}: matching {j}'s permutation table is not an "
                f"involution — as a ppermute table it would one-sidedly "
                f"move blocks (silent ICI corruption)"))

    alpha = float(cand["alpha"])
    # NaN/inf sail straight through `>` tolerance comparisons (every NaN
    # compare is False) — reject them explicitly before the numeric checks
    if not math.isfinite(alpha):
        out.append(_v("PL005", path, f"{label}: alpha = {alpha} is not "
                                     f"finite"))
        return out
    if probs.size and not np.all(np.isfinite(probs)):
        out.append(_v("PL007", path,
                      f"{label}: non-finite activation probabilities"))
        return out
    Ls = matching_laplacians(decomposed, size)

    # ---- PL004: doubly stochastic under any draw --------------------------
    # symmetry and row/col sums are linear in the draw, so the singleton
    # draws + the all-on draw prove every one of the 2^M subsets (module
    # docstring; entry nonnegativity is deliberately not required)
    draws = [(f"matching-{j}", np.eye(size) - alpha * Ls[j])
             for j in range(Ls.shape[0])]
    draws.append(("all-on", np.eye(size) - alpha * Ls.sum(axis=0)))
    for draw_name, W in draws:
        sym_err = float(np.max(np.abs(W - W.T)))
        row_err = float(np.max(np.abs(W.sum(axis=1) - 1.0)))
        col_err = float(np.max(np.abs(W.sum(axis=0) - 1.0)))
        if sym_err > _TOL:
            out.append(_v("PL004", path,
                          f"{label}: {draw_name} mixing draw asymmetric "
                          f"(max |W−Wᵀ| = {sym_err:.2e})"))
        if row_err > _TOL or col_err > _TOL:
            out.append(_v(
                "PL004", path,
                f"{label}: {draw_name} mixing draw not doubly stochastic "
                f"(row err {row_err:.2e}, col err {col_err:.2e}) — "
                f"worker-mean preservation fails on this flag draw"))

    # ---- PL005: alpha window ----------------------------------------------
    mean_L = np.tensordot(probs, Ls, axes=1)
    lam_max = float(np.linalg.eigvalsh(mean_L)[-1]) if size > 1 else 0.0
    if alpha < -_TOL:
        out.append(_v("PL005", path, f"{label}: alpha = {alpha} < 0"))
    elif lam_max > 1e-12 and alpha > 2.0 / lam_max + _TOL:
        out.append(_v(
            "PL005", path,
            f"{label}: alpha = {alpha:.6g} outside the spectral validity "
            f"window [0, {2.0 / lam_max:.6g}] — beyond 2/λmax(E[L]) the "
            f"contraction quadratic has λ ≥ 1 and ρ < 1 is impossible"))

    # ---- PL006: stored predictions re-derive ------------------------------
    rho_stored = float(cand["rho"])
    rho_now = float(contraction_rho(Ls, probs, alpha))
    if abs(rho_now - rho_stored) > max(_TOL, 1e-6 * abs(rho_now)):
        out.append(_v(
            "PL006", path,
            f"{label}: stored rho {rho_stored:.9g} does not re-derive from "
            f"(L, p, alpha): {rho_now:.9g} — solver outputs and schedule "
            f"inputs have been edited independently"))
    else:
        steps_stored = cand.get("steps_to_target")
        steps_now = steps_to_consensus(rho_now, target)
        if steps_stored is None:
            if not math.isinf(steps_now):
                out.append(_v("PL006", path,
                              f"{label}: steps_to_target stored as null but "
                              f"rho {rho_now:.4g} < 1 gives {steps_now:.4g}"))
        elif math.isinf(steps_now) or abs(steps_now - float(steps_stored)) \
                > max(_TOL, 1e-6 * abs(steps_now)):
            out.append(_v(
                "PL006", path,
                f"{label}: stored steps_to_target {steps_stored} does not "
                f"re-derive from rho (expected {steps_now:.9g})"))
    frac = cand.get("expected_comm_fraction")
    if frac is not None and abs(float(frac) - float(probs.mean())) > _TOL:
        out.append(_v("PL006", path,
                      f"{label}: expected_comm_fraction {frac} != "
                      f"mean(probs) {float(probs.mean()):.9g}"))

    # ---- PL007: probability feasibility -----------------------------------
    if probs.size and (probs.min() < -_TOL or probs.max() > 1.0 + _TOL):
        out.append(_v("PL007", path,
                      f"{label}: probabilities outside [0, 1] "
                      f"(min {probs.min():.3g}, max {probs.max():.3g})"))
    budget = float(cand["budget"])
    cap = probs.shape[0] * budget
    if float(probs.sum()) > cap + 1e-4:  # solver cap is exact up to its own
        # bisection tolerance; 1e-4 absolute keeps honest artifacts passing
        out.append(_v("PL007", path,
                      f"{label}: Σp = {float(probs.sum()):.6g} exceeds the "
                      f"budget cap M·budget = {cap:.6g}"))
    return out


_SCHEDULE_KEYS = ("graphid", "topology", "num_workers", "budget", "seed",
                  "alpha", "rho")


def _score(cand: dict) -> float:
    s = cand.get("predicted_seconds_to_target")
    return math.inf if s is None else float(s)


def lint_plan_data(data: dict, path: str) -> List[Violation]:
    """Verify one parsed plan artifact; returns PL violations (empty=valid)."""
    from ..plan.artifact import PLAN_FORMAT

    if data.get("format") != PLAN_FORMAT:
        return [_v("PL001", path,
                   f"format {data.get('format')!r} is not {PLAN_FORMAT!r}")]
    if "chosen" not in data or not isinstance(data.get("chosen"), dict):
        return [_v("PL001", path, "artifact has no chosen candidate")]
    target = float(data.get("target_consensus", 1e-3))
    out: List[Violation] = []
    out.extend(_check_candidate(dict(data["chosen"]), target, path, "chosen"))
    candidates = [dict(c) for c in data.get("candidates", [])]
    for i, cand in enumerate(candidates):
        out.extend(_check_candidate(cand, target, path, _candidate_label(i)))

    # ---- PL008: chosen ∈ candidates, ranked first -------------------------
    if candidates:
        chosen = dict(data["chosen"])

        def key(c: dict) -> tuple:
            return tuple(c.get(k) for k in _SCHEDULE_KEYS)

        if key(chosen) not in {key(c) for c in candidates}:
            out.append(_v(
                "PL008", path,
                "chosen candidate does not appear in the candidate list — "
                "the ranking and the resolution have been edited apart"))
        ranked = sorted(candidates,
                        key=lambda c: (_score(c), float(c.get("budget", 0))))
        if key(chosen) != key(ranked[0]):
            out.append(_v(
                "PL008", path,
                f"chosen (budget {chosen.get('budget')}) is not the "
                f"best-ranked candidate (budget {ranked[0].get('budget')}, "
                f"score {_score(ranked[0]):.6g}) under the documented "
                f"(score, budget) order"))
    return out


def lint_link_costs_data(data: dict, path: str) -> List[Violation]:
    """Verify one parsed ``measured_link_costs.json`` artifact (PL009–011).

    Like the PL002 family, everything is re-derived from first principles:
    the schedule block resolves through the same topology builders the
    attribution estimator (and training) use, so a tampered matching table
    cannot hide behind a stale decomposition.
    """
    from ..plan.autotune import resolve_topology

    # ---- PL009: structure -------------------------------------------------
    if data.get("format") != LINK_COSTS_FORMAT:
        return [_v("PL009", path, f"format {data.get('format')!r} is not "
                                  f"{LINK_COSTS_FORMAT!r}")]
    missing = sorted({"schedule", "per_matching", "per_link",
                      "base_seconds", "epochs_used"} - set(data))
    if missing:
        return [_v("PL009", path, f"missing keys {missing}")]
    per = data["per_matching"]
    if not isinstance(per, list) or not per:
        return [_v("PL009", path, "per_matching is not a non-empty list")]
    if not all(isinstance(r, dict) for r in per):
        return [_v("PL009", path, "per_matching rows are not objects")]
    row_missing = sorted({"matching", "seconds", "identifiable", "ci95"}
                         - set(per[0]))
    if row_missing:
        return [_v("PL009", path,
                   f"per_matching rows missing {row_missing}")]
    links = data["per_link"]
    if not isinstance(links, list) \
            or not all(isinstance(l, dict) for l in links):
        return [_v("PL009", path, "per_link is not a list of objects")]

    out: List[Violation] = []
    # ---- PL010: anchored to the regenerated plan, costs sane --------------
    sched = dict(data.get("schedule", {}))
    try:
        decomposed, size, _ = resolve_topology(sched,
                                               int(sched.get("seed", 0)))
    except Exception as e:
        return out + [_v("PL010", path,
                         f"schedule spec does not resolve: {e}")]
    M = len(decomposed)
    ids = [r.get("matching") for r in per]
    if ids != list(range(M)):
        out.append(_v("PL010", path,
                      f"matching ids {ids[:8]}{'…' if len(ids) > 8 else ''} "
                      f"are not 0..{M - 1} of the regenerated plan "
                      f"({M} matchings)"))
        return out  # everything below indexes matchings by id
    base = data.get("base_seconds")
    if not isinstance(base, (int, float)) or not math.isfinite(base) \
            or base < -_TOL:
        out.append(_v("PL010", path,
                      f"base_seconds {base!r} is not finite non-negative"))
    for r in per:
        s = r.get("seconds")
        if r.get("identifiable"):
            if not isinstance(s, (int, float)) or not math.isfinite(s) \
                    or s < -_TOL:
                out.append(_v("PL010", path,
                              f"matching {r['matching']}: identifiable "
                              f"seconds {s!r} not finite non-negative"))
    edge_sets = [{tuple(sorted((int(u), int(v)))) for (u, v) in m}
                 for m in decomposed]
    link_sum: dict = {}
    for i, link in enumerate(links):
        j = link.get("matching", -1)
        if not isinstance(j, int) or not 0 <= j < M:
            out.append(_v("PL010", path,
                          f"per_link[{i}]: matching {j!r} out of range"))
            continue
        u, v = link.get("u", -1), link.get("v", -1)
        if not (isinstance(u, int) and isinstance(v, int)):
            out.append(_v("PL010", path,
                          f"per_link[{i}]: edge endpoints "
                          f"({u!r}, {v!r}) are not worker indices"))
            continue
        e = tuple(sorted((u, v)))
        if e not in edge_sets[j]:
            out.append(_v("PL010", path,
                          f"per_link[{i}]: edge {e} is not an edge of "
                          f"matching {j} in the regenerated decomposition"))
        s = link.get("seconds")
        if s is not None:
            if isinstance(s, (int, float)) and math.isfinite(s):
                link_sum[j] = link_sum.get(j, 0.0) + float(s)
            else:
                out.append(_v("PL010", path,
                              f"per_link[{i}]: seconds {s!r} is not a "
                              f"finite number"))
    for r in per:
        j, s = int(r["matching"]), r.get("seconds")
        if r.get("identifiable") and isinstance(s, (int, float)) \
                and abs(link_sum.get(j, 0.0) - float(s)) > max(
                    _TOL, 1e-6 * abs(float(s))):
            out.append(_v("PL010", path,
                          f"matching {j}: per-link shares sum to "
                          f"{link_sum.get(j, 0.0):.9g}, not the matching's "
                          f"{float(s):.9g} — the decomposition leaks cost"))

    # ---- PL011: identifiability honest ------------------------------------
    base_mag = abs(float(base)) if isinstance(base, (int, float)) else 0.0
    for r in per:
        j = r["matching"]
        if not r.get("identifiable"):
            if r.get("seconds") is not None:
                out.append(_v("PL011", path,
                              f"matching {j}: unidentifiable but carries "
                              f"seconds {r['seconds']!r} — noise committed "
                              f"as fact"))
            continue
        for key in ("stderr", "ci95"):
            v = r.get(key)
            if v is None:
                continue
            if not isinstance(v, (int, float)) or not math.isfinite(v) \
                    or v < 0:
                out.append(_v("PL011", path,
                              f"matching {j}: {key} {v!r} not finite "
                              f"non-negative"))
        ci = r.get("ci95")
        s = r.get("seconds")
        if isinstance(ci, (int, float)) and isinstance(s, (int, float)) \
                and math.isfinite(ci) \
                and ci >= 100.0 * (abs(float(s)) + base_mag + 1e-9):
            out.append(_v("PL011", path,
                          f"matching {j}: ci95 {ci:.3g} is >=100x the "
                          f"estimate+base ({abs(float(s)) + base_mag:.3g}) "
                          f"— mark it unidentifiable instead"))
    return out


def _is_planish(data) -> bool:
    """Any version of the plan format family — a *drifted or tampered*
    version tag must surface as PL001, not vanish from the scan."""
    return isinstance(data, dict) \
        and str(data.get("format", "")).startswith("matcha_tpu.plan")


def _is_link_costs(data) -> bool:
    """Any version of the link-costs family — same drifted-tag rule."""
    return isinstance(data, dict) \
        and str(data.get("format", "")).startswith("matcha_tpu.link_costs")


def lint_plan_file(path: str | pathlib.Path) -> Tuple[List[Violation], bool]:
    """``(violations, is_plan)``; ``is_plan`` False when the file is not a
    plan-family artifact at all (other benchmark JSONs live alongside
    them).  Link-costs artifacts route to their own PL009–011 checks."""
    p = pathlib.Path(path)
    try:
        data = json.loads(p.read_text())
    except (OSError, json.JSONDecodeError) as e:
        return [_v("PL001", str(p), f"unreadable: {e}")], True
    if _is_link_costs(data):
        try:
            return lint_link_costs_data(data, str(p)), True
        except Exception as e:  # tampered structure must be a verdict,
            # never a traceback that aborts the whole directory scan
            return [_v("PL009", str(p),
                       f"artifact malformed: {type(e).__name__}: {e}")], True
    if not _is_planish(data):
        return [], False
    return lint_plan_data(data, str(p)), True


def discover_plan_files(paths: Sequence[str | pathlib.Path]
                        ) -> List[pathlib.Path]:
    """Expand files/directories into the plan artifacts they contain
    (directories scan ``*.json`` non-recursively — benchmark directories
    hold flat artifact sets).  Matches the whole ``matcha_tpu.plan`` *and*
    ``matcha_tpu.link_costs`` format families, so an artifact with a wrong
    *version* tag is still scanned (and then fails PL001/PL009) instead of
    silently dropping out."""
    out: List[pathlib.Path] = []
    for p in paths:
        p = pathlib.Path(p)
        candidates = sorted(p.glob("*.json")) if p.is_dir() else [p]
        for f in candidates:
            try:
                data = json.loads(f.read_text())
            except (OSError, json.JSONDecodeError):
                continue
            if _is_planish(data) or _is_link_costs(data):
                out.append(f)
    return out


def lint_plan_paths(paths: Sequence[str | pathlib.Path]
                    ) -> Tuple[List[Violation], List[pathlib.Path]]:
    """Lint every plan artifact under ``paths``; returns
    ``(violations, artifacts checked)``.

    Directory scans silently skip non-plan/unparseable JSONs (benchmark
    outputs live alongside the artifacts), but a file named *explicitly*
    must either verify or produce a violation — "0 artifacts checked" on a
    path the caller typed is a silent lie, whether the file is unparseable
    or simply not a plan artifact (e.g. a fully tampered format tag)."""
    files = discover_plan_files(paths)
    violations: List[Violation] = []
    checked = set(files)
    for p in paths:
        p = pathlib.Path(p)
        if p.is_file() and p not in checked:
            try:
                data = json.loads(p.read_text())
            except (OSError, json.JSONDecodeError) as e:
                violations.append(_v("PL001", str(p), f"unreadable: {e}"))
                continue
            fmt = data.get("format") if isinstance(data, dict) else None
            violations.append(_v(
                "PL001", str(p),
                f"not a plan artifact (format={fmt!r}) — explicitly named "
                f"paths must verify, not vanish from the scan"))
    for f in files:
        vs, _ = lint_plan_file(f)
        violations.extend(vs)
    return violations, files


def render_plan_text(violations: Sequence[Violation],
                     files: Sequence[pathlib.Path]) -> str:
    lines = [f"{v.path}: {v.rule} {v.message}" for v in violations]
    lines.append(
        f"planlint: {len(violations)} violation(s) in "
        f"{len(files)} plan artifact(s)")
    return "\n".join(lines)
