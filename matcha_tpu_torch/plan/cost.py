"""Link-cost model: predict the communication cost of a schedule offline.

A numpy copy of ``matcha_tpu/plan/cost.py``.  The unit of account is the
**ring hop**: moving one card's ``[L, ...]`` block of worker rows
``min(d, C−d)`` hops around a bidirectional ring of ``C`` cards.  The
accounting comes straight from ``FoldedPlan.hop_accounting``
(``parallel/folded.py``), so the model cannot drift from the plan.

The expected per-iteration cost of a schedule is linear in the activation
probabilities, ``E[cost] = Σ_j p_j · hops_j`` hop units.  Turning units
into seconds takes two constants, a fixed per-iteration overhead ``c₀``
and a per-hop-unit time ``c₁``, fitted by least squares from measured
``(units, seconds)`` pairs.  On one card every matching is local
(``hops ≡ 0``): the fit collapses to ``c₀ = mean(measured)`` with ``c₁``
unidentifiable, which is the honest answer there.

Beside it sit the gate ``gossip_backend="auto"`` runs on one card
(:func:`choose_gossip_backend`, with its rule and constants as the JAX
package has them), the loaders of its measured input, and the
bounded-staleness fleet wall-clock model.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..parallel.folded import build_folded_plan
from ..parallel.gossip import resolve_wire_dtype
from ..topology import matchings_to_perms

__all__ = [
    "CostModel",
    "GOSSIP_BACKEND_GATE",
    "PERM_FORCED_WORKERS",
    "matching_comm_units",
    "expected_comm_units",
    "calibrate_cost_model",
    "choose_gossip_backend",
    "gossip_backend_entries",
    "load_measured_comm_times",
    "load_measured_link_costs",
    "load_measured_vs_ceiling",
    "simulate_fleet_wallclock",
    "straggler_step_times",
]


def matching_comm_units(
    decomposed: Sequence[Sequence[tuple]],
    size: int,
    num_chips: int = 1,
    perms: Optional[np.ndarray] = None,
) -> np.ndarray:
    """f64[M] hop-weighted cost of activating each matching once.

    Workers fold card-major onto ``num_chips`` cards (the
    ``build_folded_plan`` layout); each matching costs the ring hops of its
    distinct nonzero card offsets.  ``num_chips=1`` gives all zeros.
    """
    if perms is None:
        perms = matchings_to_perms([list(m) for m in decomposed], size)
    plan = build_folded_plan(np.asarray(perms), num_chips)
    return plan.matching_hop_units()


def expected_comm_units(probs: np.ndarray, unit_costs: np.ndarray) -> float:
    """E[per-iteration hop units] = Σ_j p_j · hops_j (flags are Bernoulli)."""
    p = np.asarray(probs, dtype=np.float64)
    u = np.asarray(unit_costs, dtype=np.float64)
    if p.shape != u.shape:
        raise ValueError(f"probs {p.shape} vs unit costs {u.shape}")
    return float(p @ u)


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Seconds per gossip iteration as an affine function of hop units,
    ``seconds(units) = base_step_s + per_hop_s · units``.

    The defaults are unit-free (base 1, hop 1): rankings by predicted cost
    are then rankings by ``1 + units``, already right in order, and a
    calibration only turns them into wall-clock.  ``fit`` records what fed
    a fitted model (``None`` on the default).
    """

    base_step_s: float = 1.0
    per_hop_s: float = 1.0
    source: str = "uncalibrated"
    fit: Optional[dict] = None

    def step_seconds(self, units: float) -> float:
        return self.base_step_s + self.per_hop_s * float(units)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: dict) -> "CostModel":
        return CostModel(base_step_s=float(d["base_step_s"]),
                         per_hop_s=float(d["per_hop_s"]),
                         source=str(d.get("source", "uncalibrated")),
                         fit=d.get("fit"))

    @staticmethod
    def from_measured_link_costs(data, steps_per_epoch: Optional[int] = None
                                 ) -> "CostModel":
        """The affine model fitted to a ``measured_link_costs.json``
        artifact (a path or the parsed dict).

        The identifiable per-matching seconds (per activation) are regressed
        against the plan's hop units for the artifact's topology and
        ``num_chips``, through :func:`calibrate_cost_model`; the per-epoch
        base overhead folds in as ``base_seconds / steps_per_epoch`` (the
        artifact's own count unless the argument overrides it).  Raises
        ``ValueError`` when no matching is identifiable.
        """
        data, label = load_measured_link_costs(data)
        per = data.get("per_matching", [])
        idx = [int(r["matching"]) for r in per if r.get("identifiable")]
        if not idx:
            raise ValueError(
                f"{label}: no identifiable matching costs "
                f"({data.get('reason') or 'estimator reported none'}) — "
                f"refusing to calibrate from noise")
        sched = data.get("schedule", {})
        from .autotune import resolve_topology

        decomposed, size, _ = resolve_topology(sched,
                                               int(sched.get("seed", 0)))
        units = matching_comm_units(decomposed, size,
                                    int(data.get("num_chips", 1)))
        theta = {int(r["matching"]): float(r["seconds"]) for r in per
                 if r.get("identifiable")}
        samples = [(float(units[j]), theta[j]) for j in idx]
        spe = int(steps_per_epoch or data.get("steps_per_epoch") or 1)
        model = calibrate_cost_model(
            samples, source=f"measured_link_costs:{label}",
            fit={"epochs_used": data.get("epochs_used"),
                 "identifiable_matchings": idx,
                 "comm_source": data.get("source"),
                 "steps_per_epoch": spe})
        base = max(float(data.get("base_seconds", 0.0)) / max(spe, 1), 0.0)
        return dataclasses.replace(
            model, base_step_s=model.base_step_s + base)


def calibrate_cost_model(
    samples: Sequence[Tuple[float, float]], source: str = "measured",
    fit: Optional[dict] = None,
) -> CostModel:
    """Least-squares fit of ``(units, seconds)`` pairs to the affine model.

    With a single distinct units value (every sample at 0 on one card) the
    slope is unidentifiable: ``per_hop_s = 0`` and the base takes the mean.
    A negative fitted coefficient is clamped to 0, since a negative
    marginal hop cost would rank more communication as faster.  The sample
    count, the units range and ``fit`` are recorded as provenance.
    """
    if not samples:
        raise ValueError("need at least one (units, seconds) sample")
    units = np.asarray([s[0] for s in samples], dtype=np.float64)
    secs = np.asarray([s[1] for s in samples], dtype=np.float64)
    provenance = {
        "samples": int(units.shape[0]),
        "units_min": float(units.min()),
        "units_max": float(units.max()),
        **(fit or {}),
    }
    if np.ptp(units) < 1e-12:
        return CostModel(base_step_s=float(secs.mean()), per_hop_s=0.0,
                         source=source + " (slope unidentifiable: "
                                         "single units level)",
                         fit=provenance)
    A = np.stack([np.ones_like(units), units], axis=1)
    (c0, c1), *_ = np.linalg.lstsq(A, secs, rcond=None)
    c0, c1 = max(float(c0), 0.0), max(float(c1), 0.0)
    return CostModel(base_step_s=c0, per_hop_s=c1, source=source,
                     fit=provenance)


# ---------------------------------------------------------------------------
# Per-gossip-backend cost entries and the perm-vs-dense gate
# ---------------------------------------------------------------------------

#: Measured-vs-ceiling ratio at or above which the dense/fused formulation is
#: taken to have no implementation headroom left, so that only a structural
#: change (streaming the [T, M] flags instead of the [T, N, N] W stack) can
#: buy more speed: ``auto`` then picks the permutation form.  The same rule
#: and constant as the JAX package's, so the decision record ``auto``
#: journals is the same on both sides for the same inputs.
GOSSIP_BACKEND_GATE = 0.85

#: Worker count from which the dense W stack is treated as unrepresentable
#: whatever any measurement says: an [N, N] f32 matrix at 4096 workers is
#: 64 MB per step of the stack, where the permutation form streams M flags.
PERM_FORCED_WORKERS = 4096


def gossip_backend_entries(n: int, num_matchings: int,
                           dim: Optional[int] = None,
                           wire_dtype=None, block_d: int = 2048) -> dict:
    """Per-backend streamed bytes for one gossip step of a multi-step
    chain: the ledger the backend choice reads.

    With the state tile held on chip in both kernels, the streamed operand
    per step is what separates them: the fused kernel reads
    ``N²·wire_bytes`` of W per visit of a ``block_d``-column tile, the
    permutation kernel ``M·4`` bytes of flag row (its tables are read once,
    not per step).  With ``dim`` the entries are bytes per step
    (``ceil(D/block_d)`` visits), without it bytes per visit; the ratio is
    the same either way.  With ``dim`` the dense per-step product (the
    state read and written every step) rides along.
    """
    wire = resolve_wire_dtype(wire_dtype)
    wire_bytes = 4 if wire is None else torch.finfo(wire).bits // 8
    visits = 1 if dim is None else -(-int(dim) // int(block_d))
    entries = {
        "fused": {"stream_bytes_per_step": float(visits * n * n * wire_bytes),
                  "streamed": "[T, N, N] mixing stack"},
        "perm": {"stream_bytes_per_step": float(visits * num_matchings * 4),
                 "streamed": "[T, M] flag array",
                 "table_bytes": float(num_matchings * n * (4 + 4))},
    }
    if dim is not None:
        entries["dense"] = {
            "stream_bytes_per_step": float((2.0 * n * dim + n * n)
                                           * wire_bytes),
            "streamed": "full [N, D] state + W_t",
        }
    return entries


def choose_gossip_backend(
    n: int,
    num_matchings: int,
    dim: Optional[int] = None,
    wire_dtype=None,
    block_d: int = 2048,
    budget: Optional[float] = None,
    topology: Optional[str] = None,
    measured_vs_ceiling: Optional[float] = None,
    gate: float = GOSSIP_BACKEND_GATE,
) -> dict:
    """Resolve ``gossip_backend="auto"`` on one card: perm or dense.

    The rule, in order:

    1. ``n >= PERM_FORCED_WORKERS`` → ``perm`` (the W stack is
       unrepresentable; no measurement needed).
    2. ``measured_vs_ceiling >= gate`` (the dense/fused formulation's
       measured time over its bound) → ``perm``.
    3. otherwise → ``dense``, the per-step W-stack product.  With no
       measurement this is always the answer: ``auto`` never promotes an
       unmeasured kernel.

    Returns the whole decision record (chosen backend, reason, both byte
    models, the stream ratio and the gate's inputs) for the journal.
    """
    entries = gossip_backend_entries(n, num_matchings, dim=dim,
                                     wire_dtype=wire_dtype, block_d=block_d)
    perm_b = entries["perm"]["stream_bytes_per_step"]
    fused_b = entries["fused"]["stream_bytes_per_step"]
    ratio = fused_b / max(perm_b, 1.0)
    record = {
        "requested": "auto",
        "n": int(n), "matchings": int(num_matchings),
        "dim": None if dim is None else int(dim),
        "budget": budget, "topology": topology,
        "entries": entries,
        "stream_ratio_fused_over_perm": round(float(ratio), 2),
        "measured_vs_ceiling": measured_vs_ceiling,
        "gate": float(gate),
    }
    if n >= PERM_FORCED_WORKERS:
        record.update(chosen="perm", reason=(
            f"N={n} >= {PERM_FORCED_WORKERS}: the [N, N] W-stack form is "
            f"unrepresentable at this scale; only the flag-stream "
            f"permutation form remains"))
    elif measured_vs_ceiling is not None and measured_vs_ceiling >= gate:
        record.update(chosen="perm", reason=(
            f"measured/ceiling {measured_vs_ceiling:.2f} >= gate "
            f"{gate:.2f}: the dense formulation is at its roofline, and "
            f"the perm form streams {ratio:.0f}x fewer bytes/step"))
    else:
        why = ("no measured-vs-ceiling ratio supplied"
               if measured_vs_ceiling is None else
               f"measured/ceiling {measured_vs_ceiling:.2f} < gate "
               f"{gate:.2f}: headroom remains in the dense form")
        record.update(chosen="dense", reason=(
            f"{why}; auto keeps the committed W-stack path (pass "
            f"gossip_backend='perm' to force the flag-stream kernel)"))
    return record


def load_measured_link_costs(data) -> Tuple[dict, str]:
    """Normalize a ``measured_link_costs.json`` input (a path or the parsed
    dict) to ``(data, label)``, checking its format tag."""
    label = "measured_link_costs"
    if isinstance(data, str):
        label = data
        with open(data) as f:
            data = json.load(f)
    fmt = str(data.get("format", "")) if isinstance(data, dict) else ""
    if not fmt.startswith("matcha_tpu.link_costs"):
        raise ValueError(f"{label}: format {fmt!r} is not a "
                         f"matcha_tpu.link_costs artifact")
    return data, label


def load_measured_vs_ceiling(source: str) -> Tuple[float, dict]:
    """The dense/fused formulation's measured-vs-ceiling ratio from a file:
    the input of :func:`choose_gossip_backend`'s gate.

    Three shapes resolve, the newest record winning: a run journal (JSONL)
    whose ``bench`` events carry a roofline report
    (``measured_vs_ceiling`` with ``measured_vs_ceiling_backend``); a
    ``{"record": {...}}`` capture or raw bench record (the fused/dense
    kernel's ``mfu``); a raw roofline report.  Only dense/fused ratios
    qualify: a perm rate says nothing of the dense form's headroom.
    Returns ``(ratio, provenance)``; raises ``ValueError`` when the file
    has no usable ratio.
    """
    def _from_report(rep: dict, where: str):
        if not isinstance(rep, dict):
            return None
        ratio = rep.get("measured_vs_ceiling")
        backend = rep.get("measured_vs_ceiling_backend",
                          rep.get("backend"))
        if ratio is None:
            ratio = rep.get("mfu")  # bench records: compute-bound MFU
        if ratio is None or backend not in ("dense", "fused"):
            return None
        return float(ratio), {"path": source, "record": where,
                              "backend": str(backend),
                              "measured_vs_ceiling": float(ratio)}

    with open(source) as f:
        text = f.read()
    candidates = []
    try:
        data = json.loads(text)
        if isinstance(data, dict):
            candidates = [data.get("record", data), data,
                          data.get("roofline", {})]
    except json.JSONDecodeError:
        # a JSONL journal: every event, newest last
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                e = json.loads(line)
            except json.JSONDecodeError:
                continue
            rec = e.get("record", e) if isinstance(e, dict) else {}
            if isinstance(rec, dict):
                candidates.append(rec.get("roofline", rec))
    hit = None
    for i, cand in enumerate(candidates):
        got = _from_report(cand, f"entry {i}")
        if got is not None:
            hit = got  # keep scanning: the newest usable record wins
    if hit is None:
        raise ValueError(
            f"{source}: no dense/fused measured-vs-ceiling ratio found "
            f"(want a roofline report's measured_vs_ceiling or a bench "
            f"record's mfu with backend dense|fused) — refusing to gate "
            f"the backend choice on a missing measurement")
    return hit


# ---------------------------------------------------------------------------
# Bounded-staleness fleet wall-clock model
# ---------------------------------------------------------------------------

def straggler_step_times(
    num_workers: int,
    rounds: int,
    base_s: float = 1.0,
    straggler: int = 0,
    period: int = 4,
    slowdown: float = 4.0,
    jitter: float = 0.05,
    seed: int = 0,
) -> np.ndarray:
    """f64[rounds, N] per-worker gossip-round durations with one periodic
    straggler: worker ``straggler`` takes ``slowdown×`` the base every
    ``period``-th round, and every worker carries i.i.d. half-normal
    jitter.  The input of :func:`simulate_fleet_wallclock`."""
    rng = np.random.default_rng(seed)
    t = base_s * (1.0 + jitter * np.abs(rng.standard_normal(
        (int(rounds), int(num_workers)))))
    t[np.arange(int(rounds)) % int(period) == 0, int(straggler)] *= \
        float(slowdown)
    return t


def simulate_fleet_wallclock(
    step_times: np.ndarray, staleness: int = 1, local_steps: int = 1
) -> dict:
    """Fleet wall-clock of a gossip-round schedule under three execution
    models, from per-worker round durations ``f64[rounds, N]``:

    * **barrier** — every round waits for the whole fleet:
      ``Σ_r max_i t[r, i]``;
    * **bounded staleness** — worker i starts round r once it finished
      r−1 and every peer finished round r−k_ev,
      ``T_i(r) = max(T_i(r−1), max_j T_j(r−k_ev)) + t[r, i]`` with
      ``k_ev = ceil(staleness / local_steps)``;
    * **ideal** — no coupling: ``max_i Σ_r t[r, i]``.

    Returns the three totals, ``tax_seconds`` (barrier − ideal),
    ``recovered_seconds`` (barrier − bounded) and ``recovered_fraction``
    (0 when there is no tax).  ``staleness=1, local_steps=1`` is the
    barrier model.
    """
    t = np.asarray(step_times, np.float64)
    if t.ndim != 2:
        raise ValueError(f"step_times must be [rounds, N], got {t.shape}")
    k_ev = max(-(-int(staleness) // max(int(local_steps), 1)), 1)
    rounds, n = t.shape
    barrier = float(np.sum(t.max(axis=1)))
    ideal = float(np.max(t.sum(axis=0)))
    finish = np.zeros((rounds, n))
    for r in range(rounds):
        start = finish[r - 1] if r >= 1 else np.zeros(n)
        if r - k_ev >= 0:
            start = np.maximum(start, float(finish[r - k_ev].max()))
        finish[r] = start + t[r]
    bounded = float(finish[-1].max())
    tax = max(barrier - ideal, 0.0)
    recovered = max(barrier - bounded, 0.0)
    return {
        "rounds": int(rounds),
        "workers": int(n),
        "staleness": int(staleness),
        "local_steps": int(local_steps),
        "event_depth": int(k_ev),
        "barrier_seconds": barrier,
        "bounded_seconds": bounded,
        "ideal_seconds": ideal,
        "tax_seconds": tax,
        "recovered_seconds": recovered,
        "recovered_fraction": (recovered / tax) if tax > 0 else 0.0,
    }


def load_measured_comm_times(path: str) -> list:
    """``[(budget, comm_seconds_per_epoch), ...]`` of the MATCHA runs of a
    ``budget_sweep.json`` summary: the calibration input of
    ``plan_torch.py sweep --calibrate`` (the D-PSGD row has no budget)."""
    with open(path) as f:
        summary = json.load(f)
    out = []
    for run in summary.get("runs", []):
        if run.get("algorithm") == "matcha":
            out.append((float(run["budget"]),
                        float(run["mean_comm_time_per_epoch"])))
    if not out:
        raise ValueError(f"no MATCHA runs with comm timings in {path}")
    return out
