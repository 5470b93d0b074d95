"""Prediction against measurement: hold a plan to a real training run.

A numpy copy of ``matcha_tpu/plan/verify.py`` (:31-206), reading the
journal through the port's ``obs.journal``.  The Recorder writes one
``disagreement`` value per epoch, the epoch mean of ``‖x − x̄‖ / √(N·D)``.
The planner predicts that the squared error contracts by at most ρ per
gossip step, so the RMS disagreement by at most ``ρ^(steps/2)`` per epoch
of ``steps`` steps.  Training injects fresh gradient disagreement every
step, so the measured curve decays toward a floor rather than zero: the
check applies to the epochs still above that floor, and the floor is
reported beside it.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, Optional

import numpy as np

__all__ = ["load_fault_ledger", "load_recorder_disagreement",
           "verify_against_recorder", "verify_plan_run"]


def load_fault_ledger(run_dir: str) -> Optional[Dict]:
    """The run's fault-plan declaration, if it wrote one: the ``plan``
    entry of ``faults.json``, else of the journal ``events.jsonl``; None
    when there is neither.

    A resumed run that changed its fault plan carries several ``plan``
    entries: they merge by elementwise minimum of ``expected_alive`` and
    ``expected_link_up`` (the most degraded declaration wins, so the bound
    is no tighter than any regime the run trained under), falling back to
    the last entry when their shapes disagree.
    """
    path = os.path.join(run_dir, "faults.json")
    if os.path.exists(path):
        with open(path) as f:
            ledger = json.load(f)
        events = ledger.get("events", [])
    else:
        journal = os.path.join(run_dir, "events.jsonl")
        if not os.path.exists(journal):
            return None
        from ..obs.journal import read_journal

        events = read_journal(journal)
    plans = [e for e in events if e.get("kind") == "plan"]
    if not plans:
        return None
    if len(plans) == 1:
        return plans[0]
    merged = dict(plans[-1])
    try:
        merged["expected_alive"] = np.min(
            [p["expected_alive"] for p in plans], axis=0).tolist()
        merged["expected_link_up"] = np.min(
            [p["expected_link_up"] for p in plans], axis=0).tolist()
        merged["name"] = "+".join(dict.fromkeys(
            str(p.get("name", "faultplan")) for p in plans))
        # the merged numbers belong to the union of the declared events
        merged["events"] = [e for p in plans for e in p.get("events", [])]
        merged.pop("recordtime", None)  # no single timestamp is honest
    except (KeyError, ValueError):
        return plans[-1]
    return merged


def load_recorder_disagreement(run_dir: str, rank: int = 0) -> np.ndarray:
    """The per-epoch disagreement series of a Recorder folder: the
    ``...-r{rank}-disagreement.log`` file (every rank holds the same global
    values), one float per recorded epoch."""
    pattern = os.path.join(run_dir, f"*-r{rank}-disagreement.log")
    matches = sorted(glob.glob(pattern))
    if not matches:
        raise FileNotFoundError(
            f"no Recorder disagreement log matches {pattern}; was the run "
            f"saved (TrainConfig.save / --save)?")
    if len(matches) > 1:
        # one folder can hold several runs' files: scoring whichever sorts
        # first would score the wrong run
        raise ValueError(
            f"{run_dir} holds disagreement logs from {len(matches)} runs "
            f"({', '.join(os.path.basename(m) for m in matches)}); point "
            f"--run-dir at a single run's directory")
    series = np.loadtxt(matches[0], delimiter=",", ndmin=1)
    return np.asarray(series, dtype=np.float64)


def verify_against_recorder(
    rho: float,
    disagreement: np.ndarray,
    steps_per_epoch: int,
    floor_quantile: float = 0.25,
    slack: float = 1.5,
) -> Dict:
    """Compare the measured per-epoch contraction of the disagreement with
    the ρ bound.

    The report holds ``predicted_epoch_factor`` (ρ^(steps/2), the bound on
    one epoch's RMS contraction under pure gossip),
    ``measured_epoch_factors`` (``d[e+1] / d[e]``), ``floor`` (a tail
    quantile of the series, the drift floor's estimate),
    ``checked_epochs`` (the pairs still at ``slack × floor`` or above),
    ``violations`` (checked pairs that contracted slower than the bound)
    and ``consistent`` (no violation; vacuously true when nothing was
    checked, which ``checked_epochs`` shows).
    """
    d = np.asarray(disagreement, dtype=np.float64)
    if d.ndim != 1 or len(d) < 2:
        raise ValueError("need a 1-D disagreement series with >= 2 epochs")
    if not 0 < floor_quantile <= 1:
        raise ValueError("floor_quantile must be in (0, 1]")
    predicted = float(rho) ** (steps_per_epoch / 2.0) if rho < 1 else 1.0
    with np.errstate(divide="ignore", invalid="ignore"):
        factors = d[1:] / np.maximum(d[:-1], 1e-300)
    floor = float(np.quantile(d, floor_quantile))
    above = d[:-1] >= slack * floor
    checked = int(above.sum())
    violations = int(np.sum(factors[above] > predicted))
    return {
        "rho": float(rho),
        "steps_per_epoch": int(steps_per_epoch),
        "predicted_epoch_factor": predicted,
        "measured_epoch_factors": [float(f) for f in factors],
        "disagreement": [float(v) for v in d],
        "floor": floor,
        "checked_epochs": checked,
        "violations": violations,
        "consistent": violations == 0,
    }


def verify_plan_run(
    artifact,
    run_dir: str,
    steps_per_epoch: int,
    rank: int = 0,
    rho: Optional[float] = None,
) -> Dict:
    """``plan verify``: an artifact and a Recorder folder → the report.

    ``rho`` overrides the artifact's value.  By default the chosen
    candidate's ρ is used, degraded by the run's fault ledger when it has
    one (the fault plan's expected availability and link state), so a run
    under faults is held to the mixing it actually had; the fault-free ρ
    is then reported as ``rho_fault_free``.
    """
    series = load_recorder_disagreement(run_dir, rank=rank)
    use_rho = float(artifact.chosen["rho"] if rho is None else rho)
    fault_note = None
    ledger = load_fault_ledger(run_dir) if rho is None else None
    if ledger is not None:
        from ..topology import matching_laplacians
        from .autotune import resolve_topology
        from .spectral import degraded_contraction_rho

        chosen = artifact.chosen
        decomposed, size, _ = resolve_topology(chosen, int(chosen["seed"]))
        degraded = degraded_contraction_rho(
            matching_laplacians(decomposed, size),
            np.asarray(chosen["probs"], np.float64),
            float(chosen["alpha"]),
            worker_alive=np.asarray(ledger["expected_alive"], np.float64),
            link_up=np.asarray(ledger["expected_link_up"], np.float64),
        )
        fault_note = {
            "fault_plan": ledger.get("name", "faultplan"),
            "rho_fault_free": use_rho,
            "expected_alive_mean": float(np.mean(ledger["expected_alive"])),
            "expected_link_up_mean": float(np.mean(ledger["expected_link_up"])),
        }
        use_rho = float(degraded)
    report = verify_against_recorder(use_rho, series, steps_per_epoch)
    report["run_dir"] = run_dir
    report["budget"] = artifact.chosen["budget"]
    if fault_note is not None:
        report["faults"] = fault_note
    return report
