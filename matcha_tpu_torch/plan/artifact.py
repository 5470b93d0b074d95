"""The plan artifact: the JSON contract between offline planning and
training.

A copy of ``matcha_tpu/plan/artifact.py`` (:23-102), with the same format
tag, so an artifact written by either package loads in the other.
``plan_torch.py sweep`` writes one and ``train_torch.py --plan`` consumes
it.  The artifact fixes what the schedule builder needs (graph, budget,
flag-stream seed), so a run driven by a plan builds exactly the schedule
the planner scored.  The solver outputs it records (α, probabilities, ρ)
are provenance, re-derived at train time and never injected.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Optional

__all__ = ["PLAN_FORMAT", "PlanArtifact", "save_plan", "load_plan",
           "apply_plan"]

PLAN_FORMAT = "matcha_tpu.plan/1"


@dataclasses.dataclass(frozen=True)
class PlanArtifact:
    """A ranked schedule-planning result.

    ``chosen`` and each entry of ``candidates`` is the flat dict
    :func:`matcha_tpu_torch.plan.autotune.plan_candidate` returns: the
    graph spec (``graphid``/``topology``/``num_workers``), ``budget``,
    ``seed``, the solver outputs (``alpha``, ``probs``, ``rho``) and the
    predictions (``expected_comm_units``, ``steps_to_target``,
    ``predicted_step_s``, ``predicted_seconds_to_target``).
    """

    chosen: dict
    candidates: List[dict]
    target_consensus: float
    num_chips: int
    cost_model: dict
    format: str = PLAN_FORMAT

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: dict) -> "PlanArtifact":
        fmt = d.get("format", "")
        if fmt != PLAN_FORMAT:
            raise ValueError(
                f"unsupported plan format {fmt!r} (expected {PLAN_FORMAT!r})"
            )
        return PlanArtifact(
            chosen=dict(d["chosen"]),
            candidates=[dict(c) for c in d.get("candidates", [])],
            target_consensus=float(d["target_consensus"]),
            num_chips=int(d["num_chips"]),
            cost_model=dict(d.get("cost_model", {})),
            format=fmt,
        )


def save_plan(artifact: PlanArtifact, path: str) -> None:
    with open(path, "w") as f:
        json.dump(artifact.to_json(), f, indent=1)


def load_plan(path: str) -> PlanArtifact:
    with open(path) as f:
        return PlanArtifact.from_json(json.load(f))


def apply_plan(config, artifact: Optional[PlanArtifact] = None):
    """A copy of the ``TrainConfig`` whose schedule fields (graph, worker
    count, budget, MATCHA mode, seed) come from the artifact's chosen
    candidate; model, data, optimizer and backend stay the caller's.  The
    plan wins over explicit schedule fields by design.

    With ``artifact=None`` the plan is loaded from ``config.plan`` (and the
    config comes back as it is when that is unset): the hook ``train()``
    calls at its entry.
    """
    if artifact is None:
        if not getattr(config, "plan", None):
            return config
        artifact = load_plan(config.plan)
    c = artifact.chosen
    return dataclasses.replace(
        config,
        graphid=c.get("graphid"),
        topology=c.get("topology") or config.topology,
        num_workers=int(c["num_workers"]),
        matcha=bool(c.get("matcha", True)),
        budget=float(c["budget"]),
        seed=int(c["seed"]),
    )
