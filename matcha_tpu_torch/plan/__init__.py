"""Offline schedule planning: predict before you train.

Port of ``matcha_tpu.plan``, host numpy throughout, with the JAX package's
export list:

``spectral``
    The closed-form contraction bound ρ (what the MATCHA solve minimizes),
    its pipelined and degraded variants, and a Monte-Carlo simulator of
    the realized flag stream beside them.
``cost``
    The link-cost model (each matching's edges on the folded card plan,
    ``parallel.folded``), its calibration, the gate ``gossip_backend=
    "auto"`` runs on one card, and the fleet wall-clock model.
``autotune``
    The budget × topology sweep ranked by predicted wall-clock to a target
    contraction; it emits the plan artifact.
``artifact``
    The JSON plan artifact ``train_torch.py --plan`` consumes.
``verify``
    A plan's predicted disagreement decay against a run's Recorder CSVs.
``swap``
    A new budget mapped onto a committed flag stream as per-matching
    re-weights.
"""

from .artifact import PlanArtifact, apply_plan, load_plan, save_plan
from .autotune import plan_candidate, resolve_topology, sweep
from .cost import (
    CostModel,
    calibrate_cost_model,
    expected_comm_units,
    load_measured_comm_times,
    load_measured_link_costs,
    load_measured_vs_ceiling,
    matching_comm_units,
    simulate_fleet_wallclock,
    straggler_step_times,
)
from .spectral import (
    ConsensusSim,
    degraded_contraction_rho,
    degraded_solver_inputs,
    empirical_contraction_rate,
    local_step_breakeven,
    masked_consensus_error,
    masked_laplacian_expectation,
    normalize_staleness,
    parse_staleness_spec,
    simulate_consensus,
    stale_alpha_rescale,
    stale_contraction_rho,
    staleness_delay_inflation,
    steps_to_consensus,
    wire_disagreement_floor,
    wire_quantization_eps,
)
from .swap import resolve_budget_swap
from .verify import (
    load_fault_ledger,
    load_recorder_disagreement,
    verify_against_recorder,
    verify_plan_run,
)

__all__ = [
    "ConsensusSim",
    "CostModel",
    "PlanArtifact",
    "apply_plan",
    "calibrate_cost_model",
    "degraded_contraction_rho",
    "degraded_solver_inputs",
    "empirical_contraction_rate",
    "expected_comm_units",
    "masked_consensus_error",
    "masked_laplacian_expectation",
    "load_fault_ledger",
    "load_measured_comm_times",
    "load_measured_link_costs",
    "load_measured_vs_ceiling",
    "load_plan",
    "load_recorder_disagreement",
    "local_step_breakeven",
    "matching_comm_units",
    "normalize_staleness",
    "parse_staleness_spec",
    "plan_candidate",
    "resolve_budget_swap",
    "resolve_topology",
    "save_plan",
    "simulate_consensus",
    "simulate_fleet_wallclock",
    "stale_alpha_rescale",
    "stale_contraction_rho",
    "staleness_delay_inflation",
    "steps_to_consensus",
    "straggler_step_times",
    "sweep",
    "verify_against_recorder",
    "verify_plan_run",
    "wire_disagreement_floor",
    "wire_quantization_eps",
]
