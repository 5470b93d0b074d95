"""The planner's numpy side, as far as the port needs it: the pipelined
schedule's contraction bound and its α damping, and the degraded fleet's
solver inputs and bound (``plan/spectral.py``)."""

from .spectral import (
    degraded_contraction_rho,
    degraded_solver_inputs,
    masked_consensus_error,
    masked_laplacian_expectation,
    normalize_staleness,
    parse_staleness_spec,
    stale_alpha_rescale,
    stale_contraction_rho,
    staleness_delay_inflation,
    wire_quantization_eps,
)

__all__ = [
    "degraded_contraction_rho",
    "degraded_solver_inputs",
    "masked_consensus_error",
    "masked_laplacian_expectation",
    "normalize_staleness",
    "parse_staleness_spec",
    "stale_alpha_rescale",
    "stale_contraction_rho",
    "staleness_delay_inflation",
    "wire_quantization_eps",
]
