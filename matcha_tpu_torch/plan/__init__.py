"""The planner's numpy side, as far as the port needs it: the pipelined
schedule's contraction bound and its α damping (``plan/spectral.py``)."""

from .spectral import (
    normalize_staleness,
    parse_staleness_spec,
    stale_alpha_rescale,
    stale_contraction_rho,
    staleness_delay_inflation,
    wire_quantization_eps,
)

__all__ = [
    "normalize_staleness",
    "parse_staleness_spec",
    "stale_alpha_rescale",
    "stale_contraction_rho",
    "staleness_delay_inflation",
    "wire_quantization_eps",
]
