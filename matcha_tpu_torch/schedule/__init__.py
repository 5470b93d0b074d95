"""Gossip scheduling layer: a topology and a budget become the static
contract (perms, alpha, probs, flags) the gossip step consumes.  Port of
``matcha_tpu.schedule`` (numpy copy), with the link-fault helpers and the
elastic re-fold."""

from .base import Schedule, refold_mixing, sample_flags
from .faults import effective_activation_probs, with_link_failures
from .fixed import fixed_schedule
from .matcha import matcha_schedule
from .solvers import (
    contraction_rho,
    project_box_capped_sum,
    solve_activation_probabilities,
    solve_mixing_weight,
)

__all__ = [
    "Schedule",
    "effective_activation_probs",
    "refold_mixing",
    "sample_flags",
    "with_link_failures",
    "fixed_schedule",
    "matcha_schedule",
    "contraction_rho",
    "project_box_capped_sum",
    "solve_activation_probabilities",
    "solve_mixing_weight",
]
