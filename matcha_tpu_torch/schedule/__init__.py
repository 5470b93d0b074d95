"""Gossip scheduling layer: a topology and a budget become the static
contract (perms, alpha, probs, flags) the gossip step consumes.  Port of
``matcha_tpu.schedule`` (numpy copy; the link-fault helpers and the
elastic re-fold wait for later slices, see ``ROADMAP.md``)."""

from .base import Schedule, sample_flags
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
    "sample_flags",
    "fixed_schedule",
    "matcha_schedule",
    "contraction_rho",
    "project_box_capped_sum",
    "solve_activation_probabilities",
    "solve_mixing_weight",
]
