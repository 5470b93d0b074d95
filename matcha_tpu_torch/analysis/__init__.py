"""Checks of committed artifacts.  Port of the plan half of
``matcha_tpu.analysis``: ``planlint`` (PL001–PL011, with its
``Violation`` record).  The AST lint families over the port's code are
not ported yet (``ROADMAP.md``)."""

from .planlint import (
    LINK_COSTS_FORMAT,
    PLAN_CHECKS,
    Violation,
    discover_plan_files,
    lint_link_costs_data,
    lint_plan_data,
    lint_plan_file,
    lint_plan_paths,
    render_plan_text,
)

__all__ = [
    "LINK_COSTS_FORMAT",
    "PLAN_CHECKS",
    "Violation",
    "discover_plan_files",
    "lint_link_costs_data",
    "lint_plan_data",
    "lint_plan_file",
    "lint_plan_paths",
    "render_plan_text",
]
