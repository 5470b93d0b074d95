"""Host-plane chaos: deterministic fault campaigns against the daemon.

Port of ``matcha_tpu/chaos`` (:1-37 of its ``__init__``): seeded
injectors for the serve plane's storage failure surface (checkpoint
corruption, journal torn writes, ENOSPC / hung observability IO, kills
at barriers, clock skew), a campaign runner that launches the daemon's
own stack (``serve.Controller`` → ``python -m
matcha_tpu_torch.serve.trainer``, on the card unless asked otherwise)
per trial and checks a pinned invariant suite, and exact failing-seed
replay + shrink-to-minimal-schedule.  ``chaos_torch.py`` is the CLI.

``taps`` is imported eagerly (it is dependency-free and the train stack
imports it on its hot paths); the campaign machinery loads lazily —
``campaign`` imports the serve plane, which imports the train stack,
which imports ``chaos.taps``: an eager import here would cycle.
"""

from . import taps
from .taps import BARRIERS, maybe_kill

__all__ = ["taps", "BARRIERS", "maybe_kill",
           "FAMILIES", "FaultSpec", "schedule_for_seed", "run_trial",
           "run_campaign", "shrink", "check_invariants"]

_LAZY = {
    "FAMILIES": "campaign", "FaultSpec": "campaign",
    "schedule_for_seed": "campaign", "run_trial": "campaign",
    "run_campaign": "campaign", "shrink": "campaign",
    "check_invariants": "invariants",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module = importlib.import_module(f".{_LAZY[name]}", __name__)
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
