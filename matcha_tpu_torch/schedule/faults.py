"""Link faults in a gossip schedule.

Port of ``matcha_tpu/schedule/faults.py`` (a numpy copy).  A severed link
is a gossip round that silently does not happen, which in a precomputed
flag stream is a flag that does not fire: ``with_link_failures`` thins the
active flags by i.i.d. drops, and ``effective_activation_probs`` gives the
degraded rates ``p_j·(1−drop_prob)`` that the α solver should see.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .base import Schedule

__all__ = ["with_link_failures", "effective_activation_probs"]


def with_link_failures(
    schedule: Schedule, drop_prob: float, seed: int = 0
) -> Schedule:
    """A schedule whose active flags are thinned by i.i.d. link drops.

    Each (step, matching) flag that is 1 survives with probability
    ``1 − drop_prob``, deterministically under ``seed``.  The returned
    ``probs`` are the effective rates ``p_j·(1−drop_prob)`` (the thinned
    stream is a Bernoulli draw at those rates); ``alpha`` keeps the
    original solve: re-deriving it for the degraded rates is the recovery
    path's job (``resilience.resolve_degraded_alpha``)."""
    if not 0.0 <= drop_prob <= 1.0:
        raise ValueError(f"drop_prob must be in [0,1], got {drop_prob}")
    rng = np.random.default_rng(seed)
    survives = rng.random(schedule.flags.shape) >= drop_prob
    flags = (schedule.flags.astype(bool) & survives).astype(np.uint8)
    return dataclasses.replace(
        schedule, flags=flags,
        probs=np.asarray(schedule.probs, np.float64) * (1.0 - drop_prob),
        name=f"{schedule.name}+drop{drop_prob}",
    )


def effective_activation_probs(schedule: Schedule,
                               drop_prob: float) -> np.ndarray:
    """Expected per-matching activation under link failures:
    ``p_j·(1−drop)``.  A schedule from :func:`with_link_failures` already
    stores its degraded rates, so this on top models a second, independent
    drop process."""
    return np.asarray(schedule.probs) * (1.0 - drop_prob)
