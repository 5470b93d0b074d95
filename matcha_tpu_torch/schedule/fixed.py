"""Fixed (D-PSGD) gossip schedules.

Port of ``matcha_tpu/schedule/fixed.py`` (a numpy copy).

Counterpart of the reference ``FixedProcessor`` (graph_manager.py:183-225).
The reference's flag generator has a documented quirk (SURVEY.md Q1): it
draws Bernoulli flags and then *discards* them, emitting alternating
``[0,1]``/``[1,0]`` pairs that only index correctly on 2-matching graphs.
We implement the *intended* algorithms as defaults and keep the quirky
behavior behind an explicit compatibility mode:

``mode="all"``        every matching active every step (classic D-PSGD on the
                      full graph; the budget is ignored — it is 1 by definition).
``mode="bernoulli"``  every matching active i.i.d. with probability ``budget``
                      (the commented-out intent at graph_manager.py:223).
``mode="alternating"``reference parity: step-parity alternation over the first
                      two matchings (only valid for 2-matching decompositions,
                      e.g. a ring) — graph_manager.py:208-225.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..topology import base_laplacian, matchings_to_perms, spectral_gap_alpha, validate_decomposition
from .base import Schedule, sample_flags

__all__ = ["fixed_schedule"]


def fixed_schedule(
    decomposed: Sequence[Sequence[tuple]],
    size: int,
    iterations: int,
    budget: float = 1.0,
    mode: str = "all",
    seed: int = 0,
    alpha: float | None = None,
    flag_sampler: str = "numpy",
) -> Schedule:
    """Build a D-PSGD schedule over a pre-decomposed graph.

    α defaults to the closed form ``2/(λ₂+λ_max)`` of the *base* Laplacian
    (graph_manager.py:196-206) — optimal for the deterministic full-graph
    gossip matrix.
    """
    decomposed = [list(m) for m in decomposed]
    validate_decomposition(decomposed, size)
    M = len(decomposed)
    perms = matchings_to_perms(decomposed, size)
    if alpha is None:
        alpha = spectral_gap_alpha(base_laplacian(decomposed, size))

    if mode == "all":
        probs = np.ones(M)
        flags = np.ones((iterations, M), dtype=np.uint8)
    elif mode == "bernoulli":
        probs = np.full(M, float(budget))
        flags = sample_flags(probs, iterations, seed, sampler=flag_sampler)
    elif mode == "alternating":
        if M != 2:
            raise ValueError(
                f"alternating mode needs exactly 2 matchings (got {M}); it is a "
                "reference-parity mode for ring-like graphs (SURVEY.md Q1)"
            )
        probs = np.full(M, 0.5)
        flags = np.zeros((iterations, M), dtype=np.uint8)
        flags[0::2, 1] = 1  # even steps: [0, 1]
        flags[1::2, 0] = 1  # odd steps:  [1, 0]
    else:
        raise KeyError(f"unknown fixed-schedule mode '{mode}'")

    return Schedule(
        perms=perms,
        alpha=float(alpha),
        probs=probs,
        flags=flags,
        decomposed=decomposed,
        name=f"fixed-{mode}",
    )
