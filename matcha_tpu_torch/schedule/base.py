"""The schedule contract between host-side planning and device code.

Port of ``matcha_tpu/schedule/base.py`` (a numpy copy).  Four static
arrays are all the gossip step needs:

    perms : int32[M, N]   matching involutions (partner or self)
    alpha : float         mixing weight α
    probs : f64[M]        per-matching activation probabilities
    flags : uint8[T, M]   per-iteration activation draws

The flag stream is sampled once, on the host, with an explicit seed.
``Schedule.refold_for`` re-solves α over a partial live set (the elastic
re-plan), through ``refold_mixing`` on the port's ``plan.spectral``.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from ..topology import native_np
from ..topology import (
    DecomposedGraph,
    matching_laplacians,
    matchings_to_perms,
    mixing_matrix,
    perms_to_neighbors,
)
from .solvers import contraction_rho

__all__ = ["Schedule", "refold_mixing", "sample_flags"]


def refold_mixing(laplacians: np.ndarray, probs: np.ndarray, alpha0: float,
                  worker_alive: np.ndarray):
    """The degraded fold rule: ``(α, ρ, p_eff)`` over a partial live set.

    The solver sees the alive-masked Laplacians with fully dead workers
    projected out (``plan.spectral.degraded_solver_inputs``).  Fewer than
    two live workers keeps ``alpha0`` and reports ρ = 1 (no consensus
    process remains to optimize)."""
    from ..plan.spectral import degraded_solver_inputs
    from .solvers import solve_mixing_weight

    Ls, p_eff = degraded_solver_inputs(
        laplacians, probs,
        worker_alive=np.asarray(worker_alive, np.float64))
    if Ls.shape[-1] < 2:
        return float(alpha0), 1.0, p_eff
    alpha, rho = solve_mixing_weight(Ls, p_eff)
    return float(alpha), float(rho), p_eff


def sample_flags(
    probs: np.ndarray, iterations: int, seed: int, sampler: str = "numpy"
) -> np.ndarray:
    """i.i.d. Bernoulli(probs[j]) activation flags, ``uint8[iterations, M]``.

    Parity with ``MatchaProcessor.set_flags`` (graph_manager.py:298-309),
    including the NaN/negative clamp to probability 0.

    ``sampler="native"`` is the JAX package's counter-based stream
    (splitmix64 keyed by ``(seed, t, j)``, ``native_np.sample_flag_stream``):
    the flags its C++ library gives.
    """
    if sampler == "native":
        return native_np.sample_flag_stream(probs, iterations, seed)
    if sampler != "numpy":
        raise KeyError(f"unknown flag sampler '{sampler}'")
    p = np.asarray(probs, dtype=np.float64).copy()
    p[~np.isfinite(p)] = 0.0
    p = np.clip(p, 0.0, 1.0)
    rng = np.random.default_rng(seed)
    return (rng.random((iterations, p.shape[0])) < p[None, :]).astype(np.uint8)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Static gossip schedule for ``iterations`` steps over ``N`` workers."""

    perms: np.ndarray  # int32[M, N]
    alpha: float
    probs: np.ndarray  # f64[M]
    flags: np.ndarray  # uint8[T, M]
    decomposed: DecomposedGraph = dataclasses.field(repr=False)
    name: str = "schedule"

    def __post_init__(self):
        M, N = self.perms.shape
        assert self.flags.ndim == 2 and self.flags.shape[1] == M, (
            f"flags {self.flags.shape} vs {M} matchings"
        )
        assert self.probs.shape == (M,)

    @property
    def num_matchings(self) -> int:
        return int(self.perms.shape[0])

    @property
    def num_workers(self) -> int:
        return int(self.perms.shape[1])

    @property
    def iterations(self) -> int:
        return int(self.flags.shape[0])

    # ----- reference-compatibility views ------------------------------------

    @property
    def neighbor_weight(self) -> float:
        """Reference name for α (communicator.py:84)."""
        return self.alpha

    @property
    def neighbors_info(self) -> np.ndarray:
        """Partner-or−1 table (graph_manager.py:157-180 convention)."""
        return perms_to_neighbors(self.perms)

    @property
    def active_flags(self) -> List[List[int]]:
        """Per-iteration flag lists (graph_manager.py:309 convention)."""
        return [list(map(int, row)) for row in self.flags]

    # ----- analysis ---------------------------------------------------------

    def laplacians(self) -> np.ndarray:
        cached = self.__dict__.get("_laplacians")
        if cached is None:
            cached = matching_laplacians(self.decomposed, self.num_workers)
            object.__setattr__(self, "_laplacians", cached)  # frozen-safe memo
        return cached

    def mixing_matrix_at(self, t: int) -> np.ndarray:
        """Dense ``W_t = I − α·Σ_active L_j`` oracle for step ``t``."""
        return mixing_matrix(self.laplacians(), self.flags[t], self.alpha)

    def expected_rho(self) -> float:
        """Expected per-step consensus contraction bound (ρ < 1 ⇒ converges)."""
        return contraction_rho(self.laplacians(), self.probs, self.alpha)

    def expected_comm_fraction(self) -> float:
        """E[#active matchings] / M — the realized communication budget."""
        return float(np.mean(self.probs))

    def refold_for(self, worker_alive: np.ndarray):
        """Re-solve ``(α, ρ, p_eff)`` for a partial live set over this
        schedule's matchings: the epoch-boundary re-plan of elastic
        membership.  The permutations persist; only the expected mixing
        they realize over the survivors is re-folded
        (:func:`refold_mixing`)."""
        return refold_mixing(self.laplacians(), self.probs, self.alpha,
                             worker_alive)

    def slice(self, start: int, stop: int) -> "Schedule":
        """A view of steps [start, stop) — used for epoch-chunked scans."""
        return dataclasses.replace(self, flags=self.flags[start:stop])

    def extend(self, iterations: int, seed: int, sampler: str = "numpy") -> "Schedule":
        """The same schedule lengthened to ``iterations`` total steps —
        training longer than originally planned, without perturbing history.

        The existing flag rows are kept verbatim; rows beyond the current
        horizon are fresh i.i.d. Bernoulli(probs) draws (both samplers are
        prefix-stable, so extending with the original seed reproduces the
        original prefix bit-for-bit and simply continues the stream).  Exact
        for MATCHA and the all/bernoulli fixed modes; the ``alternating``
        parity mode has no Bernoulli tail, so extending it raises.
        """
        if iterations < self.iterations:
            raise ValueError(
                f"extend to {iterations} < current {self.iterations}; use slice()"
            )
        if self.name == "fixed-alternating":
            raise ValueError(
                "alternating-mode flags are a deterministic parity pattern, "
                "not Bernoulli draws; rebuild with fixed_schedule(iterations=...)"
            )
        flags = sample_flags(self.probs, iterations, seed, sampler)
        if not np.array_equal(flags[: self.iterations], self.flags):
            # different seed/sampler than the original build: keep the lived
            # history, use the fresh draws only beyond it
            flags = np.concatenate([self.flags, flags[self.iterations:]])
        return dataclasses.replace(self, flags=flags)
