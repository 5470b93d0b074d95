"""Contraction bounds in numpy: the pipelined schedule's and the degraded
fleet's.

A partial copy of ``matcha_tpu/plan/spectral.py``: ``masked_consensus_error``
(:60), ``wire_quantization_eps`` (:78), ``masked_laplacian_expectation``
(:268), ``degraded_solver_inputs`` (:290), ``degraded_contraction_rho``
(:322), ``normalize_staleness`` (:357), ``parse_staleness_spec`` (:398),
``_max_delay_root`` (:419), ``staleness_delay_inflation`` (:445),
``stale_contraction_rho`` (:473) and ``stale_alpha_rescale`` (:594), on the
port's own ``schedule.solvers.contraction_rho``.  The training loop damps
the executed α of a ``staleness > 1`` run by ``stale_alpha_rescale``'s
scale, and re-solves α for a degraded fleet (a fault plan's expected
availability, an elastic live set) through ``degraded_solver_inputs``.
The Monte-Carlo simulator and the rest of the planner are not ported yet
(``ROADMAP.md``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from ..schedule.solvers import contraction_rho

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


def masked_consensus_error(x: np.ndarray, alive: np.ndarray) -> float:
    """Squared consensus error of the live rows, ``Σ_live ‖x_i − x̄_live‖²``:
    vacant or dead rows neither define the mean nor count.  Zero with
    fewer than two live rows."""
    x = np.asarray(x, np.float64)
    keep = np.asarray(alive, np.float64) > 0
    if int(keep.sum()) < 2:
        return 0.0
    live = x[keep]
    centered = live - live.mean(axis=0, keepdims=True)
    return float(np.sum(centered * centered))


def masked_laplacian_expectation(
    laplacians: np.ndarray, worker_alive: np.ndarray
) -> np.ndarray:
    """E[L_j] under independent worker availability ``worker_alive: f64[N]``:
    an edge (u, v) scales by ``a_u·a_v`` and the degrees are recomputed, so
    each expected matrix is still a Laplacian.  The numpy twin of
    ``parallel.masked_laplacians``."""
    L = np.asarray(laplacians, np.float64)
    a = np.asarray(worker_alive, np.float64)
    n = L.shape[-1]
    eye = np.eye(n)
    adj = np.einsum("mn,nk->mnk", np.diagonal(L, axis1=-2, axis2=-1), eye) - L
    adj = adj * np.outer(a, a)[None, :, :]
    deg = adj.sum(axis=-1)
    return np.einsum("mn,nk->mnk", deg, eye) - adj


def degraded_solver_inputs(
    laplacians: np.ndarray,
    probs: np.ndarray,
    worker_alive: Optional[np.ndarray] = None,
    link_up: Optional[np.ndarray] = None,
):
    """``(masked Laplacian stack, effective probs)`` for a degraded fleet.

    Workers with availability exactly 0 are projected out (the principal
    submatrix over the survivors): a worker that never rejoins would pin
    any full-space consensus measure at 1.  Partly alive workers stay in,
    edge-scaled by their alive fractions.  ``link_up`` (scalar or
    ``f64[M]``) scales the activation probabilities."""
    Ls = np.asarray(laplacians, np.float64)
    p = np.asarray(probs, np.float64)
    if worker_alive is not None:
        a = np.broadcast_to(np.asarray(worker_alive, np.float64),
                            (Ls.shape[-1],))
        Ls = masked_laplacian_expectation(Ls, a)
        keep = a > 0
        if not keep.all():
            Ls = Ls[:, keep][:, :, keep]
    if link_up is not None:
        p = p * np.broadcast_to(np.asarray(link_up, np.float64), p.shape)
    return Ls, p


def degraded_contraction_rho(
    laplacians: np.ndarray,
    probs: np.ndarray,
    alpha: float,
    worker_alive: Optional[np.ndarray] = None,
    link_up: Optional[np.ndarray] = None,
) -> float:
    """Closed-form ρ of the degraded expected mixing (survivor consensus):
    ``contraction_rho`` on :func:`degraded_solver_inputs`; 1.0 with fewer
    than two survivors, and exactly ``contraction_rho`` with neither
    degradation given."""
    Ls, p = degraded_solver_inputs(laplacians, probs, worker_alive, link_up)
    if Ls.shape[-1] < 2:
        return 1.0
    return float(contraction_rho(Ls, p, float(alpha)))


def wire_quantization_eps(wire_dtype) -> float:
    """Relative rounding bound of one wire-dtype quantization: ``2⁻⁸`` for
    bf16 (8 significand bits, round to nearest), 0 for an f32 wire (or
    ``None``).  Takes strings or dtype objects; raises on anything else."""
    if wire_dtype in (None, "f32", "float32"):
        return 0.0
    if wire_dtype in ("bf16", "bfloat16"):
        return 2.0 ** -8
    try:  # dtype objects (np.float32, a bfloat16 dtype): match by name
        name = np.dtype(wire_dtype).name
    except TypeError:
        name = None
    if name == "float32":
        return 0.0
    if name == "bfloat16":
        return 2.0 ** -8
    raise ValueError(f"unknown wire_dtype '{wire_dtype}' (f32|bf16)")


def normalize_staleness(staleness) -> dict:
    """A staleness spec as ``{delay_steps: probability}``.

    An int ``k ≥ 1`` is a point mass (the executor's contract: a delta
    issued at step t is consumed at step t+k); a mapping or sequence of
    ``(delay, weight)`` pairs is a distribution over consume ages, its
    weights positive and normalized to sum to 1, its delays integers
    ≥ 1.  Raises ``ValueError`` on anything else."""
    if isinstance(staleness, (int, np.integer)):
        if staleness < 1:
            raise ValueError(f"staleness must be >= 1, got {staleness}")
        return {int(staleness): 1.0}
    if isinstance(staleness, dict):
        items = list(staleness.items())
    else:
        try:
            items = [(d, p) for d, p in staleness]
        except (TypeError, ValueError):
            raise ValueError(
                f"staleness must be an int >= 1 or a {{delay: prob}} "
                f"distribution, got {staleness!r}")
    if not items:
        raise ValueError("staleness distribution is empty")
    out: dict = {}
    for d, p in items:
        di, pf = int(d), float(p)
        if di < 1 or di != float(d):
            raise ValueError(f"staleness delays must be integers >= 1, "
                             f"got {d!r}")
        if not pf > 0:
            raise ValueError(f"staleness weights must be > 0, got {p!r} "
                             f"for delay {di}")
        out[di] = out.get(di, 0.0) + pf
    total = sum(out.values())
    return {d: p / total for d, p in sorted(out.items())}


def parse_staleness_spec(text: str) -> dict:
    """Parse ``"1:0.75,4:0.25"`` (or a bare int ``"2"``) into the
    :func:`normalize_staleness` dict."""
    text = str(text).strip()
    if ":" not in text:
        return normalize_staleness(int(text))
    pairs = []
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            d, p = part.split(":")
            pairs.append((int(d), float(p)))
        except ValueError:
            raise ValueError(f"bad staleness-dist entry {part!r} "
                             f"(want delay:prob, e.g. 1:0.75,4:0.25)")
    return normalize_staleness(pairs)


def _max_delay_root(gain: float, delays: dict) -> float:
    """Largest modulus among the roots of ``z^D − z^{D−1} + a·Σ_d π(d)·
    z^{D−d}`` (``D = max d``, ``a`` the mode's gain ``α·μ``): the per-step
    contraction of one eigenmode under the delayed recurrence
    ``x_t = x_{t−1} − a·Σ_d π(d)·x_{t−d}`` that the pending ring runs.
    Point delay 1 is the eager root ``|1 − a|``."""
    D = max(delays)
    if D == 1:
        return abs(1.0 - gain)
    coeffs = np.zeros(D + 1, dtype=np.float64)
    coeffs[0] = 1.0
    coeffs[1] = -1.0
    for d, p in delays.items():
        coeffs[d] += gain * p
    return float(np.max(np.abs(np.roots(coeffs))))


def staleness_delay_inflation(
    laplacians: np.ndarray, probs: np.ndarray, alpha: float, delays: dict
) -> float:
    """``(worst delayed root / worst eager root)²`` over the consensus modes
    of the expected Laplacian (the zero mode, the worker mean, excluded),
    each maximized on its own; 1.0 for point delay 1, ≥ 1 otherwise."""
    Ls = np.asarray(laplacians, np.float64)
    mean_L = np.tensordot(np.asarray(probs, np.float64), Ls, axes=1)
    mu = np.linalg.eigvalsh(mean_L)[1:]  # drop the consensus zero mode
    if mu.size == 0:
        return 1.0
    gains = float(alpha) * mu
    eager = float(np.max(np.abs(1.0 - gains)))
    delayed = float(max(_max_delay_root(float(a), delays) for a in gains))
    if eager <= 0.0:
        # one-shot-exact expected mixing: the delayed modulus is all of it
        return math.inf if delayed > 0 else 1.0
    return max((delayed / eager) ** 2, 1.0)


def stale_contraction_rho(
    laplacians: np.ndarray,
    probs: np.ndarray,
    alpha: float,
    overlap: str = "1step",
    wire_dtype=None,
    staleness=1,
    local_steps: int = 1,
) -> float:
    """Contraction bound of the pipelined schedule, with an optional
    narrow wire and local steps.

    * ``overlap="1step"``, staleness 1: the eager bound; the one-step
      pipeline realizes the same W-chain shifted by one step.
    * Staleness k > 1 (an int or a ``{delay: prob}`` distribution): the
      eager ρ times :func:`staleness_delay_inflation`, with delays counted
      in gossip events, ``ceil(d / local_steps)``: a delta consumed before
      the next exchange is issued telescopes like k = 1.
    * A bf16 wire: ``ρ = (√ρ + ε(1 + √ρ))²`` with ε = 2⁻⁸, per event.
    * ``local_steps`` L: ``ρ_event^(1/L)`` per step.

    ``overlap="off"`` with an f32 wire is ``contraction_rho`` itself."""
    if overlap not in ("off", "1step"):
        raise ValueError(f"overlap must be 'off' or '1step', got {overlap!r}")
    delays = normalize_staleness(staleness)
    L_steps = int(local_steps)
    if L_steps < 1:
        raise ValueError(f"local_steps must be >= 1, got {local_steps}")
    if overlap != "1step" and max(delays) > 1:
        raise ValueError(
            "staleness > 1 needs the pipelined schedule (overlap='1step'): "
            "the eager path has no pending ring to age deltas through")
    Ls = np.asarray(laplacians, np.float64)
    if Ls.shape[-1] < 2:
        return 1.0  # zero or one survivor: no consensus process
    p = np.asarray(probs, np.float64)
    rho = float(contraction_rho(Ls, p, float(alpha)))
    if overlap == "1step":
        # delays in gossip-event units: a delta consumed before the next
        # exchange is issued telescopes exactly (ceil(d/L) = 1 ⇒ no-op)
        event_delays: dict = {}
        for d, pr in delays.items():
            ev = -(-d // L_steps)
            event_delays[ev] = event_delays.get(ev, 0.0) + pr
        if max(event_delays) > 1:
            rho = rho * staleness_delay_inflation(Ls, p, float(alpha),
                                                  event_delays)
    # wire noise is paid per gossip event (the local steps exchange
    # nothing), so it composes before the local-step exponent
    eps = wire_quantization_eps(wire_dtype)
    if eps > 0.0:
        root = math.sqrt(max(rho, 0.0))
        rho = (root + eps * (1.0 + root)) ** 2
    if L_steps > 1:
        rho = rho ** (1.0 / L_steps)
    return float(rho)


def stale_alpha_rescale(
    laplacians: np.ndarray,
    probs: np.ndarray,
    alpha: float,
    staleness=1,
    local_steps: int = 1,
) -> Tuple[float, float]:
    """The scale ``s ∈ (0, 1]`` on the solved α that minimizes
    :func:`stale_contraction_rho` under the pipeline, and ρ at that scale.

    MATCHA solves α for the eager dynamics; under a k-deep pipeline the
    same α overdrives its high-gain modes.  The training step executes
    ``s·α`` by scaling the flag row (every backend's edge weight is
    ``α·flag_j``), so the schedule and its fingerprint stay as built.
    Returns ``(1.0, ρ)`` when the delay in gossip events is 1, and when
    the solved α is already the best."""
    delays = normalize_staleness(staleness)
    L_steps = int(local_steps)
    base = stale_contraction_rho(laplacians, probs, alpha,
                                 overlap="1step", staleness=delays,
                                 local_steps=L_steps)
    if max(-(-d // L_steps) for d in delays) <= 1:
        return 1.0, float(base)
    from scipy.optimize import minimize_scalar

    def rho_at(s: float) -> float:
        return stale_contraction_rho(laplacians, probs, float(alpha) * s,
                                     overlap="1step", staleness=delays,
                                     local_steps=L_steps)

    res = minimize_scalar(rho_at, bounds=(1e-3, 1.0), method="bounded",
                          options={"xatol": 1e-4})
    scale, rho = float(res.x), float(res.fun)
    if base <= rho:  # the solved α was already optimal under this delay
        return 1.0, float(base)
    return scale, rho
