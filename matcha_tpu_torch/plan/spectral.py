"""Consensus-decay prediction in numpy: the closed-form bounds and the
Monte-Carlo simulator beside them.

A copy of ``matcha_tpu/plan/spectral.py``: ``ConsensusSim`` (:106),
``_consensus_component`` (:144), ``simulate_consensus`` (:148),
``empirical_contraction_rate`` (:252), ``masked_consensus_error`` (:60),
``wire_quantization_eps`` (:78), ``masked_laplacian_expectation`` (:268),
``degraded_solver_inputs`` (:290), ``degraded_contraction_rho`` (:322),
``normalize_staleness`` (:357), ``parse_staleness_spec`` (:398),
``_max_delay_root`` (:419), ``staleness_delay_inflation`` (:445),
``stale_contraction_rho`` (:473), ``stale_alpha_rescale`` (:594),
``wire_disagreement_floor`` (:641), ``_wire_quantize`` (:656),
``steps_to_consensus`` (:679) and ``local_step_breakeven`` (:698), on the
port's own ``schedule`` and ``topology``.

Two views of one quantity.  The closed form
``ρ = λ_max(I − J − 2α·E[L] + α²(E[L]² + 2·Var[L]))`` bounds the expected
one-step squared consensus error, ``E‖W_t x − x̄‖² ≤ ρ·‖x − x̄‖²``.  The
simulator samples the flag stream training draws (``schedule.base.
sample_flags``) and applies the realized ``W_t`` products to random
vectors, cross-terms included; by Jensen its geometric-mean rate sits at
or below the bound.  It renormalizes the state every step and sums log
ratios, so no horizon underflows.

The training loop damps the executed α of a ``staleness > 1`` run by
``stale_alpha_rescale``'s scale, and re-solves α for a degraded fleet (a
fault plan's expected availability, an elastic live set) through
``degraded_solver_inputs``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..schedule.base import sample_flags
from ..schedule.solvers import contraction_rho
from ..topology import matching_laplacians

__all__ = [
    "ConsensusSim",
    "simulate_consensus",
    "empirical_contraction_rate",
    "local_step_breakeven",
    "steps_to_consensus",
    "wire_disagreement_floor",
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


@dataclasses.dataclass(frozen=True)
class ConsensusSim:
    """Result of a Monte-Carlo consensus simulation.

    ``log_errors``: f64[trials, steps+1] — natural log of the squared
    consensus error ``‖x_t − x̄‖²`` per trial, from log(1) = 0 (each
    trajectory starts at unit consensus error).  ``rho_bound``: the
    closed-form bound for the same (laplacians, probs, alpha).
    """

    log_errors: np.ndarray  # f64[trials, steps+1]
    rho_bound: float
    alpha: float

    @property
    def steps(self) -> int:
        return int(self.log_errors.shape[1]) - 1

    @property
    def trials(self) -> int:
        return int(self.log_errors.shape[0])

    def empirical_rate(self) -> float:
        """Geometric-mean per-step contraction of the squared error."""
        return empirical_contraction_rate(self.log_errors)

    def mean_decay_curve(self) -> np.ndarray:
        """f64[steps+1] — the squared-error curve averaged across trials in
        the log domain (the geometric mean a geometric process
        concentrates around)."""
        return np.exp(self.log_errors.mean(axis=0))

    def predicted_bound_curve(self) -> np.ndarray:
        """f64[steps+1] — the closed-form curve ρ^t."""
        return self.rho_bound ** np.arange(self.steps + 1, dtype=np.float64)


def _consensus_component(x: np.ndarray) -> np.ndarray:
    return x - x.mean(axis=0, keepdims=True)


def simulate_consensus(
    decomposed: Sequence[Sequence[tuple]],
    size: int,
    probs: np.ndarray,
    alpha: float,
    steps: int = 80,
    trials: int = 8,
    dim: int = 4,
    seed: int = 0,
    laplacians: Optional[np.ndarray] = None,
    overlap: str = "off",
    wire_dtype=None,
    staleness: int = 1,
    local_steps: int = 1,
) -> ConsensusSim:
    """Simulate ``x ← W_t x`` under sampled Bernoulli activation flags.

    Trial ``i`` draws its flag stream and its Gaussian start
    ``x₀ ∈ R^{size×dim}`` from seed ``seed·7919 + i``.  ``overlap="1step"``
    runs the pipelined recurrence of ``Communicator.run_pipelined``: step
    *t* applies the delta in ring slot ``t mod k`` (issued at *t − k*) and
    issues its own into that slot; ``staleness=k`` is the ring's depth.
    ``local_steps=L`` thins the flag stream to every L-th row, as the
    training loop does.  ``wire_dtype="bf16"`` rounds the exchanged state
    through bf16 before each ``W`` application (the local term stays
    exact, as in ``x + (W − I)x̃``).  ``rho_bound`` is
    :func:`stale_contraction_rho` for the pipelined, quantized or thinned
    recurrences and ``contraction_rho`` otherwise.
    """
    if overlap not in ("off", "1step"):
        raise ValueError(f"overlap must be 'off' or '1step', got {overlap!r}")
    # a bad spec fails here, before the trials × steps loop is paid for
    quantizing = wire_quantization_eps(wire_dtype) > 0.0
    k = int(staleness)
    L_steps = int(local_steps)
    if k < 1:
        raise ValueError(f"staleness must be >= 1, got {staleness}")
    if L_steps < 1:
        raise ValueError(f"local_steps must be >= 1, got {local_steps}")
    if k > 1 and overlap != "1step":
        raise ValueError("staleness > 1 needs overlap='1step'")
    if laplacians is None:
        laplacians = matching_laplacians(decomposed, size)
    Ls = np.asarray(laplacians, dtype=np.float64)
    p = np.asarray(probs, dtype=np.float64)
    eye = np.eye(size)
    pipelined = overlap == "1step"

    log_errors = np.zeros((trials, steps + 1), dtype=np.float64)
    for trial in range(trials):
        rng = np.random.default_rng(seed * 7919 + trial)
        flags = sample_flags(p, steps, seed=seed * 7919 + trial)
        if L_steps > 1:  # gossip only every L-th step
            flags = flags * (np.arange(steps)[:, None] % L_steps == 0)
        x = _consensus_component(rng.standard_normal((size, dim)))
        norm = math.sqrt(float(np.sum(x * x)))
        x /= max(norm, 1e-300)
        ring = np.zeros((k,) + x.shape)
        log_e = 0.0
        for t in range(steps):
            W = eye - alpha * np.tensordot(
                flags[t].astype(np.float64), Ls, axes=1
            )
            if pipelined:
                slot = t % k
                x = x + ring[slot]  # consume the exchange issued at t − k
                xw = _wire_quantize(x, wire_dtype) if quantizing else x
                ring[slot] = W @ xw - xw  # issue this step's exchange
                x = _consensus_component(x)
            elif not quantizing:
                x = _consensus_component(W @ x)  # re-project: no fp drift
            else:
                xw = _wire_quantize(x, wire_dtype)
                x = _consensus_component(x + (W @ xw - xw))
            e = float(np.sum(x * x))
            log_e += math.log(max(e, 1e-300))
            log_errors[trial, t + 1] = log_e
            scale = max(math.sqrt(e), 1e-300)
            x /= scale  # renormalize: nothing underflows
            if pipelined:
                ring /= scale  # the recurrence is linear: rescale jointly
    rho = stale_contraction_rho(Ls, p, float(alpha), overlap=overlap,
                                wire_dtype=wire_dtype, staleness=k,
                                local_steps=L_steps) \
        if (pipelined or quantizing or L_steps > 1) \
        else contraction_rho(Ls, p, float(alpha))
    return ConsensusSim(log_errors=log_errors, rho_bound=float(rho),
                        alpha=float(alpha))


def empirical_contraction_rate(log_errors: np.ndarray) -> float:
    """``exp(mean over trials of (log e_T − log e_0) / T)``: the per-step
    geometric-mean contraction of ``‖x − x̄‖²``.  By Jensen it is at most
    the arithmetic-mean ratio that ρ bounds, up to O(1/√trials) sampling
    noise on the log scale."""
    log_errors = np.asarray(log_errors, dtype=np.float64)
    T = log_errors.shape[1] - 1
    if T < 1:
        raise ValueError("need at least one simulated step")
    per_trial = (log_errors[:, -1] - log_errors[:, 0]) / T
    return float(np.exp(per_trial.mean()))


def wire_disagreement_floor(wire_dtype, param_scale: float = 1.0) -> float:
    """Absolute consensus floor of a quantizing wire: ``2ε·param_scale``,
    with ``param_scale`` the RMS of the exchanged parameters.  Below it
    neighbours' values map to the same or adjacent bf16 codes and the
    multiplicative bound no longer describes the dynamics.  0 for an f32
    wire."""
    return 2.0 * wire_quantization_eps(wire_dtype) * float(param_scale)


def _wire_quantize(x: np.ndarray, wire_dtype) -> np.ndarray:
    """Round a trajectory state through the wire dtype, as the executor's
    boundary cast does: f64 → f32 → bf16 (round to nearest even, through
    ``torch.bfloat16``) → f64."""
    if wire_dtype in (None, "f32", "float32"):
        return x
    wide = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
    return wide.to(torch.bfloat16).to(torch.float64).numpy()


def steps_to_consensus(rho: float, target: float = 1e-3) -> float:
    """Predicted iterations for the squared consensus error to shrink by
    ``target`` under ``e_t ≤ ρ^t e_0``: ``inf`` when ρ ≥ 1, 1 when ρ ≤ 0
    (one step annihilates the error), fractional otherwise (the autotuner
    ranks by ``steps × step time``, and rounding would hide differences
    between nearby budgets)."""
    if not 0 < target < 1:
        raise ValueError(f"target must be in (0, 1), got {target}")
    if rho >= 1.0:
        return math.inf
    if rho <= 0.0:
        return 1.0
    return math.log(target) / math.log(rho)


def local_step_breakeven(rho: float, t_steps: int, target: float = 1e-3,
                         step_time_s: float | None = None,
                         gossip_time_s: float | None = None) -> dict:
    """When does local-step elision win?

    Gossip every L-th step contracts the squared error by ``ρ^(t_steps/L)``
    over a horizon of ``t_steps`` steps, so the largest period that still
    reaches ``target`` is ``t_steps / steps_to_consensus(ρ, target)`` (∞
    when ρ ≤ 0, 0 when ρ ≥ 1).  Given per-step compute and gossip times,
    the wall-clock speedup at period L is ``(c + g) / (c + g/L)``, taken at
    ``floor(max_local_every)`` clamped to ≥ 1.

    Returns ``{"max_local_every", "steps_needed", "speedup_at_max"}``
    (``speedup_at_max`` None unless both times are given).
    """
    if t_steps < 1:
        raise ValueError(f"t_steps must be >= 1, got {t_steps}")
    needed = steps_to_consensus(rho, target)
    if needed == math.inf:
        max_l = 0.0
    elif needed <= 0:
        max_l = math.inf
    else:
        max_l = float(t_steps) / needed
    speedup = None
    if step_time_s is not None and gossip_time_s is not None:
        if step_time_s < 0 or gossip_time_s < 0:
            raise ValueError("step_time_s and gossip_time_s must be >= 0")
        l_int = max(int(max_l), 1) if max_l not in (0.0, math.inf) \
            else (1 if max_l == 0.0 else max(t_steps, 1))
        total = step_time_s + gossip_time_s
        speedup = total / (step_time_s + gossip_time_s / l_int) \
            if total > 0 else 1.0
    return {
        "max_local_every": max_l,
        "steps_needed": needed,
        "speedup_at_max": speedup,
    }
