"""In-step telemetry: counters on the device, read once an epoch.

Port of ``matcha_tpu/obs/telemetry.py``: ``Telemetry`` (:41),
``TelemetrySpec`` (:98), ``make_telemetry_spec`` (:119),
``telemetry_step`` (:146) and ``telemetry_flush`` (:210).

The contract is the JAX package's: the accumulator rides the train state,
each step adds to it without reading anything back, and the host reads it
once an epoch, in the loop's one deliberate read (``train/loop.py`` cats
:func:`telemetry_tensor` into that read).  A ``.item()``, ``float(t)`` or
``bool(t)`` in the step would stall the card's queue every step.

What a step adds is split by where its value lives:

* the values the step computes on the card (its disagreement and, under a
  fault plan or a membership, the alive count, the heal count and the
  dropped deltas) are stacked and added to ``sums`` in place, one add;
  the alive minimum is one in-place ``minimum``; the per-worker rows are
  one add each;
* the values the host knows already (the step count and what the flag row
  moves: matchings, wire bytes, quantized values; the alive count when
  every worker takes part) are host arithmetic, summed in float64, which
  is exact where the JAX package's float32 sum may round.

Wire-byte model: ``parallel.gossip.matching_wire_bytes``, 2·E_j·D values
per fired matching at the wire dtype's width; CHOCO's compressed stream is
counted as its uncompressed equivalent, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

__all__ = ["Telemetry", "TelemetrySpec", "make_telemetry_spec",
           "age_bin_table", "telemetry_step", "telemetry_tensor",
           "telemetry_flush"]

# the device-side sums, in the order of ``Telemetry.sums``
_DEVICE_SUMS = ("disagreement_sum", "alive_sum", "healed", "stale_dropped")
# the host-side sums, in the order of ``Telemetry.host``
_HOST_SUMS = ("steps", "wire_bytes", "matchings", "alive_sum", "stale_steps",
              "quantized_values", "uniform_steps")


@dataclasses.dataclass
class Telemetry:
    """One epoch's accumulator.

    On the device: ``sums`` f32[4] (``_DEVICE_SUMS``), ``alive_min``
    (starts at ``+inf``, so the running minimum is exact from the first
    step), ``disagreement_last`` (the last step's disagreement tensor,
    held, not copied), ``worker_alive_sum`` and
    ``worker_disagreement_sum`` f32[N], and ``stale_age_hist``
    f32[N, K+1], the per-worker consumed-age histogram of the staleness
    ring (bin 0 an empty slot, bin a an age-a delta; ``[N, 2]`` when
    staleness is 1).  On the host: ``host`` (``_HOST_SUMS``, float64) and
    ``host_alive_min``.  ``uniform_steps`` counts the steps in which every
    worker took part: their participation is added at the flush instead
    of a row of ones each step."""

    sums: torch.Tensor
    alive_min: torch.Tensor
    disagreement_last: torch.Tensor
    worker_alive_sum: torch.Tensor
    worker_disagreement_sum: torch.Tensor
    stale_age_hist: torch.Tensor
    host: Dict[str, float] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(_HOST_SUMS, 0.0))
    host_alive_min: float = float("inf")

    @classmethod
    def zeros(cls, num_workers: int, staleness: int = 1,
              device=None) -> "Telemetry":
        n, k = int(num_workers), int(staleness)
        return cls(
            sums=torch.zeros(len(_DEVICE_SUMS), device=device),
            alive_min=torch.full((), float("inf"), device=device),
            disagreement_last=torch.zeros((), device=device),
            worker_alive_sum=torch.zeros(n, device=device),
            worker_disagreement_sum=torch.zeros(n, device=device),
            stale_age_hist=torch.zeros(n, k + 1, device=device))


@dataclasses.dataclass(frozen=True)
class TelemetrySpec:
    """Constants of a run the step's accounting closes over.

    ``wire_bytes_per_matching`` / ``wire_values_per_matching``: f32[M],
    what one firing of matching j moves at the wire dtype (bytes) and how
    many values it rounds.  ``quantizing``: the wire is narrower than f32.
    ``overlap``: the pipelined schedule runs.  ``staleness``: the ring's
    depth K (ages clip to K in the histogram)."""

    wire_bytes_per_matching: np.ndarray
    wire_values_per_matching: np.ndarray
    quantizing: bool
    overlap: bool
    staleness: int = 1


def make_telemetry_spec(decomposed: Sequence[Sequence[tuple]], dim: int,
                        wire_dtype=None, overlap: str = "off",
                        staleness: int = 1) -> TelemetrySpec:
    """A schedule's exchange accounting: ``decomposed`` its matchings (edge
    lists), ``dim`` the flat parameter dimension, ``wire_dtype`` /
    ``overlap`` / ``staleness`` the run's settings."""
    from ..parallel.gossip import matching_wire_bytes, resolve_wire_dtype

    wire = resolve_wire_dtype(wire_dtype)
    bytes_el = 4 if wire is None else wire.itemsize
    bytes_vec = np.asarray(matching_wire_bytes(decomposed, dim, wire_dtype),
                           np.float32)
    return TelemetrySpec(
        wire_bytes_per_matching=bytes_vec,
        wire_values_per_matching=bytes_vec / np.float32(bytes_el),
        quantizing=bytes_el < 4,
        overlap=overlap == "1step",
        staleness=int(staleness),
    )


def age_bin_table(staleness: int, device) -> torch.Tensor:
    """f32[K+2, K+1]: row ``a + 1`` is the histogram row of a consumed age
    ``a`` in ``[-1, K]`` (bin ``clip(a, 0, K)``)."""
    rows = np.zeros((staleness + 2, staleness + 1), np.float32)
    for a in range(-1, staleness + 1):
        rows[a + 1, min(max(a, 0), staleness)] = 1.0
    return torch.as_tensor(rows, device=device)


def telemetry_step(
    tel: Telemetry,
    spec: TelemetrySpec,
    *,
    disagreement: torch.Tensor,
    flags_t,
    alive_count,
    healed: Optional[torch.Tensor] = None,
    stale_dropped: Optional[torch.Tensor] = None,
    consumed_age: Optional[torch.Tensor] = None,
    worker_alive: Optional[torch.Tensor] = None,
    worker_disagreement: Optional[torch.Tensor] = None,
    age_bins: Optional[torch.Tensor] = None,
) -> Telemetry:
    """One step's accumulation, in place; returns ``tel``.

    ``flags_t``: this step's activation row on the host (f32[M], times the
    mix gate, so that an elided step counts zero bytes).  ``alive_count``:
    a host number (every worker took part) or the step's 0-d device count.
    ``healed`` / ``stale_dropped``: this step's counts on the device, or
    ``None`` where the run has no such machinery.  ``consumed_age``:
    i32[N], the age of the delta each worker consumed from the staleness
    ring (−1: an empty slot); ``None`` off the ring.  ``worker_alive`` /
    ``worker_disagreement``: f32[N] participation mask (``None``: every
    worker) and per-row deviation from consensus.  ``age_bins``: the
    table of :func:`age_bin_table` on the device (made here when not given:
    a copy to the card, so a step passes its own).  Nothing is read from
    the device."""
    row = np.asarray(flags_t, np.float32)
    host = tel.host
    host["steps"] += 1.0
    host["matchings"] += float(row.sum(dtype=np.float64))
    host["wire_bytes"] += float(np.dot(row.astype(np.float64),
                                       spec.wire_bytes_per_matching))
    if spec.quantizing:
        host["quantized_values"] += float(np.dot(
            row.astype(np.float64), spec.wire_values_per_matching))
    if spec.overlap:
        host["stale_steps"] += 1.0
    if isinstance(alive_count, torch.Tensor):
        torch.minimum(tel.alive_min, alive_count, out=tel.alive_min)
    else:
        host["alive_sum"] += float(alive_count)
        tel.host_alive_min = min(tel.host_alive_min, float(alive_count))
        alive_count = None
    # (slot in ``sums``, value) of what this step computed on the device
    dev = [(i, v) for i, v in enumerate(
        (disagreement, alive_count, healed, stale_dropped)) if v is not None]
    if len(dev) == 1:
        tel.sums[0].add_(disagreement)
    elif [i for i, _ in dev] == list(range(len(dev))):
        tel.sums[:len(dev)].add_(torch.stack([v for _, v in dev]))
    else:
        for i, v in dev:
            tel.sums[i].add_(v)
    tel.disagreement_last = disagreement
    if consumed_age is not None:
        if age_bins is None:
            age_bins = age_bin_table(spec.staleness, consumed_age.device)
        # an age past K (a resumed ring's rebuilt ages) bins at K
        rows = (consumed_age + 1).clamp_(0, spec.staleness + 1)
        tel.stale_age_hist.add_(age_bins.index_select(0, rows))
    if worker_alive is None:
        host["uniform_steps"] += 1.0
    else:
        tel.worker_alive_sum.add_(worker_alive)
    if worker_disagreement is not None:
        tel.worker_disagreement_sum.add_(worker_disagreement)
    return tel


def telemetry_tensor(tel: Telemetry) -> torch.Tensor:
    """Everything on the device, as one f32 vector: the loop cats it into
    its one read of the epoch."""
    return torch.cat([tel.sums, tel.alive_min.reshape(1),
                      tel.disagreement_last.reshape(1).to(torch.float32),
                      tel.worker_alive_sum, tel.worker_disagreement_sum,
                      tel.stale_age_hist.reshape(-1)])


def telemetry_flush(tel: Telemetry,
                    values: Optional[Sequence[float]] = None
                    ) -> Dict[str, float]:
    """The epoch's record, field for field the JAX package's.

    ``values``: :func:`telemetry_tensor` as read by the caller (the loop
    reads it with the epoch's metrics); ``None`` reads it here, one
    transfer.  The means guard a zero-step epoch, and an ``alive_min``
    never updated (``+inf``) reports NaN."""
    if values is None:
        values = telemetry_tensor(tel).tolist()
    values = np.asarray(values, np.float64)
    n = tel.worker_alive_sum.shape[0]
    host = tel.host
    d_sum, d_alive, d_healed, d_dropped, d_min, d_last = values[:6]
    w_alive = values[6:6 + n] + host["uniform_steps"]
    w_dev = values[6 + n:6 + 2 * n]
    hist = values[6 + 2 * n:].reshape(n, -1)
    steps = host["steps"]
    denom = max(steps, 1.0)
    alive_min = min(d_min, tel.host_alive_min)
    return {
        "steps": steps,
        "disagreement_mean": float(d_sum) / denom,
        "disagreement_last": float(d_last),
        "wire_bytes": host["wire_bytes"],
        "matchings_mean": host["matchings"] / denom,
        "alive_mean": (float(d_alive) + host["alive_sum"]) / denom,
        "alive_min": alive_min if np.isfinite(alive_min) else float("nan"),
        "stale_steps": host["stale_steps"],
        "stale_dropped": float(d_dropped),
        "stale_age_hist": [float(v) for v in hist.sum(axis=0)],
        "quantized_values": host["quantized_values"],
        "healed": float(d_healed),
        "worker_participation": [float(v) for v in w_alive / denom],
        "worker_disagreement": [float(v) for v in
                                w_dev / np.maximum(w_alive, 1.0)],
    }
