"""The control knobs the step reads.

Port of ``matcha_tpu/serve/runtime.py`` (:26-65).  The run controller's
whole influence over the step is this small value riding
``TrainState.control``, the same seam elastic membership uses
(``elastic.runtime.Membership``): the step multiplies its flag row by
``row_scale`` and then by ``alpha_scale``, and mixes only where
``step % local_every == 0``.  A budget re-solve, an α re-weight or a
local-step cadence change is therefore a value update at an epoch
boundary; the step is never rebuilt.

Identity knobs (an all-ones ``row_scale``, ``alpha_scale`` 1, the config's
``local_steps`` as ``local_every``) make a supervised run bitwise equal to
an unsupervised one: the products by 1.0 are exact.

In the JAX package all three knobs are device arrays, since its step is
traced.  The port's step is Python: ``row_scale`` is a device tensor (it
multiplies the device flag row), ``alpha_scale`` a host float rounded to
f32 (the JAX knob's dtype) and ``local_every`` a host int that the step's
host branch reads.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["ControlKnobs", "control_arrays"]


@dataclasses.dataclass(frozen=True)
class ControlKnobs:
    """What the step sees of the controller.

    ``row_scale``: ``f32[M]`` per-matching re-weight of the executed
    activation (a budget swap maps the re-solved probabilities onto the
    committed flag stream as ``p_new[j] / p_old[j]``,
    ``plan.resolve_budget_swap``), on the device of the flag rows.
    ``alpha_scale``: the scale of the mixing weight, a host float.
    ``local_every``: the gossip cadence; steps where ``step % local_every
    != 0`` mix nothing.
    """

    row_scale: torch.Tensor
    alpha_scale: float
    local_every: int

    @classmethod
    def fresh(cls, num_matchings: int, device=None) -> "ControlKnobs":
        """Identity knobs, the supervised run's default posture."""
        return control_arrays(np.ones(num_matchings, np.float32), 1.0, 1,
                              device)


def control_arrays(row_scale, alpha_scale: float, local_every: int,
                   device=None) -> ControlKnobs:
    """Host knob state → the value the next epoch's steps read.

    ``row_scale`` reaches a CUDA ``device`` by one copy from pinned memory
    that does not wait for the card, so a boundary that re-primes the
    knobs adds no synchronizing call to the run."""
    host = torch.as_tensor(np.asarray(row_scale, np.float32).copy())
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda":
        rows = host.pin_memory().to(dev, non_blocking=True)
    else:
        rows = host.to(dev)
    return ControlKnobs(row_scale=rows,
                        alpha_scale=float(np.float32(alpha_scale)),
                        local_every=max(int(local_every), 1))
