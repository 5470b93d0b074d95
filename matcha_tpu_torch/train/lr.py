"""Learning-rate schedule: linear warmup + step decay.

Port of ``matcha_tpu/train/lr.py``: per-iteration linear warmup from
``base_lr`` to the target over ``warmup_epochs`` (only when target > base),
then ×``decay_factor`` at the decay epochs.  Evaluated on the host in
float32, as ``jnp`` evaluates it, so the port's optimizer steps with the
JAX package's learning rates and the step loop never reads the device.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

__all__ = ["make_lr_schedule"]


def make_lr_schedule(
    target_lr: float,
    batches_per_epoch: int,
    base_lr: float = 0.1,
    warmup: bool = True,
    warmup_epochs: int = 5,
    decay_epochs: Sequence[int] = (100, 150),
    decay_factor: float = 0.1,
) -> Callable[[int], np.float32]:
    """Return ``lr(step) -> np.float32``."""
    f32 = np.float32
    bpe = int(batches_per_epoch)
    warmup_steps = warmup_epochs * bpe if (warmup and target_lr > base_lr) else 0
    incr = (target_lr - base_lr) / warmup_steps if warmup_steps else 0.0
    boundaries = np.asarray([e * bpe for e in decay_epochs], np.int64)

    def schedule(step: int) -> np.float32:
        step = int(step)
        if warmup_steps and step < warmup_steps:
            lr = f32(base_lr) + f32(incr) * f32(min(step, warmup_steps))
        else:
            # after warmup, and on the no-warmup path, the target holds
            lr = f32(target_lr)
        ndecays = int(np.sum(step >= boundaries))
        return f32(lr * f32(decay_factor) ** ndecays)

    return schedule
