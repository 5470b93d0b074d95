"""Training: config, learning-rate schedule, train state and step, and the
training loop.  Port of the eager perm-backend path of ``matcha_tpu.train``."""

from .config import TrainConfig
from .loop import TrainResult, TrainingDiverged, build_dataset, build_schedule, train
from .lr import make_lr_schedule
from .state import (
    OptimizerSpec,
    TrainState,
    init_train_state,
    make_eval_fn,
    make_optimizer,
    make_train_step,
)

__all__ = [
    "OptimizerSpec",
    "TrainConfig",
    "TrainResult",
    "TrainState",
    "TrainingDiverged",
    "build_dataset",
    "build_schedule",
    "init_train_state",
    "make_eval_fn",
    "make_lr_schedule",
    "make_optimizer",
    "make_train_step",
    "train",
]
