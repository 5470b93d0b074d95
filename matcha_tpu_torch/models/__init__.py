"""Models over worker-stacked parameters.  Port of the slice-1 surface of
``matcha_tpu.models``."""

from .layers import WorkerBatchNorm2d, WorkerConv2d, WorkerDense, init_workers
from .mlp import MLP
from .registry import (
    available_models,
    dataset_input_shape,
    dataset_num_classes,
    select_model,
)
from .resnet import BasicBlock, Bottleneck, ResNet, resnet_config

__all__ = [
    "BasicBlock",
    "Bottleneck",
    "MLP",
    "ResNet",
    "WorkerBatchNorm2d",
    "WorkerConv2d",
    "WorkerDense",
    "available_models",
    "dataset_input_shape",
    "dataset_num_classes",
    "init_workers",
    "resnet_config",
    "select_model",
]
