"""Models over worker-stacked parameters.  Port of ``matcha_tpu.models``."""

from .layers import (
    WorkerBatchNorm2d,
    WorkerConv2d,
    WorkerDense,
    init_workers,
    remat,
)
from .mlp import MLP
from .registry import (
    available_models,
    dataset_input_shape,
    dataset_num_classes,
    select_model,
)
from .resnet import (
    BasicBlock,
    Bottleneck,
    ResNet,
    ResNetImageNet,
    resnet_config,
    resnet_imagenet_config,
)
from .vgg import VGG, vgg_config
from .wrn import WideBasic, WideResNet

__all__ = [
    "BasicBlock",
    "Bottleneck",
    "MLP",
    "ResNet",
    "ResNetImageNet",
    "VGG",
    "WideBasic",
    "WideResNet",
    "WorkerBatchNorm2d",
    "WorkerConv2d",
    "WorkerDense",
    "available_models",
    "dataset_input_shape",
    "dataset_num_classes",
    "init_workers",
    "remat",
    "resnet_config",
    "resnet_imagenet_config",
    "select_model",
    "vgg_config",
]
