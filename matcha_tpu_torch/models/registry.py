"""Model registry with the JAX package's selection semantics.

Port of ``matcha_tpu/models/registry.py`` for the models this slice ports:
``resnet<depth>`` (CIFAR layout), the reference alias ``res`` and ``mlp``.
VGG, WideResNet and the ImageNet ResNet are not ported yet.  The port's
models are built for a number of stacked workers and an input shape, since
a torch module fixes its widths at construction (flax infers them at init).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch.nn as nn

from .mlp import MLP
from .resnet import ResNet

__all__ = ["available_models", "dataset_input_shape", "dataset_num_classes",
           "select_model"]

DATASET_CLASSES = {
    "cifar10": 10,
    "cifar100": 100,
    "imagenet": 1000,
    "emnist": 47,
    "digits": 10,
    "synthetic": 10,
    "synthetic_image": 10,
}

DATASET_SHAPES = {
    "cifar10": (32, 32, 3),
    "cifar100": (32, 32, 3),
    "imagenet": (224, 224, 3),
    "emnist": (28, 28, 1),
    "digits": (8, 8, 1),
    "synthetic": (28, 28, 1),
    "synthetic_image": (32, 32, 3),
}


def dataset_num_classes(dataset: str) -> int:
    if dataset not in DATASET_CLASSES:
        raise KeyError(f"unknown dataset '{dataset}'; have {sorted(DATASET_CLASSES)}")
    return DATASET_CLASSES[dataset]


def dataset_input_shape(dataset: str) -> Tuple[int, ...]:
    return DATASET_SHAPES[dataset]


def select_model(
    name: str,
    dataset: str = "cifar10",
    num_classes: int | None = None,
    *,
    num_workers: int = 1,
    input_shape: Tuple[int, ...] | None = None,
) -> nn.Module:
    """Build a model by registry name for ``num_workers`` stacked workers.

    ``input_shape`` is one example's NHWC shape (default: the dataset's).
    """
    classes = num_classes if num_classes is not None else dataset_num_classes(dataset)
    shape = tuple(input_shape) if input_shape is not None \
        else dataset_input_shape(dataset)
    lname = name.lower()
    if name == "res" or lname.startswith("resnet"):
        if dataset == "imagenet":
            raise NotImplementedError(
                "the 4-stage ImageNet ResNet is not ported yet (ROADMAP.md)")
        if name == "res":  # reference depth policy (util.py:258-265)
            depth = 50 if dataset == "cifar10" else 18
        else:
            depth = int(lname[len("resnet"):])
        return ResNet(depth=depth, num_classes=classes,
                      num_workers=num_workers, in_channels=shape[-1])
    if lname == "mlp":
        return MLP(num_classes=classes, num_workers=num_workers,
                   in_features=math.prod(shape))
    if lname.startswith(("vgg", "wrn")):
        raise NotImplementedError(
            f"model '{name}' is not ported yet (ROADMAP.md)")
    raise KeyError(f"unknown model '{name}'; have {available_models()}")


def available_models():
    return ["res", "resnet<depth>", "mlp"]
