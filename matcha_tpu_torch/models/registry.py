"""Model registry with the JAX package's selection semantics.

Port of ``matcha_tpu/models/registry.py``, after ``util.select_model``
(the reference's ``util.py:256-273``): ``res`` is ResNet-50 on cifar10,
ResNet-18 on the other datasets and the ImageNet ResNet-18 on imagenet;
``resnet<depth>`` takes the ImageNet layout on imagenet and the CIFAR one
elsewhere; ``VGG``/``vgg`` is VGG-16, ``vgg<depth>`` sets the depth;
``wrn`` is WideResNet-28-10, ``wrn-<depth>-<k>`` sets both; ``mlp``.  The
class count follows the dataset unless given (quirk Q6 fixed).  The port's
models are built for a number of stacked workers and an input shape, since
a torch module fixes its widths at construction (flax infers them at init).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch.nn as nn

from .mlp import MLP
from .resnet import ResNet, ResNetImageNet
from .vgg import VGG
from .wrn import WideResNet

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
    remat: bool = False,
) -> nn.Module:
    """Build a model by registry name for ``num_workers`` stacked workers.

    ``input_shape`` is one example's NHWC shape (default: the dataset's).
    ``remat`` recomputes the conv models' blocks (VGG: pool-to-pool
    segments) in the backward pass; the MLP ignores it, as in the JAX
    package."""
    classes = num_classes if num_classes is not None else dataset_num_classes(dataset)
    shape = tuple(input_shape) if input_shape is not None \
        else dataset_input_shape(dataset)
    conv = dict(num_classes=classes, num_workers=num_workers, remat=remat)
    lname = name.lower()
    if name == "res" or lname.startswith("resnet"):
        if name == "res":  # reference depth policy (util.py:258-265)
            depth = 50 if dataset == "cifar10" else 18
        else:
            depth = int(lname[len("resnet"):])
        # imagenet gets the 4-stage 7x7-stem layout, CIFAR the 3-stage one
        layout = ResNetImageNet if dataset == "imagenet" else ResNet
        return layout(depth=depth, in_channels=shape[-1], **conv)
    if name == "VGG" or lname == "vgg":
        return VGG(depth=16, input_shape=shape, **conv)
    if lname.startswith("vgg"):
        return VGG(depth=int(lname[len("vgg"):]), input_shape=shape, **conv)
    if lname == "wrn":
        return WideResNet(depth=28, widen_factor=10, in_channels=shape[-1],
                          **conv)
    if lname.startswith("wrn-"):
        depth, widen = lname[len("wrn-"):].split("-")
        return WideResNet(depth=int(depth), widen_factor=int(widen),
                          in_channels=shape[-1], **conv)
    if lname == "mlp":
        return MLP(num_classes=classes, num_workers=num_workers,
                   in_features=math.prod(shape))
    raise KeyError(f"unknown model '{name}'; have {available_models()}")


def available_models():
    return ["res", "resnet<depth>", "VGG", "vgg<depth>", "wrn", "wrn-<d>-<k>",
            "mlp"]
