"""CIFAR-style ResNets over worker-stacked parameters.

Port of ``matcha_tpu/models/resnet.py`` (``ResNet``, ``BasicBlock``,
``Bottleneck``, ``resnet_config``): 3 stages of 16/32/64 planes, 3×3 stem,
global average pool, one linear head; convolutions carry bias; batch-norm
statistics are per worker.  The submodule and parameter names are flax's
(``stem``, ``stage0_block0.conv1``, ``head``, ...) with torch's leaf names
(``weight``, ``bias``, ``running_mean``, ``running_var``), so
``convert.params_from_jax`` maps one onto the other by name.

The public input layout is the JAX package's NHWC per worker:
``[N, B, H, W, C]`` in, ``[N, B, classes]`` logits out.  Inside, the
workers run as conv groups (``models.layers``).  The 4-stage ImageNet
layout (``ResNetImageNet``) and block rematerialization are not ported yet.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import WorkerBatchNorm2d, WorkerConv2d, WorkerDense

__all__ = ["BasicBlock", "Bottleneck", "ResNet", "resnet_config"]


def resnet_config(depth: int) -> Tuple[str, Sequence[int]]:
    """(block_kind, blocks_per_stage) for a named depth."""
    reference = {
        18: ("basic", (2, 2, 2)),
        34: ("basic", (3, 4, 6)),
        50: ("bottleneck", (3, 4, 6)),
        101: ("bottleneck", (3, 4, 23)),
        152: ("bottleneck", (3, 8, 36)),
    }
    if depth in reference:
        return reference[depth]
    if depth >= 8 and (depth - 2) % 6 == 0:  # classic CIFAR ResNet-6n+2
        n = (depth - 2) // 6  # n=1 gives ResNet-8, the smallest of the family
        return "basic", (n, n, n)
    raise ValueError(
        f"unsupported ResNet depth {depth}: need one of {sorted(reference)} or 6n+2"
    )


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, num_workers: int, in_planes: int, planes: int,
                 stride: int = 1):
        super().__init__()
        n = num_workers
        self.conv1 = WorkerConv2d(n, in_planes, planes, 3, stride, 1)
        self.bn1 = WorkerBatchNorm2d(n, planes)
        self.conv2 = WorkerConv2d(n, planes, planes, 3, 1, 1)
        self.bn2 = WorkerBatchNorm2d(n, planes)
        self.has_shortcut = stride != 1 or in_planes != planes
        if self.has_shortcut:
            self.shortcut_conv = WorkerConv2d(n, in_planes, planes, 1, stride)
            self.shortcut_bn = WorkerBatchNorm2d(n, planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.has_shortcut:
            x = self.shortcut_bn(self.shortcut_conv(x))
        return F.relu(out + x)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, num_workers: int, in_planes: int, planes: int,
                 stride: int = 1):
        super().__init__()
        n, want = num_workers, planes * self.expansion
        self.conv1 = WorkerConv2d(n, in_planes, planes, 1)
        self.bn1 = WorkerBatchNorm2d(n, planes)
        self.conv2 = WorkerConv2d(n, planes, planes, 3, stride, 1)
        self.bn2 = WorkerBatchNorm2d(n, planes)
        self.conv3 = WorkerConv2d(n, planes, want, 1)
        self.bn3 = WorkerBatchNorm2d(n, want)
        self.has_shortcut = stride != 1 or in_planes != want
        if self.has_shortcut:
            self.shortcut_conv = WorkerConv2d(n, in_planes, want, 1, stride)
            self.shortcut_bn = WorkerBatchNorm2d(n, want)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.has_shortcut:
            x = self.shortcut_bn(self.shortcut_conv(x))
        return F.relu(out + x)


class ResNet(nn.Module):
    """3-stage CIFAR ResNet for ``num_workers`` stacked workers."""

    def __init__(self, depth: int = 20, num_classes: int = 10,
                 num_workers: int = 1, in_channels: int = 3):
        super().__init__()
        kind, blocks = resnet_config(depth)
        block = BasicBlock if kind == "basic" else Bottleneck
        n = self.num_workers = num_workers
        self.stem = WorkerConv2d(n, in_channels, 16, 3, 1, 1)
        self.stem_bn = WorkerBatchNorm2d(n, 16)
        self.block_names = []
        in_planes = 16
        for stage, (planes, stride) in enumerate(zip((16, 32, 64), (1, 2, 2))):
            for b in range(blocks[stage]):
                name = f"stage{stage}_block{b}"
                self.add_module(name, block(n, in_planes, planes,
                                            stride if b == 0 else 1))
                self.block_names.append(name)
                in_planes = planes * block.expansion
        self.head = WorkerDense(n, in_planes, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, b, h, w, c = x.shape
        if n != self.num_workers:
            raise ValueError(f"input has {n} workers, model has "
                             f"{self.num_workers}")
        x = x.permute(1, 0, 4, 2, 3).reshape(b, n * c, h, w)
        x = F.relu(self.stem_bn(self.stem(x)))
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = x.mean(dim=(2, 3))  # global average over the final map
        return self.head(x.reshape(b, n, -1).transpose(0, 1))
