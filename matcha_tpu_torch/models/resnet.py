"""CIFAR-style ResNets over worker-stacked parameters.

Port of ``matcha_tpu/models/resnet.py`` (``ResNet``, ``BasicBlock``,
``Bottleneck``, ``resnet_config``): 3 stages of 16/32/64 planes, 3×3 stem,
global average pool, one linear head; convolutions carry bias; batch-norm
statistics are per worker.  ``ResNetImageNet`` (``resnet_imagenet_config``)
is the 4-stage ImageNet layout: a 7×7/2 stem, a 3×3/2 max pool, stages of
64/128/256/512 planes.  The submodule and parameter names are flax's
(``stem``, ``stage0_block0.conv1``, ``head``, ...) with torch's leaf names
(``weight``, ``bias``, ``running_mean``, ``running_var``), so
``convert.params_from_jax`` maps one onto the other by name.

The public input layout is the JAX package's NHWC per worker:
``[N, B, H, W, C]`` in, ``[N, B, classes]`` logits out.  Inside, the
workers run as conv groups (``models.layers``), whose count each layer
reads from its weight, so the model also runs on a slab of its workers'
parameters (``train/state.py``'s ``grad_chunk``).  ``remat=True`` recomputes
each residual block's interior in the backward pass (``_remat_block`` of
the JAX package, ``layers.remat``); the parameter names do not change.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import WorkerBatchNorm2d, WorkerConv2d, WorkerDense, remat

__all__ = ["BasicBlock", "Bottleneck", "ResNet", "ResNetImageNet",
           "resnet_config", "resnet_imagenet_config"]


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


def to_worker_channels(x: torch.Tensor, workers: int) -> torch.Tensor:
    """``[N, B, H, W, C]`` → ``[B, N·C, H, W]``: worker-major channels."""
    n, b, h, w, c = x.shape
    if n != workers:
        raise ValueError(f"input has {n} workers, model has {workers}")
    return x.permute(1, 0, 4, 2, 3).reshape(b, n * c, h, w)


def head_per_worker(head: WorkerDense, x: torch.Tensor) -> torch.Tensor:
    """Global average pool of ``[B, N·C, H, W]``, then the worker-stacked
    head: ``[N, B, classes]``."""
    n = head.weight.shape[0]
    x = x.mean(dim=(2, 3))
    return head(x.reshape(x.shape[0], n, -1).transpose(0, 1))


class _ResNetBase(nn.Module):
    """The residual stages shared by both layouts: ``block_names`` in order,
    each block rematerialized when ``remat``."""

    def _add_stages(self, block, blocks, planes_list, strides, in_planes):
        self.block_names = []
        for stage, (planes, first_stride) in enumerate(zip(planes_list,
                                                           strides)):
            for b in range(blocks[stage]):
                name = f"stage{stage}_block{b}"
                self.add_module(name, block(
                    self.num_workers, in_planes, planes,
                    first_stride if b == 0 else 1))
                self.block_names.append(name)
                in_planes = planes * block.expansion
        return in_planes

    def _stages(self, x: torch.Tensor) -> torch.Tensor:
        for name in self.block_names:
            block = getattr(self, name)
            x = remat(block, block, x) if self.remat else block(x)
        return x


class ResNet(_ResNetBase):
    """3-stage CIFAR ResNet for ``num_workers`` stacked workers."""

    def __init__(self, depth: int = 20, num_classes: int = 10,
                 num_workers: int = 1, in_channels: int = 3,
                 remat: bool = False):
        super().__init__()
        kind, blocks = resnet_config(depth)
        block = BasicBlock if kind == "basic" else Bottleneck
        n = self.num_workers = num_workers
        self.depth, self.remat = depth, remat
        self.stem = WorkerConv2d(n, in_channels, 16, 3, 1, 1)
        self.stem_bn = WorkerBatchNorm2d(n, 16)
        in_planes = self._add_stages(block, blocks, (16, 32, 64), (1, 2, 2),
                                     16)
        self.head = WorkerDense(n, in_planes, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = to_worker_channels(x, self.stem.weight.shape[0])
        x = F.relu(self.stem_bn(self.stem(x)))
        return head_per_worker(self.head, self._stages(x))


def resnet_imagenet_config(depth: int) -> Tuple[str, Sequence[int]]:
    """(block_kind, blocks_per_stage) for the 4-stage ImageNet layout."""
    table = {
        18: ("basic", (2, 2, 2, 2)),
        34: ("basic", (3, 4, 6, 3)),
        50: ("bottleneck", (3, 4, 6, 3)),
        101: ("bottleneck", (3, 4, 23, 3)),
        152: ("bottleneck", (3, 8, 36, 3)),
    }
    if depth not in table:
        raise ValueError(f"unsupported ImageNet ResNet depth {depth}: need "
                         f"{sorted(table)}")
    return table[depth]


class ResNetImageNet(_ResNetBase):
    """4-stage ImageNet ResNet (7×7/2 stem + 3×3/2 max pool, 64/128/256/512
    planes, global average pool): the layout the reference reaches through
    ``torchvision.models.resnet18()`` (its ``util.py:262-265``)."""

    def __init__(self, depth: int = 18, num_classes: int = 1000,
                 num_workers: int = 1, in_channels: int = 3,
                 remat: bool = False):
        super().__init__()
        kind, blocks = resnet_imagenet_config(depth)
        block = BasicBlock if kind == "basic" else Bottleneck
        n = self.num_workers = num_workers
        self.depth, self.remat = depth, remat
        self.stem = WorkerConv2d(n, in_channels, 64, 7, 2, 3)
        self.stem_bn = WorkerBatchNorm2d(n, 64)
        in_planes = self._add_stages(block, blocks, (64, 128, 256, 512),
                                     (1, 2, 2, 2), 64)
        self.head = WorkerDense(n, in_planes, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = to_worker_channels(x, self.stem.weight.shape[0])
        x = F.relu(self.stem_bn(self.stem(x)))
        # flax pads the pool with −inf, as max_pool2d does
        x = F.max_pool2d(x, 3, 2, 1)
        return head_per_worker(self.head, self._stages(x))
