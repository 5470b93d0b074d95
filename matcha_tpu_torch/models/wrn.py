"""WideResNet over worker-stacked parameters.

Port of ``matcha_tpu/models/wrn.py`` (``WideBasic`` :20, ``WideResNet``
:42), after the reference's ``models/wrn.py:22-83``: pre-activation wide basic
blocks (BN → ReLU → conv → dropout → BN → ReLU → conv, an un-normalized
1×1 conv shortcut), stages 16/16k/32k/64k, depth 6n+4, a final batch norm
with fast-moving statistics (flax momentum 0.1, the reference's torch
momentum 0.9), global average pool.  Input ``[N, B, H, W, C]``, logits
``[N, B, classes]``.

Dropout (off by default, as the reference's training script runs it,
util.py:269) draws its masks from the explicit ``torch.Generator``
``dropout_generator`` (seeded 0 on the input's device when none is set);
a block draws its mask before its body, so ``remat``'s recompute reuses
it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import WorkerBatchNorm2d, WorkerConv2d, WorkerDense, remat
from .resnet import head_per_worker, to_worker_channels

__all__ = ["WideBasic", "WideResNet"]


class WideBasic(nn.Module):
    def __init__(self, num_workers: int, in_planes: int, planes: int,
                 stride: int = 1):
        super().__init__()
        n = num_workers
        self.bn1 = WorkerBatchNorm2d(n, in_planes)
        self.conv1 = WorkerConv2d(n, in_planes, planes, 3, 1, 1)
        self.bn2 = WorkerBatchNorm2d(n, planes)
        self.conv2 = WorkerConv2d(n, planes, planes, 3, stride, 1)
        self.has_shortcut = stride != 1 or in_planes != planes
        if self.has_shortcut:
            self.shortcut_conv = WorkerConv2d(n, in_planes, planes, 1, stride)

    def forward(self, x: torch.Tensor,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``keep``: the dropout mask after ``conv1``, already divided by
        the keep probability (None: no dropout)."""
        out = self.conv1(F.relu(self.bn1(x)))
        if keep is not None:
            out = out * keep
        out = self.conv2(F.relu(self.bn2(out)))
        if self.has_shortcut:
            x = self.shortcut_conv(x)
        return out + x


class WideResNet(nn.Module):
    def __init__(self, depth: int = 28, widen_factor: int = 10,
                 dropout_rate: float = 0.0, num_classes: int = 10,
                 num_workers: int = 1, in_channels: int = 3,
                 remat: bool = False):
        super().__init__()
        if (depth - 4) % 6 != 0:
            raise ValueError("WideResNet depth must be 6n+4")
        blocks, k = (depth - 4) // 6, widen_factor
        n = self.num_workers = num_workers
        self.depth, self.widen_factor = depth, widen_factor
        self.dropout_rate, self.remat = dropout_rate, remat
        self.dropout_generator: Optional[torch.Generator] = None
        self.stem = WorkerConv2d(n, in_channels, 16, 3, 1, 1)
        self.block_names = []
        in_planes = 16
        for stage, (planes, stride) in enumerate(zip((16 * k, 32 * k, 64 * k),
                                                     (1, 2, 2))):
            for b in range(blocks):
                name = f"stage{stage}_block{b}"
                self.add_module(name, WideBasic(n, in_planes, planes,
                                                stride if b == 0 else 1))
                self.block_names.append(name)
                in_planes = planes
        # the reference's torch momentum 0.9 (wrn.py:60) is flax's 0.1
        self.final_bn = WorkerBatchNorm2d(n, in_planes, momentum=0.1)
        self.head = WorkerDense(n, in_planes, num_classes)

    def _keep_mask(self, block: WideBasic, x: torch.Tensor):
        """flax's ``Dropout``: keep with probability 1 − rate, scaled."""
        if not (self.training and self.dropout_rate > 0):
            return None
        if self.dropout_generator is None:
            self.dropout_generator = torch.Generator(
                device=x.device).manual_seed(0)
        shape = (x.shape[0], block.conv1.weight.shape[0]
                 * block.conv1.weight.shape[1]) + tuple(x.shape[2:])
        keep_prob = 1.0 - self.dropout_rate
        draws = torch.rand(shape, generator=self.dropout_generator,
                           device=x.device)
        return (draws < keep_prob).to(x.dtype) / keep_prob

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(to_worker_channels(x, self.stem.weight.shape[0]))
        for name in self.block_names:
            block = getattr(self, name)
            keep = self._keep_mask(block, x)
            x = remat(block, block, x, keep) if self.remat else block(x, keep)
        x = F.relu(self.final_bn(x))
        return head_per_worker(self.head, x)
