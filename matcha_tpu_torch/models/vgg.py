"""VGG with batch norm over worker-stacked parameters.

Port of ``matcha_tpu/models/vgg.py`` (``vgg_config``, ``VGG``), after
the reference's ``models/vggnet.py:12-76``: 3×3 conv (with bias) + batch norm
+ ReLU units with 2×2 max pools, one linear head (CIFAR layout: the last
map is 1×1 after five pools of a 32×32 input).  The units keep the flat
flax names ``conv{i}``/``bn{i}``; with ``remat`` each pool-to-pool segment
is recomputed in the backward pass (``layers.remat``), the names
unchanged.  Input ``[N, B, H, W, C]``, logits ``[N, B, classes]``.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import WorkerBatchNorm2d, WorkerConv2d, WorkerDense, remat
from .resnet import to_worker_channels

__all__ = ["VGG", "vgg_config"]

_CFG = {
    11: (64, "mp", 128, "mp", 256, 256, "mp", 512, 512, "mp", 512, 512, "mp"),
    13: (64, 64, "mp", 128, 128, "mp", 256, 256, "mp", 512, 512, "mp", 512,
         512, "mp"),
    16: (64, 64, "mp", 128, 128, "mp", 256, 256, 256, "mp",
         512, 512, 512, "mp", 512, 512, 512, "mp"),
    19: (64, 64, "mp", 128, 128, "mp", 256, 256, 256, 256, "mp",
         512, 512, 512, 512, "mp", 512, 512, 512, 512, "mp"),
}


def vgg_config(depth: int) -> Sequence[Union[int, str]]:
    if depth not in _CFG:
        raise ValueError(f"VGG depth must be one of {sorted(_CFG)}, got "
                         f"{depth}")
    return _CFG[depth]


class VGG(nn.Module):
    def __init__(self, depth: int = 16, num_classes: int = 10,
                 num_workers: int = 1,
                 input_shape: Tuple[int, ...] = (32, 32, 3),
                 remat: bool = False):
        super().__init__()
        n = self.num_workers = num_workers
        self.depth, self.remat = depth, remat
        h, w, channels = input_shape
        # pool-to-pool segments: (first unit, unit count); every
        # configuration ends in a pool
        self.segments = []
        unit = count = 0
        for item in vgg_config(depth):
            if item == "mp":
                self.segments.append((unit - count, count))
                count, h, w = 0, h // 2, w // 2
                continue
            self.add_module(f"conv{unit}",
                            WorkerConv2d(n, channels, item, 3, 1, 1))
            self.add_module(f"bn{unit}", WorkerBatchNorm2d(n, item))
            channels = item
            unit, count = unit + 1, count + 1
        self.head = WorkerDense(n, h * w * channels, num_classes)

    def _segment(self, x: torch.Tensor, first: int, count: int):
        for i in range(first, first + count):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = self.head.weight.shape[0]
        x = to_worker_channels(x, n)
        for first, count in self.segments:
            x = (remat(self, self._segment, x, first, count) if self.remat
                 else self._segment(x, first, count))
            x = F.max_pool2d(x, 2, 2)
        # flatten each worker's map in flax's NHWC order
        b, _, h, w = x.shape
        x = x.reshape(b, n, -1, h, w).permute(1, 0, 3, 4, 2)
        return self.head(x.reshape(n, b, -1))
