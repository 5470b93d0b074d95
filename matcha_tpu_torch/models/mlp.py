"""EMNIST MLP over worker-stacked parameters.

Port of ``matcha_tpu/models/mlp.py``: 784-500-500-classes with ReLU.  The
input ``[N, B, ...]`` is flattened per worker in its NHWC order, as flax
flattens it.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import WorkerDense

__all__ = ["MLP"]


class MLP(nn.Module):
    def __init__(self, num_classes: int = 47, hidden: int = 500,
                 num_workers: int = 1, in_features: int = 784):
        super().__init__()
        n = self.num_workers = num_workers
        self.fc1 = WorkerDense(n, in_features, hidden)
        self.fc2 = WorkerDense(n, hidden, hidden)
        self.fc3 = WorkerDense(n, hidden, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], x.shape[1], -1)
        x = F.relu(self.fc1(x))
        x = F.relu(self.fc2(x))
        return self.fc3(x)
