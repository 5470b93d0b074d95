"""Worker-stacked layers: N independent copies of a layer in one module.

The JAX package vmaps one flax model over the worker axis.  The port
stacks the workers instead: every parameter carries a leading ``[N, ...]``
worker axis, and the activations of all workers travel together as
``[B, N·C, H, W]`` — worker-major channels.  A convolution is then one
``groups=N`` convolution, whose groups are exactly the workers; batch norm
runs over ``N·C`` channels, so each worker's channels see only its own
batch; a dense layer is one batched matrix product.  That is per-worker
semantics with one launch per layer instead of N.

Initialization matches flax's defaults in distribution (parameter values
cannot match: ``jax.random`` and ``torch.Generator`` give other numbers):
kernels are LeCun-normal, truncated at two standard deviations, biases
zero, batch-norm scale one.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["WorkerBatchNorm2d", "WorkerConv2d", "WorkerDense"]

# flax's truncated-normal correction: the standard deviation of a unit
# normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, mean=0.0, std=std, a=-2.0 * std, b=2.0 * std,
                          generator=generator)


class WorkerConv2d(nn.Module):
    """``N`` convolutions with bias; weight ``[N, out, in, kh, kw]``."""

    def __init__(self, num_workers: int, in_channels: int, out_channels: int,
                 kernel_size: int, stride: int = 1, padding: int = 0):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(
            num_workers, out_channels, in_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(num_workers, out_channels))

    def init_worker(self, worker: int, generator: torch.Generator) -> None:
        with torch.no_grad():
            _lecun_normal_(self.weight[worker], self.weight[0].numel()
                           // self.weight.shape[1], generator)
            self.bias[worker].zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, o, i, kh, kw = self.weight.shape
        return F.conv2d(x, self.weight.reshape(n * o, i, kh, kw),
                        self.bias.reshape(n * o), self.stride, self.padding,
                        groups=n)


class WorkerBatchNorm2d(nn.Module):
    """``N`` batch norms over worker-major channels, with flax's statistics.

    Flax keeps a *biased* running variance, ``new = 0.9·old + 0.1·batch``;
    ``torch.nn.BatchNorm2d`` would store the unbiased one.  So the running
    buffers are updated here, from the biased batch statistics, and the
    normalization itself is ``F.batch_norm`` on the batch statistics (train)
    or on the buffers (eval).
    """

    def __init__(self, num_workers: int, channels: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(num_workers, channels))
        self.bias = nn.Parameter(torch.zeros(num_workers, channels))
        self.register_buffer("running_mean", torch.zeros(num_workers, channels))
        self.register_buffer("running_var", torch.ones(num_workers, channels))

    def init_worker(self, worker: int, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight[worker].fill_(1.0)
            self.bias[worker].zero_()
            self.running_mean[worker].zero_()
            self.running_var[worker].fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight, bias = self.weight.reshape(-1), self.bias.reshape(-1)
        if not self.training:
            return F.batch_norm(x, self.running_mean.reshape(-1),
                                self.running_var.reshape(-1), weight, bias,
                                training=False, eps=self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            m = self.momentum
            self.running_mean.copy_(
                (self.running_mean.reshape(-1) * m + mean * (1.0 - m))
                .reshape(self.running_mean.shape))
            self.running_var.copy_(
                (self.running_var.reshape(-1) * m + var * (1.0 - m))
                .reshape(self.running_var.shape))
        return F.batch_norm(x, None, None, weight, bias, training=True,
                            eps=self.eps)


class WorkerDense(nn.Module):
    """``N`` dense layers; weight ``[N, out, in]``, input ``[N, B, in]``."""

    def __init__(self, num_workers: int, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_workers, out_features,
                                               in_features))
        self.bias = nn.Parameter(torch.zeros(num_workers, out_features))

    def init_worker(self, worker: int, generator: torch.Generator) -> None:
        with torch.no_grad():
            _lecun_normal_(self.weight[worker], self.weight.shape[2], generator)
            self.bias[worker].zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.bmm(x, self.weight.transpose(1, 2)) + self.bias[:, None, :]


def init_workers(model: nn.Module, seed: int) -> None:
    """Independent per-worker inits: worker ``w`` draws from its own
    ``torch.Generator`` seeded ``seed + w`` (the reference's per-rank
    ``seed + rank``), through the model's layers in registration order."""
    layers = [m for m in model.modules() if hasattr(m, "init_worker")]
    n = model.num_workers
    for worker in range(n):
        g = torch.Generator().manual_seed(int(seed) + worker)
        for layer in layers:
            layer.init_worker(worker, g)
