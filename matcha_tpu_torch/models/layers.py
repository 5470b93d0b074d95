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

``remat`` is flax's ``nn.remat`` on this layout: ``torch.utils.checkpoint``
(non-reentrant), whose recompute leaves the running statistics alone.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

__all__ = ["WorkerBatchNorm2d", "WorkerConv2d", "WorkerDense", "remat"]

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

    Flax keeps a *biased* running variance, ``new = m·old + (1−m)·batch``
    with flax's ``momentum`` m (0.9 by default; torch's convention would
    call that 0.1); ``torch.nn.BatchNorm2d`` would store the unbiased one.
    So the running buffers are updated here, from the biased batch
    statistics, and the normalization itself is ``F.batch_norm`` on the
    batch statistics (train) or on the buffers (eval).  ``update_stats``
    off (``remat``'s recompute) skips the update.
    """

    def __init__(self, num_workers: int, channels: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.update_stats = True
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
        if self.update_stats:
            self._update_running_stats(x)
        return F.batch_norm(x, None, None, weight, bias, training=True,
                            eps=self.eps)

    def _update_running_stats(self, x: torch.Tensor) -> None:
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            m = self.momentum
            self.running_mean.copy_(
                (self.running_mean.reshape(-1) * m + mean * (1.0 - m))
                .reshape(self.running_mean.shape))
            self.running_var.copy_(
                (self.running_var.reshape(-1) * m + var * (1.0 - m))
                .reshape(self.running_var.shape))


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


@contextlib.contextmanager
def _frozen_stats(module: nn.Module):
    """The batch norms of ``module`` skip their running-statistic update."""
    norms = [m for m in module.modules() if isinstance(m, WorkerBatchNorm2d)]
    for bn in norms:
        bn.update_stats = False
    try:
        yield
    finally:
        for bn in norms:
            bn.update_stats = True


def remat(module: nn.Module, fn, *args):
    """``fn(*args)``, its activations recomputed in the backward pass instead
    of kept (``torch.utils.checkpoint``, non-reentrant).  The recompute runs
    the forward again; the batch norms of ``module`` skip their update
    there, as flax's ``nn.remat`` drops the recompute's mutation, so the
    running statistics move once a step.  Without autograd (eval) ``fn``
    just runs."""
    if not (module.training and torch.is_grad_enabled()):
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          _frozen_stats(module)))
