"""Gossip-message compressors, batched over the worker axis.

Port of ``matcha_tpu/ops/compress.py``.  Every compressor maps a
``[N, D]`` stack to ``(values[N, k], indices[N, k])`` with int32 indices,
and has the signature ``(x, ratio, gen)``: ``gen`` is the
``torch.Generator`` (on ``x``'s device) that the stochastic compressors
draw from; the ``DETERMINISTIC_COMPRESSORS`` ignore it.

The reference's ``get_top_k(x, ratio)`` keeps the top ``1 − ratio``
*fraction* (ratio 0.9 keeps 10 %), with ``k = max(1, int(n·(1−ratio)))`` —
kept here, quirk included.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

__all__ = [
    "COMPRESSOR_NAMES",
    "DETERMINISTIC_COMPRESSORS",
    "batched_random_k",
    "batched_top_k",
    "batched_top_k_approx",
    "batched_top_k_q8",
    "dense_from_sparse",
    "quantize_stochastic",
    "scatter_rows",
    "select_compressor",
    "top_k_ratio_size",
]


def top_k_ratio_size(dim: int, ratio: float) -> int:
    """``k = max(1, int(dim·(1−ratio)))`` — reference compressors.py:10."""
    return max(1, int(dim * (1.0 - ratio)))


def batched_top_k(x: torch.Tensor, ratio: float, gen=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-worker magnitude top-k of ``[N, D]``; the values keep their sign,
    the indices come unsorted (only the selected set matters downstream).

    At ``k ≥ D`` (ratio ≤ 0, a compression-warmup epoch 0) every coordinate
    is selected: the values are ``x`` itself and the indices ``arange``, no
    selection is run."""
    d = x.shape[-1]
    k = top_k_ratio_size(d, ratio)
    if k >= d:
        idx = torch.arange(d, dtype=torch.int32, device=x.device)
        return x, idx.expand(x.shape)
    idx = torch.topk(x.abs(), k, dim=-1, sorted=False).indices
    return torch.gather(x, -1, idx), idx.to(torch.int32)


def batched_random_k(x: torch.Tensor, ratio: float, gen
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k distinct coordinates a row, uniformly at random: the k largest of
    D uniform draws from ``gen``."""
    n, d = x.shape
    k = top_k_ratio_size(d, ratio)
    draws = torch.rand((n, d), generator=gen, device=x.device)
    idx = torch.topk(draws, k, dim=-1, sorted=False).indices
    return torch.gather(x, -1, idx), idx.to(torch.int32)


def scatter_rows(base: torch.Tensor, indices: torch.Tensor,
                 values: torch.Tensor, scale) -> torch.Tensor:
    """``base[i, indices[i, :]] += scale_i · values[i, :]`` for every worker
    ``i``, out of place; ``scale`` is a scalar or an ``[N]`` per-worker
    weight.  The product is formed first and then added, as the JAX
    package's ``.at[].add(scale * values)`` does; a repeated index in a row
    accumulates."""
    scale = torch.as_tensor(scale, dtype=base.dtype, device=base.device)
    if scale.ndim == 1:
        scale = scale[:, None]
    return base.scatter_add(1, indices.long(), scale * values)


def dense_from_sparse(indices: torch.Tensor, values: torch.Tensor,
                      dim: int) -> torch.Tensor:
    """Per-worker sparse messages as a dense ``[N, dim]`` stack."""
    zeros = torch.zeros((values.shape[0], dim), dtype=values.dtype,
                        device=values.device)
    return scatter_rows(zeros, indices, values, 1.0)


def quantize_stochastic(x: torch.Tensor, bits: int, gen) -> torch.Tensor:
    """QSGD-style unbiased stochastic quantization (dequantized form): per
    row, scale by the largest magnitude, round each entry to one of
    ``2^bits − 1`` levels up with probability equal to its fractional part
    (Bernoulli draws from ``gen``), then restore sign and scale.
    ``E[quantize(x)] = x``."""
    levels = (1 << bits) - 1
    scale = x.abs().amax(dim=-1, keepdim=True)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    y = x.abs() / safe * levels
    low = torch.floor(y)
    up = torch.bernoulli(y - low, generator=gen)
    return torch.sign(x) * ((low + up) / levels * scale)


def batched_top_k_q8(x: torch.Tensor, ratio: float, gen
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """top-k with the kept values stochastically quantized to 8 bits."""
    vals, idx = batched_top_k(x, ratio)
    return quantize_stochastic(vals, 8, gen), idx


def batched_top_k_approx(x: torch.Tensor, ratio: float, gen=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's approximate top-k (``lax.approx_max_k`` at recall
    0.95, a TPU lowering) as an exact ``torch.topk``.  On the CPU the JAX
    version lowers to the exact form too, which is why the two agree there.
    Unlike ``batched_top_k`` it has no keep-all branch: at ``k = D`` it
    returns a permutation of the coordinates."""
    k = top_k_ratio_size(x.shape[-1], ratio)
    idx = torch.topk(x.abs(), k, dim=-1, sorted=False).indices
    return torch.gather(x, -1, idx), idx.to(torch.int32)


_COMPRESSORS: dict[str, Callable] = {
    "top_k": batched_top_k,
    "random_k": batched_random_k,
    "top_k_q8": batched_top_k_q8,
    "top_k_approx": batched_top_k_approx,
}

#: the valid compressor names, for the config's validation and the CLI
COMPRESSOR_NAMES = tuple(_COMPRESSORS)

#: the compressors that ignore ``gen``; CHOCO carries a random state only
#: for the others
DETERMINISTIC_COMPRESSORS = frozenset({"top_k", "top_k_approx"})


def select_compressor(name: str) -> Callable:
    """The compressor ``(x, ratio, gen) -> (values, indices)`` by name."""
    if name not in _COMPRESSORS:
        raise KeyError(f"unknown compressor '{name}'; have "
                       f"{sorted(_COMPRESSORS)}")
    return _COMPRESSORS[name]
