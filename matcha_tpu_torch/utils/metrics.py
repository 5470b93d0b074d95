"""Metrics: top-k accuracy and cross-entropy over the last two axes.

Port of ``matcha_tpu/utils/metrics.py``: ``logits [..., B, K]`` and
``labels [..., B]``; both reduce over the batch axis, so a worker-stacked
``[N, B, K]`` input gives one value per worker.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["cross_entropy_loss", "top_k_accuracy"]


def top_k_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                   k: int = 1) -> torch.Tensor:
    """Fraction of rows whose true label is within the top-k logits."""
    topk = torch.topk(logits, k, dim=-1).indices
    hit = (topk == labels.unsqueeze(-1)).any(dim=-1)
    return hit.to(torch.float32).mean(dim=-1)


def cross_entropy_loss(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood over the batch axis."""
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.long().unsqueeze(-1)).squeeze(-1)
    return nll.mean(dim=-1)
