"""Worker-stacked parameters <-> one ``[N, D]`` gossip vector per worker.

Port of ``matcha_tpu/ops/flatten.py``.  The JAX package flattens a pytree
whose leaves are ``[N, ...]`` arrays; here the tree is a mapping from a
dotted parameter name to an ``[N, ...]`` tensor (``dict(model.
named_parameters())``).  Leaves are ordered as JAX orders a flax tree —
sorted by key at every level, i.e. by the name's components — so leaf ``k``
of the port is leaf ``k`` of the JAX package (the element order inside a
leaf follows each framework's own layout).
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

__all__ = ["WorkerFlattener", "make_flattener", "tree_order"]


def tree_order(names) -> list:
    """Names in JAX tree order: sorted by their dotted components."""
    return sorted(names, key=lambda name: tuple(name.split(".")))


class WorkerFlattener:
    """Bidirectional ``{name: [N, ...]} <-> [N, D]`` mapping with a static
    layout."""

    def __init__(self, template: Mapping[str, torch.Tensor]):
        if not template:
            raise ValueError("empty parameter mapping")
        self.names = tree_order(template)
        n = template[self.names[0]].shape[0]
        for name in self.names:
            leaf = template[name]
            if leaf.ndim < 1 or leaf.shape[0] != n:
                raise ValueError(f"every leaf needs leading worker axis {n}; "
                                 f"{name} has {tuple(leaf.shape)}")
        self.num_workers = int(n)
        self.shapes = [tuple(template[k].shape[1:]) for k in self.names]
        self.dtypes = [template[k].dtype for k in self.names]
        self.sizes = [int(torch.Size(s).numel()) for s in self.shapes]
        self.offsets = [0]
        for size in self.sizes:
            self.offsets.append(self.offsets[-1] + size)
        self.dim = self.offsets[-1]

    def flatten(self, tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """``{name: [N, ...]}`` → ``f32[N, D]`` (a new tensor)."""
        return torch.cat([tree[k].detach().reshape(self.num_workers, -1)
                          .to(torch.float32) for k in self.names], dim=1)

    def _check(self, flat: torch.Tensor) -> None:
        if flat.ndim != 2 or flat.shape[1] != self.dim:
            raise ValueError(f"expected [N, {self.dim}], got "
                             f"{tuple(flat.shape)}")

    def unflatten(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``[N, D]`` → ``{name: [N, ...]}`` with the original shapes and
        dtypes."""
        self._check(flat)
        out = {}
        for i, name in enumerate(self.names):
            seg = flat[:, self.offsets[i]:self.offsets[i + 1]]
            out[name] = seg.reshape((flat.shape[0],) + self.shapes[i]).to(
                self.dtypes[i])
        return out

    def unflatten_into(self, flat: torch.Tensor,
                       tree: Mapping[str, torch.Tensor]) -> None:
        """Write ``[N, D]`` back into the tensors of ``tree`` in place (the
        model's own parameters), without recording autograd history."""
        self._check(flat)
        with torch.no_grad():
            for name, value in self.unflatten(flat).items():
                tree[name].copy_(value)


def make_flattener(template: Mapping[str, torch.Tensor]) -> WorkerFlattener:
    return WorkerFlattener(template)
