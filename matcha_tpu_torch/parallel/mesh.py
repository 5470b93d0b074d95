"""The worker mesh: N virtual workers folded card-major onto C devices.

Port of ``matcha_tpu/parallel/mesh.py``: ``WORKER_AXIS``, ``worker_mesh``
(:24), ``fold_dims`` (:37), ``shard_workers`` (:76) and ``replicated``
(:103).  Worker ``g = c·L + l`` lives on card ``c`` as row ``l``, with
``L = N / C``.  The JAX package's arrays are global, each sharded over the
mesh; the port has no global tensor, so a folded ``[N, ...]`` tensor is a
:class:`WorkerBlocks`, the C ``[L, ...]`` blocks each on its card, and
:func:`gather_workers` turns it back into one tensor.

The mesh may name one device more than once: C virtual cards on one device
are the port's counterpart of the JAX tests' forced CPU devices, and let a
one-card host run the folded path (``devices=["cuda:0"] * 4``).  A CUDA
device that is not there raises; a mesh never falls back to the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import torch

__all__ = ["WORKER_AXIS", "WorkerBlocks", "WorkerMesh", "block_of",
           "fold_dims", "gather_workers", "replicated", "shard_workers",
           "split_like", "worker_mesh"]

WORKER_AXIS = "workers"


@dataclasses.dataclass(frozen=True)
class WorkerMesh:
    """A 1-D mesh: the devices of the worker axis, in card order (a device
    may repeat).  ``size`` and ``shape[axis]`` read as a JAX mesh's do."""

    devices: Tuple[torch.device, ...]
    axis: str = WORKER_AXIS

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis: len(self.devices)}


def _visible_cuda() -> list:
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [f"cuda:{i}" for i in range(count)]


def _check_device(dev: torch.device) -> torch.device:
    """``dev`` with its CUDA index made explicit; a CUDA device the host
    does not have raises ``ValueError`` naming the visible ones."""
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"the port runs on 'cuda' or 'cpu', got {dev}")
    visible = _visible_cuda()
    index = 0 if dev.index is None else dev.index
    if index >= len(visible):
        raise ValueError(f"mesh device {dev} is not visible; visible CUDA "
                         f"devices: {visible}")
    return torch.device("cuda", index)


def worker_mesh(num_devices: int | None = None, axis: str = WORKER_AXIS,
                devices: Sequence | None = None) -> WorkerMesh:
    """1-D mesh over ``devices`` (default: the visible CUDA cards), or the
    first ``num_devices`` of them.  Asking for more devices than there are
    raises ``ValueError`` naming the device list: the mesh never folds
    quietly onto fewer cards."""
    if devices is None:
        devs = [torch.device(d) for d in _visible_cuda()]
        if not devs:
            raise ValueError("no CUDA device is visible; pass devices=[...] "
                             "(e.g. ['cpu'] * 4) for a mesh on the CPU")
    else:
        devs = [torch.device(d) for d in devices]
    if num_devices is not None:
        if num_devices > len(devs):
            raise ValueError(f"asked for {num_devices} devices, have "
                             f"{len(devs)}: {[str(d) for d in devs]}")
        devs = devs[:num_devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return WorkerMesh(tuple(_check_device(d) for d in devs), axis)


def fold_dims(num_workers: int, mesh: WorkerMesh,
              axis: str = WORKER_AXIS) -> tuple[int, int]:
    """``(C, L)``: cards and workers per card for folding N workers onto
    the mesh."""
    c = mesh.shape[axis]
    if num_workers % c:
        raise ValueError(f"num_workers={num_workers} must be divisible by "
                         f"mesh axis size {c}")
    return c, num_workers // c


class WorkerBlocks:
    """A folded ``[N, ...]`` tensor: its C card-major ``[L, ...]`` blocks,
    block c on card c.  ``+`` and ``-`` act block by block (the two-phase
    mix's ``delta`` and its consume)."""

    __slots__ = ("blocks",)

    def __init__(self, blocks):
        self.blocks = tuple(blocks)

    def __len__(self) -> int:
        return len(self.blocks)

    def __iter__(self):
        return iter(self.blocks)

    def __getitem__(self, c: int) -> torch.Tensor:
        return self.blocks[c]

    @property
    def device(self) -> torch.device:
        """Card 0's device (where replicated host-side inputs are placed)."""
        return self.blocks[0].device

    def __add__(self, other: "WorkerBlocks") -> "WorkerBlocks":
        return WorkerBlocks(a + b for a, b in zip(self, other))

    def __sub__(self, other: "WorkerBlocks") -> "WorkerBlocks":
        return WorkerBlocks(a - b for a, b in zip(self, other))

    def zeros_like(self) -> "WorkerBlocks":
        return WorkerBlocks(torch.zeros_like(b) for b in self.blocks)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_workers(x, mesh: WorkerMesh, axis: str = WORKER_AXIS):
    """Fold ``[N, ...]`` tensors (a tensor or a dict/list/tuple of them)
    onto the mesh: each becomes a :class:`WorkerBlocks` of C card-major
    ``[L, ...]`` blocks, block c copied to card c (a block on its card's
    device already is a view, not a copy).  Scalars (0-d tensors, Python
    numbers) and generators are per-program state and stay single, as the
    JAX package replicates them; a leading dim that C does not divide is a
    ``ValueError``, never a silent re-placement."""
    def put(a):
        if not isinstance(a, torch.Tensor) or a.ndim == 0:
            return a
        _, rows = fold_dims(a.shape[0], mesh, axis)
        return WorkerBlocks(a[c * rows:(c + 1) * rows].to(dev)
                            for c, dev in enumerate(mesh.devices))

    return _tree_map(put, x)


def gather_workers(x, device=None):
    """The reverse of :func:`shard_workers`: every :class:`WorkerBlocks`
    of ``x`` concatenated in worker order onto ``device`` (default: card
    0's); anything else as it is."""

    def get(a):
        if not isinstance(a, WorkerBlocks):
            return a
        dev = a.device if device is None else torch.device(device)
        return torch.cat([b.to(dev) for b in a.blocks])

    if isinstance(x, WorkerBlocks):
        return get(x)
    return _tree_map(get, x)


def split_like(x: torch.Tensor, blocks) -> WorkerBlocks:
    """An ``[N, ...]`` tensor cut as ``blocks`` (a ``WorkerBlocks``) is
    cut: block c's rows on block c's device (a per-worker mask's slice
    for each card, say; a view where the device is the same)."""
    out, lo = [], 0
    for b in blocks:
        out.append(x[lo:lo + b.shape[0]].to(b.device))
        lo += b.shape[0]
    return WorkerBlocks(out)


def block_of(tree, c: int):
    """Card c's rows of a carry-like value: block c of every
    ``WorkerBlocks`` entry (the block's own tensor, so an in-place write
    reaches the folded value), anything else as it is."""
    if isinstance(tree, WorkerBlocks):
        return tree[c]
    return _tree_map(lambda a: a[c] if isinstance(a, WorkerBlocks) else a,
                     tree)


def replicated(x, mesh: WorkerMesh):
    """A copy of small tensors (flags, survivor masks) on every card:
    a tuple of C, one per card (one tensor object per distinct device)."""
    def put(a):
        if not isinstance(a, torch.Tensor):
            return a
        per_device = {}
        for dev in mesh.devices:
            if dev not in per_device:
                per_device[dev] = a.to(dev)
        return tuple(per_device[dev] for dev in mesh.devices)

    return _tree_map(put, x)
