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

A mesh may span processes (``parallel.multihost.global_worker_mesh``):
``WorkerMesh.ranks`` then names the process that owns each card, and a
``WorkerBlocks`` on it holds only this process's blocks (its
``mesh.local_cards``).  No process holds another's block except as a
received wire image, so such a value cannot be gathered into one tensor
here; the communicators move what they need through
``parallel.multihost``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import torch

__all__ = ["WORKER_AXIS", "MeshDevice", "WorkerBlocks", "WorkerMesh",
           "block_of", "check_blocks", "fold_dims", "gather_workers",
           "is_worker_rows", "replicated", "shard_workers", "split_like",
           "worker_mesh"]

WORKER_AXIS = "workers"


@dataclasses.dataclass(frozen=True)
class MeshDevice:
    """One card of a mesh as JAX names a device: the card, the process
    that owns it (``process_index``) and its global ``id`` (its place in
    the rank-major list of every process's cards)."""

    device: torch.device
    process_index: int = 0
    id: int = 0


@dataclasses.dataclass(frozen=True)
class WorkerMesh:
    """A 1-D mesh: the devices of the worker axis, in card order (a device
    may repeat, also across processes).  ``size`` and ``shape[axis]`` read
    as a JAX mesh's do.  ``ranks``: the process that owns each card
    (empty: every card is this process's); ``rank``: this process."""

    devices: Tuple[torch.device, ...]
    axis: str = WORKER_AXIS
    ranks: Tuple[int, ...] = ()
    rank: int = 0

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis: len(self.devices)}

    @property
    def multi_process(self) -> bool:
        """Whether the cards belong to more than one process."""
        return len(set(self.ranks)) > 1

    def owner(self, card: int) -> int:
        """The process that holds card ``card``'s block."""
        return self.ranks[card] if self.ranks else self.rank

    @property
    def local_cards(self) -> Tuple[int, ...]:
        """The cards whose blocks this process holds, in card order."""
        return tuple(c for c in range(self.size)
                     if self.owner(c) == self.rank)

    @property
    def home(self) -> torch.device:
        """This process's first card: where it places replicated inputs."""
        return self.devices[self.local_cards[0]]

    @property
    def entries(self) -> Tuple[MeshDevice, ...]:
        """The cards as ``MeshDevice`` entries, in card order."""
        return tuple(MeshDevice(d, self.owner(c), c)
                     for c, d in enumerate(self.devices))


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


def _this_rank() -> int:
    import torch.distributed as dist

    return (dist.get_rank() if dist.is_available() and dist.is_initialized()
            else 0)


def worker_mesh(num_devices: int | None = None, axis: str = WORKER_AXIS,
                devices: Sequence | None = None) -> WorkerMesh:
    """1-D mesh over ``devices`` (default: the visible CUDA cards), or the
    first ``num_devices`` of them.  Asking for more devices than there are
    raises ``ValueError`` naming the device list: the mesh never folds
    quietly onto fewer cards.  ``devices`` may be ``MeshDevice`` entries
    (``dcn_aware_worker_order``'s answer): the mesh then spans their
    processes, and only this process's cards are checked here."""
    if devices is None:
        devs = [torch.device(d) for d in _visible_cuda()]
        if not devs:
            raise ValueError("no CUDA device is visible; pass devices=[...] "
                             "(e.g. ['cpu'] * 4) for a mesh on the CPU")
    else:
        devs = list(devices)
    if num_devices is not None:
        if num_devices > len(devs):
            raise ValueError(f"asked for {num_devices} devices, have "
                             f"{len(devs)}: {[str(d) for d in devs]}")
        devs = devs[:num_devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    if not any(isinstance(d, MeshDevice) for d in devs):
        return WorkerMesh(tuple(_check_device(torch.device(d))
                                for d in devs), axis)
    if not all(isinstance(d, MeshDevice) for d in devs):
        raise ValueError("a mesh's devices are all MeshDevice entries or "
                         "none is")
    rank = _this_rank()
    return WorkerMesh(
        tuple(_check_device(torch.device(e.device))
              if e.process_index == rank else torch.device(e.device)
              for e in devs),
        axis, tuple(int(e.process_index) for e in devs), rank)


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
    mix's ``delta`` and its consume).  ``mesh``: set on a mesh that spans
    processes, whose ``local_cards`` are then the cards of the blocks held
    here; None when every block is here."""

    __slots__ = ("blocks", "mesh")

    def __init__(self, blocks, mesh: WorkerMesh | None = None):
        self.blocks = tuple(blocks)
        self.mesh = mesh if mesh is not None and mesh.multi_process else None

    @property
    def cards(self) -> Tuple[int, ...]:
        """The global card index of each block held here."""
        if self.mesh is None:
            return tuple(range(len(self.blocks)))
        return self.mesh.local_cards

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
        return WorkerBlocks((a + b for a, b in zip(self, other)), self.mesh)

    def __sub__(self, other: "WorkerBlocks") -> "WorkerBlocks":
        return WorkerBlocks((a - b for a, b in zip(self, other)), self.mesh)

    def zeros_like(self) -> "WorkerBlocks":
        return WorkerBlocks((torch.zeros_like(b) for b in self.blocks),
                            self.mesh)


def check_blocks(x, mesh: WorkerMesh, rows: int, what: str) -> None:
    """Raise unless ``x`` is a :class:`WorkerBlocks` of this process's
    cards of ``mesh`` (``mesh.local_cards``), each block ``rows`` rows on
    its card, that carries the mesh exactly when the mesh spans
    processes: the placement a folded backend reads."""
    if not isinstance(x, WorkerBlocks):
        raise TypeError(f"{what} takes a WorkerBlocks "
                        f"(shard_workers(x, mesh)), got {type(x)}")
    want = [str(mesh.devices[c]) for c in mesh.local_cards]
    placed = [str(b.device) for b in x]
    if placed != want or any(b.shape[0] != rows for b in x) \
            or (x.mesh is None) == mesh.multi_process:
        raise ValueError(f"{what}: blocks {[tuple(b.shape) for b in x]} "
                         f"on {placed}; this process's cards of the mesh "
                         f"are {want}, {rows} rows each")


def is_worker_rows(a, num_workers: int) -> bool:
    """Whether ``a`` is a worker-major floating tensor of ``num_workers``
    rows: what a carry folds onto a mesh (a generator's state does not)."""
    return (isinstance(a, torch.Tensor) and a.is_floating_point()
            and a.ndim >= 1 and a.shape[0] == num_workers)


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
    ``ValueError``, never a silent re-placement.  On a mesh that spans
    processes each process keeps the rows of its own cards."""
    def put(a):
        if not isinstance(a, torch.Tensor) or a.ndim == 0:
            return a
        _, rows = fold_dims(a.shape[0], mesh, axis)
        return WorkerBlocks((a[c * rows:(c + 1) * rows].to(mesh.devices[c])
                             for c in mesh.local_cards), mesh)

    return _tree_map(put, x)


def gather_workers(x, device=None):
    """The reverse of :func:`shard_workers`: every :class:`WorkerBlocks`
    of ``x`` concatenated in worker order onto ``device`` (default: card
    0's); anything else as it is.  A value on a mesh that spans processes
    raises ``ValueError``: its other blocks are in other processes
    (``parallel.multihost.gather_to_first`` moves them explicitly)."""

    def get(a):
        if not isinstance(a, WorkerBlocks):
            return a
        if a.mesh is not None:
            raise ValueError("this WorkerBlocks holds only this process's "
                             "cards of a mesh that spans processes; gather "
                             "it with parallel.multihost.gather_to_first")
        dev = a.device if device is None else torch.device(device)
        return torch.cat([b.to(dev) for b in a.blocks])

    if isinstance(x, WorkerBlocks):
        return get(x)
    return _tree_map(get, x)


def split_like(x: torch.Tensor, blocks) -> WorkerBlocks:
    """An ``[N, ...]`` tensor cut as ``blocks`` (a ``WorkerBlocks``) is
    cut: block c's rows on block c's device (a per-worker mask's slice
    for each card, say; a view where the device is the same).  On a mesh
    that spans processes, the rows of the cards held here."""
    if blocks.mesh is not None:
        return WorkerBlocks((x[c * b.shape[0]:(c + 1) * b.shape[0]]
                             .to(b.device)
                             for c, b in zip(blocks.cards, blocks)),
                            blocks.mesh)
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
    """A copy of small tensors (flags, survivor masks) on every card held
    here: a tuple, one per card of ``mesh.local_cards`` (C of them on a
    mesh of one process; one tensor object per distinct device)."""
    def put(a):
        if not isinstance(a, torch.Tensor):
            return a
        per_device = {}
        devs = [mesh.devices[c] for c in mesh.local_cards]
        for dev in devs:
            if dev not in per_device:
                per_device[dev] = a.to(dev)
        return tuple(per_device[dev] for dev in devs)

    return _tree_map(put, x)
