"""Multi-process support for the worker mesh, over ``torch.distributed``.

Port of ``matcha_tpu/parallel/multihost.py``: ``initialize_multihost``
(:34), ``global_worker_mesh`` (:69) and ``dcn_aware_worker_order`` (:79).
The reference scales across hosts with ``mpirun -np N`` and blocking
sendrecv; the JAX package runs one SPMD program per host over a global
device set.  The port runs one process per card: every process runs the
same program, ``initialize_multihost`` joins them into one
``torch.distributed`` group (NCCL between cards, gloo on the CPU), and
``global_worker_mesh`` lists every process's cards in rank order.  A
folded value then holds each process's own blocks (``mesh.WorkerBlocks``
with its ``mesh`` set), and what crosses processes moves here:

* :func:`exchange`: one batch of point-to-point moves
  (``dist.batch_isend_irecv``) whose list every process derives from
  replicated inputs alone (the plan, the host flag row) in one order, so
  that sends and receives pair up and no process waits on a move that its
  peer never posts; :func:`exchange_reads` derives that list from the
  ``(card, offset)`` reads of a folded step (the gossip's wire images,
  CHOCO's compressed messages);
* :func:`all_cards`: one small tensor per card (a column sum) handed to
  every process, in card order;
* :func:`gather_to_first` and :func:`scatter_tree_from_first`: a folded
  value onto the mesh's first card and back (the one-tensor backends);
* :func:`broadcast_object` and :func:`check_same_schedule`.

gloo takes host tensors only: with gloo, a block on a card is staged
through pinned host memory on both sides, here and explicitly.  Every
payload moves as its raw bytes, so any dtype (bf16 included) crosses
either backend unchanged.  ``TRAFFIC`` counts the messages and bytes this
process sent to other processes.
"""

from __future__ import annotations

import datetime
import hashlib
import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .mesh import (
    WORKER_AXIS,
    MeshDevice,
    WorkerBlocks,
    WorkerMesh,
    _tree_map,
    is_worker_rows,
    worker_mesh,
)

__all__ = ["TRAFFIC", "all_cards", "broadcast_object",
           "check_same_schedule", "dcn_aware_worker_order", "exchange",
           "exchange_reads", "gather_to_first", "global_worker_mesh",
           "initialize_multihost", "reset_traffic",
           "scatter_tree_from_first"]

#: messages and bytes this process sent to other processes
TRAFFIC = {"messages": 0, "bytes": 0}


def reset_traffic() -> None:
    TRAFFIC.update(messages=0, bytes=0)


def _env_int(name: str) -> int:
    try:
        return int(os.environ[name])
    except KeyError:
        raise ValueError(f"initialize_multihost: pass the argument or set "
                         f"{name} in the environment") from None


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None,
                         timeout: float = 300.0,
                         devices: Optional[Sequence] = None) -> bool:
    """Idempotent ``torch.distributed.init_process_group`` wrapper.

    Returns False only in the two benign cases: already initialized, or
    no multi-process configuration anywhere (no arguments and no cluster
    environment: torchrun's ``MASTER_ADDR`` with ``WORLD_SIZE``); the
    caller is then a one-process program.  A failed initialization with
    arguments or an environment re-raises: each process falling back to
    its own cards would train N divergent models instead of one.

    ``coordinator_address``: ``host:port`` (made ``tcp://``) or an
    init-method URL (``file:///path``: a FileStore, which needs no port).
    Without it the environment's ``env://`` rendezvous is used, and
    ``num_processes``/``process_id`` default to ``WORLD_SIZE``/``RANK``.
    ``backend``: ``nccl`` when this process's cards are CUDA cards, else
    ``gloo``; the caller's choice, never a reaction to a failure.
    ``devices``: this process's cards, as later given to
    :func:`global_worker_mesh` (default: one CUDA card where CUDA is
    available, else the CPU); they decide the default backend.
    ``timeout`` (seconds) bounds the rendezvous and every later
    collective, so that a missing peer raises instead of hanging."""
    if dist.is_initialized():
        return False
    env_configured = bool(os.environ.get("MASTER_ADDR")) \
        and bool(os.environ.get("WORLD_SIZE"))
    if coordinator_address is None and num_processes is None \
            and not env_configured:
        return False  # one process: nothing to wire
    if backend is None:
        backend = ("nccl" if _local_devices(devices)[0].type == "cuda"
                   else "gloo")
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    world = (int(num_processes) if num_processes is not None
             else _env_int("WORLD_SIZE"))
    rank = int(process_id) if process_id is not None else _env_int("RANK")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    return True


def _local_devices(devices: Optional[Sequence] = None) -> list:
    """This process's cards: ``devices`` when given; else, with CUDA, one
    card, ``cuda:{LOCAL_RANK}`` (the rank modulo the visible cards when
    the launcher sets no ``LOCAL_RANK``); else the CPU."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    if torch.cuda.is_available():
        rank = dist.get_rank() if dist.is_initialized() else 0
        index = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        return [torch.device("cuda", index)]
    return [torch.device("cpu")]


def global_worker_mesh(axis: str = WORKER_AXIS,
                       devices: Optional[Sequence] = None) -> WorkerMesh:
    """1-D worker mesh over every process's cards, in rank order.

    Each process names its own cards (``_local_devices``: ``devices``,
    or one card a process on CUDA, the CPU otherwise), and one all-gather
    of those names gives every process the same list.  On CUDA the card is
    made this process's current device, as NCCL requires.  Outside an
    initialized group this is ``worker_mesh(devices=devices)``."""
    if not dist.is_initialized():
        return worker_mesh(axis=axis, devices=devices)
    mine = _local_devices(devices)
    if mine[0].type == "cuda":
        torch.cuda.set_device(mine[0])
    per_rank = [None] * dist.get_world_size()
    dist.all_gather_object(per_rank, [str(d) for d in mine])
    entries = []
    for rank, names in enumerate(per_rank):
        for name in names:
            entries.append(MeshDevice(torch.device(name), rank, len(entries)))
    return worker_mesh(axis=axis, devices=entries)


def dcn_aware_worker_order(num_workers: int,
                           devices: Optional[Sequence] = None) -> np.ndarray:
    """The devices sorted by ``(process_index, id)``, so that workers,
    which fold onto devices card-major, group by process and
    locality-friendly topologies keep their edges inside a process.
    ``devices``: anything with those two fields (default: the entries of
    :func:`global_worker_mesh`).  Returns the order to pass to
    ``worker_mesh(devices=...)``; ``ValueError`` when the device count
    does not divide ``num_workers``."""
    devs = list(devices if devices is not None
                else global_worker_mesh().entries)
    order = sorted(range(len(devs)),
                   key=lambda i: (devs[i].process_index, devs[i].id))
    if num_workers % len(devs):
        raise ValueError(f"num_workers={num_workers} must be divisible by "
                         f"{len(devs)} devices")
    return np.asarray([devs[i] for i in order], dtype=object)


# ---------------------------------------------------------------------------
# Transport
# ---------------------------------------------------------------------------

def _staged() -> bool:
    """Whether the group's backend takes host tensors only (gloo)."""
    return dist.get_backend() == "gloo"


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def exchange(messages: Sequence, send: Callable, receive_as: Callable) -> dict:
    """Post one batch of point-to-point moves and wait for it.

    ``messages``: ``(key, source rank, destination rank)`` triples, the
    same list in the same order on every process (derived from
    replicated inputs only); a process posts the sends and receives that
    name it, all in one ``dist.batch_isend_irecv``, each tagged with its
    place in the list.  ``send(key)``: the tensor this process sends;
    ``receive_as(key)``: ``(shape, dtype, device)`` of what it receives.
    Returns ``{key: tensor}`` of the received messages.  A process that
    neither sends nor receives posts nothing.  With gloo a payload on a
    card is copied into pinned host memory before the send, and a message
    for a card lands in pinned host memory and is copied there after."""
    me = dist.get_rank()
    staged = _staged()
    ops, landing = [], {}
    for tag, (key, src, dst) in enumerate(messages):
        if src == dst:
            raise ValueError(f"message {key!r} from rank {src} to itself")
        if src == me:
            buf = _as_bytes(send(key))
            if staged and buf.device.type != "cpu":
                host = torch.empty(buf.shape, dtype=torch.uint8,
                                   pin_memory=True)
                host.copy_(buf)
                buf = host
            ops.append(dist.P2POp(dist.isend, buf, dst, tag=tag))
            TRAFFIC["messages"] += 1
            TRAFFIC["bytes"] += buf.numel()
        elif dst == me:
            shape, dtype, device = receive_as(key)
            device = torch.device(device)
            nbytes = int(np.prod(shape, dtype=np.int64)) \
                * torch.empty((), dtype=dtype).element_size()
            on_host = staged and device.type != "cpu"
            buf = torch.empty(nbytes, dtype=torch.uint8,
                              device="cpu" if staged else device,
                              pin_memory=on_host)
            ops.append(dist.P2POp(dist.irecv, buf, src, tag=tag))
            landing[key] = (buf, shape, dtype, device)
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    out = {}
    for key, (buf, shape, dtype, device) in landing.items():
        if buf.device != device:
            buf = buf.to(device, non_blocking=True)
        out[key] = buf.view(dtype).reshape(shape)
    return out


def exchange_reads(mesh: WorkerMesh, reads, payload: Callable,
                   landing: Callable) -> dict:
    """What this process's cards read from other processes' cards, in one
    :func:`exchange`.  ``reads``: ``(card, offset)`` pairs, card c reading
    card ``(c + offset) mod C``'s payload, the same on every process
    (derived from the plan and the replicated flag row alone).  A payload
    goes once to each other process with a card that reads it, however
    many of its cards do; a read within one process moves nothing here.
    ``payload(card)``: the tuple of tensors a card held here sends;
    ``landing(card)``: one ``(shape, dtype, device)`` for each of them.
    Returns ``{card: tuple of tensors}`` of the cards read here."""
    cards = mesh.size
    moves = sorted({((c + d) % cards, mesh.owner(c)) for c, d in reads
                    if mesh.owner((c + d) % cards) != mesh.owner(c)})
    if not moves:
        return {}
    parts = range(len(landing(moves[0][0])))
    got = exchange([((s, r, p), mesh.owner(s), r) for s, r in moves
                    for p in parts],
                   lambda key: payload(key[0])[key[2]],
                   lambda key: landing(key[0])[key[2]])
    return {s: tuple(got[(s, r, p)] for p in parts)
            for s, r in moves if r == mesh.rank}


def all_cards(mesh: WorkerMesh, parts: dict, device) -> list:
    """Every card's tensor on ``device``, in card order: ``parts`` holds
    this process's (``{card: tensor}``, one shape and dtype for all), and
    each is sent to every other process of the mesh in one
    :func:`exchange`.  A part held here is moved with ``.to(device)``, as
    a one-process caller moves each card's part to card 0."""
    like = next(iter(parts.values()))
    ranks = sorted(set(mesh.ranks))
    messages = [((c, r), mesh.owner(c), r) for c in range(mesh.size)
                for r in ranks if r != mesh.owner(c)]
    got = exchange(messages, lambda key: parts[key[0]],
                   lambda key: (tuple(like.shape), like.dtype, device))
    return [parts[c].to(device) if c in parts else got[(c, mesh.rank)]
            for c in range(mesh.size)]


def broadcast_object(obj, src: int):
    """``obj`` as process ``src`` holds it, on every process (pickled;
    small values only)."""
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def check_same_schedule(schedule) -> None:
    """Raise ``ValueError`` on every process unless every process holds
    the same schedule (its matchings, α and flag stream: one all-gather
    of a digest), naming the ranks whose schedule differs from rank
    0's: processes mixing by different schedules would train divergent
    models without a word."""
    h = hashlib.sha256()
    for a in (np.ascontiguousarray(schedule.perms, dtype=np.int64),
              np.ascontiguousarray(schedule.flags, dtype=np.float64)):
        h.update(repr(a.shape).encode())
        h.update(a.tobytes())
    h.update(repr(float(schedule.alpha)).encode())
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, h.hexdigest())
    differ = [r for r, d in enumerate(every) if d != every[0]]
    if differ:
        raise ValueError(
            f"the gossip schedule (perms, alpha, flags) differs across "
            f"processes: ranks {differ} built another than rank 0's; "
            f"processes mixing by different schedules would train "
            f"divergent models")


def gather_to_first(value: WorkerBlocks) -> Optional[torch.Tensor]:
    """A folded value on a mesh that spans processes, concatenated in card
    order on the mesh's first card, in the process that owns it (every
    other card's block sent there in one :func:`exchange`); None in the
    other processes."""
    mesh = value.mesh
    first = mesh.owner(0)
    mine = dict(zip(value.cards, value))
    like = value[0]
    messages = [(c, mesh.owner(c), first) for c in range(mesh.size)
                if mesh.owner(c) != first]
    got = exchange(messages, lambda c: mine[c],
                   lambda c: (tuple(like.shape), like.dtype,
                              mesh.devices[0]))
    if mesh.rank != first:
        return None
    return torch.cat([mine[c].to(mesh.devices[0]) if c in mine else got[c]
                      for c in range(mesh.size)])


class _Rows:
    """A worker-major tensor's place in a broadcast skeleton."""

    def __init__(self, index: int, shape, dtype):
        self.index, self.shape, self.dtype = index, tuple(shape), dtype


def scatter_tree_from_first(tree, mesh: WorkerMesh, num_workers: int):
    """The reverse of :func:`gather_to_first` for a whole result: ``tree``
    (held by the process that owns the first card; anything in the
    others) with every floating tensor of ``num_workers`` rows folded
    onto ``mesh`` (each process keeping its cards' rows) and every other
    leaf given to every process.  The tree's layout travels as one small
    broadcast, the rows in one :func:`exchange`."""
    first = mesh.owner(0)
    rows = []

    def is_rows(a):
        return is_worker_rows(a, num_workers)

    def strip(a):
        if is_rows(a):
            rows.append(a)
            return _Rows(len(rows) - 1, a.shape, a.dtype)
        return a.cpu() if isinstance(a, torch.Tensor) else a

    skeleton = broadcast_object(
        _tree_map(strip, tree) if mesh.rank == first else None, first)
    specs = []
    _tree_map(lambda a: specs.append(a) if isinstance(a, _Rows) else None,
              skeleton)
    cards = mesh.size
    per = num_workers // cards
    messages = [((s.index, c), first, mesh.owner(c)) for s in specs
                for c in range(cards) if mesh.owner(c) != first]
    got = exchange(messages,
                   lambda key: rows[key[0]][key[1] * per:(key[1] + 1) * per],
                   lambda key: ((per,) + specs[key[0]].shape[1:],
                                specs[key[0]].dtype, mesh.devices[key[1]]))

    def blocks(spec):
        return WorkerBlocks(
            (rows[spec.index][c * per:(c + 1) * per].to(mesh.devices[c])
             if mesh.rank == first else got[(spec.index, c)]
             for c in mesh.local_cards), mesh)

    if mesh.rank == first:
        order = iter(specs)  # the same walk as strip's
        return _tree_map(lambda a: blocks(next(order)) if is_rows(a) else a,
                         tree)
    return _tree_map(lambda a: blocks(a) if isinstance(a, _Rows) else a,
                     skeleton)
