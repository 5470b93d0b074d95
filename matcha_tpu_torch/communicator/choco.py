"""CHOCO-SGD communicator: gossip on compressed model differences.

Port of ``matcha_tpu/communicator/choco.py`` (``_choco_core`` :59,
``make_choco`` :106, the ``shard_map`` backend :226-365), after the
reference's ``ChocoCommunicator`` (``communicator.py:161-268``):

    q_i   = compress(x_i − x̂_i)              (top-k keeps 1 − ratio)
    s_i  += Σ_{j active, partnered} α·scatter(q_{π_j(i)})
    s_i  += (1 − d_i·α)·scatter(q_i)
    x̂_i  += scatter(q_i)
    x_i  += γ·(s_i − x̂_i)                     (γ = consensus_lr)

The carry is ``{"x_hat", "s"}``, zero at the start (the reference's lazy
init) and never decayed (quirk Q4, kept); under a time-varying W the
accumulator ``s`` keeps the reference's cross terms.  A stochastic
compressor adds ``"key"``: the state of its ``torch.Generator`` as a uint8
tensor (``Generator.get_state()``), so a checkpoint holds it as a plain
tensor.  The random state advances on every step, the frozen ones
included, as the JAX key is split before the freeze.

A step whose flag row is all zero leaves ``x``, ``x̂`` and ``s`` untouched
(the reference's early return), by scaling every update by an ``active``
factor on the device: the step never reads the card.  Each row's
top-k indices are distinct, so no ``scatter_add`` below adds twice to one
element and its result does not depend on the order of the adds; the
global deterministic mode is not needed.

Backends:

``batched``
    The ``[N, D]`` one-tensor form: a neighbour's message is a row gather
    (``vals[π_j]``).  On a mesh of more than one device it runs on the
    mesh's first card, the state and the ``{x̂, s}`` carry gathered there
    for each call and folded back (``base.gathered_communicator``), so the
    carry is checkpointed as a folded carry is.
``shard_map``
    The workers folded card-major across a worker mesh
    (``parallel.WorkerBlocks``): each card compresses its ``[L, D]``
    block, stacks its own and the ``[L, k]`` compressed blocks of the
    cards its rows' partners sit on (moved at the wire dtype, the indices
    as int32; never the dense state), picks each matching's partner
    messages out of that stack with one row gather, as the folded plan
    of ``parallel.build_folded_plan`` places them, and runs
    ``_choco_core`` on its own rows.  The carry ``{x̂, s}`` is folded
    like the state.  Every row's arithmetic is the batched form's, so a
    deterministic compressor gives the batched bits whatever C is.  On a
    mesh that spans processes (``parallel.multihost``) the compressed
    blocks that cross processes move in one batched send/recv a step:
    the real wire, top-k values and indices, never the dense block.  A
    stochastic compressor draws on each card from a stream of its own,
    made from the step's one generator state and the card index (JAX's
    ``fold_in(key, c)``): card 0 draws from the carried generator itself,
    card c from a generator seeded by a hash of that state and c, so the
    draws depend on C (as in JAX) and C = 1 is the batched form.
``auto``
    ``shard_map`` on a mesh of more than one device, else ``batched``.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from ..ops import (
    DETERMINISTIC_COMPRESSORS,
    scatter_rows,
    select_compressor,
    top_k_ratio_size,
)
from ..parallel import WorkerBlocks, resolve_wire_dtype
from ..parallel.mesh import check_blocks
from ..parallel.multihost import (
    broadcast_object,
    check_same_schedule,
    exchange_reads,
)
from ..schedule import Schedule
from ..utils import resolve_device
from .base import Communicator, gathered_communicator

__all__ = ["folded_message_bytes", "make_choco"]


def _choco_core(vals, idx, x_hat, s, flat, flags_t, *, gather_msg,
                partnered_rows, matching_nonempty, alpha, consensus_lr,
                aligned_full=False):
    """One CHOCO step given this step's compressed messages ``(vals, idx)``
    (int64 indices).  ``gather_msg(j) -> (vals[π_j], idx[π_j])``;
    ``partnered_rows``: ``f32[M, N]`` partner mask; ``matching_nonempty``:
    host bools, a matching with no edge anywhere is skipped.

    ``aligned_full`` (the exact ``top_k`` compressor only, whose keep-all
    branch emits ``arange`` indices): at message width D every scatter is
    a dense weighted add.  ``random_k`` at k = D emits a permutation and
    keeps the scatter."""
    keep_all = aligned_full and vals.shape[-1] == s.shape[-1]

    def add(base, g_idx, g_vals, scale):
        if scale.ndim == 1:
            scale = scale[:, None]
        if keep_all:
            return base + scale * g_vals
        return base.scatter_add(1, g_idx, scale * g_vals)

    active = (flags_t.sum() > 0).to(flat.dtype)  # 0 ⇒ frozen step
    for j, nonempty in enumerate(matching_nonempty):
        if not nonempty:
            continue
        g_vals, g_idx = gather_msg(j)
        scale = active * flags_t[j] * alpha * partnered_rows[j]
        s = add(s, g_idx, g_vals, scale)
    # the self message, weighted 1 − d_i·α (d_i the active degree)
    deg = partnered_rows.T @ flags_t
    s = add(s, idx, vals, active * (1.0 - deg * alpha))
    x_hat = add(x_hat, idx, vals, active)
    flat = flat + active * consensus_lr * (s - x_hat)
    return flat, x_hat, s


def make_choco(
    schedule: Schedule,
    ratio: float = 0.9,
    consensus_lr: float = 0.1,
    *,
    backend: str = "batched",
    compressor: str = "top_k",
    seed: int = 0,
    wire_dtype=None,
    device=None,
    mesh=None,
) -> Communicator:
    """Build the CHOCO communicator.

    ``ratio``: keep the top ``1 − ratio`` fraction (the reference's
    semantics).  ``consensus_lr`` is γ.  ``compressor`` names an entry of
    ``ops.COMPRESSOR_NAMES``; the stochastic ones draw from a generator
    seeded ``seed``, whose state rides the carry.  ``wire_dtype``
    (``"f32"``/``"bf16"``/None): the compressed values are quantized to
    the wire dtype once, right after ``compress``, so the exchange, the
    self message and the ``x̂`` update all read the same values (between
    two cards of a mesh they move at the wire dtype, losslessly).
    ``backend``: ``batched``, ``shard_map`` (needs ``mesh``, a
    ``parallel.WorkerMesh``; ``step``, ``run`` and ``encode_probe`` then
    take and return ``WorkerBlocks``) or ``auto`` (module docstring); the
    batched form on a mesh of more than one device runs on its first card
    (module docstring).  ``device``: where the batched form's partner
    tables live (``None``: the card)."""
    if backend == "auto":
        backend = ("shard_map" if mesh is not None and mesh.size > 1
                   else "batched")
    if backend not in ("batched", "shard_map"):
        raise KeyError(f"unknown choco backend '{backend}'")
    if backend == "shard_map" and mesh is None:
        raise ValueError("shard_map backend needs a mesh")
    if mesh is not None and mesh.multi_process:
        check_same_schedule(schedule)
    if backend == "batched" and mesh is not None and mesh.size > 1:
        return gathered_communicator(make_choco(
            schedule, ratio, consensus_lr, compressor=compressor, seed=seed,
            wire_dtype=wire_dtype, device=mesh.home), mesh)
    perms = np.asarray(schedule.perms)
    alpha = float(schedule.alpha)
    m, n = perms.shape
    wire = resolve_wire_dtype(wire_dtype)
    # partner masks: a fixed point exchanges nothing (communicator.py:210)
    partnered_np = (perms != np.arange(n)[None, :]).astype(np.float32)
    nonempty = [bool(partnered_np[j].any()) for j in range(m)]
    base_compress = select_compressor(compressor)
    if wire is None:
        compress = base_compress
    else:
        def compress(q, ratio_, gen):
            vals, idx = base_compress(q, ratio_, gen)
            return vals.to(wire).to(q.dtype), idx
    stochastic = compressor not in DETERMINISTIC_COMPRESSORS
    aligned_full = compressor == "top_k"
    name = f"choco[r{ratio}" + ("" if compressor == "top_k"
                                else f",{compressor}")
    if wire is not None:
        name += ",wire=bfloat16"

    def generator(dev, state=None):
        gen = torch.Generator(device=dev)
        if state is None:
            return gen.manual_seed(seed)
        gen.set_state(state.cpu())
        return gen

    def probe_one(flat: torch.Tensor, x_hat: torch.Tensor) -> torch.Tensor:
        gen = torch.Generator(device=flat.device).manual_seed(0)
        vals, idx = compress(flat - x_hat, ratio, gen)
        return scatter_rows(x_hat, idx, vals, 1.0)

    if backend == "shard_map":
        return _folded_choco(
            name, perms, partnered_np, nonempty, mesh, compress, generator,
            probe_one, stochastic=stochastic, aligned_full=aligned_full,
            ratio=ratio, alpha=alpha, consensus_lr=consensus_lr, wire=wire)

    dev = resolve_device(device)
    perms_t = torch.as_tensor(perms, dtype=torch.long, device=dev)
    partnered = torch.as_tensor(partnered_np, device=dev)

    def init(flat: torch.Tensor):
        carry = {"x_hat": torch.zeros_like(flat), "s": torch.zeros_like(flat)}
        if stochastic:
            carry["key"] = generator(flat.device).get_state()
        return carry

    def encode_probe(flat: torch.Tensor, x_hat: torch.Tensor) -> torch.Tensor:
        """The compress path alone (subtract, top-k, gather) and CHOCO's
        ``x̂ += scatter(q)``, for the comm-split timer's encode chain; a
        stochastic compressor draws from a fresh generator seeded 0 (the
        probe models the cost, not the sample path)."""
        return probe_one(flat, x_hat)

    def step(flat: torch.Tensor, carry, flags_t: torch.Tensor, alive=None):
        gen = generator(flat.device, carry["key"]) if stochastic else None
        vals, idx = compress(flat - carry["x_hat"], ratio, gen)
        idx = idx.long()

        def gather_msg(j):
            return vals[perms_t[j]], idx[perms_t[j]]

        partnered_eff = partnered
        if alive is not None:
            # an edge needs both ends alive: alive_i · alive_{π_j(i)}
            partnered_eff = partnered * alive[None, :] * alive[perms_t]
        flat, x_hat, s = _choco_core(
            vals, idx, carry["x_hat"], carry["s"], flat, flags_t,
            gather_msg=gather_msg, partnered_rows=partnered_eff,
            matching_nonempty=nonempty, alpha=alpha,
            consensus_lr=consensus_lr, aligned_full=aligned_full)
        out = {"x_hat": x_hat, "s": s}
        if stochastic:
            out["key"] = gen.get_state()
        return flat, out

    return Communicator(name=name + "]", init=init, step=step,
                        encode_probe=encode_probe)


def _card_seed(state: torch.Tensor, card: int) -> int:
    """The seed of card ``card``'s stream in a step whose carried
    generator state is ``state``: a hash of the two, so every card and
    every step draws a stream of its own (JAX's ``fold_in(key, c)``)."""
    digest = hashlib.blake2b(state.cpu().numpy().tobytes()
                             + int(card).to_bytes(4, "little"),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little") & ((1 << 63) - 1)


def _message_tables(perms: np.ndarray, cards: int, nonempty):
    """For each card c of a fold onto ``cards``: the card offsets ``d``
    whose blocks its rows' partners sit in (card ``(c + d) mod C``; 0, its
    own, first), over the matchings with an edge, and ``int64[M, L]``
    selections: row l's partner message in matching j is row
    ``select[j, l]`` of those blocks stacked in that order."""
    m, n = perms.shape
    rows = n // cards
    offsets, selects = [], []
    for c in range(cards):
        partner = perms[:, c * rows:(c + 1) * rows]  # [M, L]
        offset = (partner // rows - c) % cards
        used = sorted({0} | set(offset[np.asarray(nonempty)].ravel()
                                .tolist()))
        offsets.append(used)
        selects.append(np.searchsorted(used, offset) * rows
                       + partner % rows)
    return offsets, selects


def _folded_choco(name, perms, partnered_np, nonempty, mesh, compress,
                  generator, probe_one, *, stochastic, aligned_full, ratio,
                  alpha, consensus_lr, wire) -> Communicator:
    """The ``shard_map`` backend on ``mesh`` (module docstring).  Card c
    holds workers ``c·L..(c+1)·L``; its partner tables are the columns of
    the batched form's, and it stacks the ``(vals, idx)`` blocks of the
    cards its rows' partners sit on (``_message_tables``), from which one
    row gather per matching picks each row's partner message.  On a mesh
    that spans processes a process compresses only its own cards' blocks
    and receives the others' ``(vals, idx)`` blocks it reads (values at
    the wire dtype, indices as int32) in one batched exchange; the new
    generator state comes from the first card's process."""
    devices = mesh.devices
    cards = mesh.size
    if perms.shape[1] % cards:
        raise ValueError(f"N={perms.shape[1]} not divisible by "
                         f"{cards} cards")
    rows_per_card = perms.shape[1] // cards
    local = mesh.local_cards
    offsets, selects = _message_tables(perms, cards, nonempty)
    selects = {c: torch.as_tensor(selects[c], dtype=torch.long,
                                  device=devices[c]) for c in local}
    cols = [slice(c * rows_per_card, (c + 1) * rows_per_card)
            for c in range(cards)]
    partnered = {c: torch.as_tensor(
        np.ascontiguousarray(partnered_np[:, cols[c]]), device=devices[c])
        for c in local}
    partners = {c: torch.as_tensor(np.ascontiguousarray(perms[:, cols[c]]),
                                   dtype=torch.long, device=devices[c])
                for c in local}
    # each card reads the (vals, idx) blocks of the cards at its offsets
    reads = [(c, d) for c in range(cards) for d in offsets[c]]

    def check(flat):
        check_blocks(flat, mesh, rows_per_card, "choco's shard_map backend")

    def init(flat: WorkerBlocks):
        check(flat)
        carry = {"x_hat": flat.zeros_like(), "s": flat.zeros_like()}
        if stochastic:
            carry["key"] = generator(flat.device).get_state()
        return carry

    def encode_probe(flat: WorkerBlocks, x_hat: WorkerBlocks) -> WorkerBlocks:
        """Each card's compress path alone, as the batched probe."""
        return WorkerBlocks((probe_one(b, h) for b, h in zip(flat, x_hat)),
                            flat.mesh)

    def card_generators(key):
        """Card 0 steps the carried generator; card c > 0 a generator
        seeded from its state and c (this process's cards only)."""
        return [generator(devices[0], key) if c == 0 else
                torch.Generator(device=devices[c]).manual_seed(
                    _card_seed(key, c)) for c in local]

    def remote_messages(msgs: dict) -> dict:
        """``{card: (vals, idx)}`` of the other processes' cards read
        here, received at the wire dtype (values) and as int32 (indices),
        in the dtypes of this process's own messages."""
        v0, i0 = next(iter(msgs.values()))
        sent = {}

        def payload(c):
            if c not in sent:
                vals, idx = msgs[c]
                sent[c] = (vals if wire is None else vals.to(wire),
                           idx.to(torch.int32))
            return sent[c]

        shape = tuple(v0.shape)
        got = exchange_reads(mesh, reads, payload, lambda c: (
            (shape, wire or v0.dtype, mesh.home),
            (shape, torch.int32, mesh.home)))
        return {s: (v, i.to(i0.dtype)) for s, (v, i) in got.items()}

    def step(flat: WorkerBlocks, carry, flags_t: torch.Tensor, alive=None):
        check(flat)
        gens = (card_generators(carry["key"]) if stochastic
                else [None] * len(local))
        # every card's message first: the exchange reads them all
        msgs = {c: compress(b - xh, ratio, gen)
                for c, b, xh, gen in zip(local, flat, carry["x_hat"], gens)}
        remote = remote_messages(msgs) if mesh.multi_process else {}
        wire_vals = {}  # card -> its values at the wire dtype, once
        flags_on, alive_on = {}, {}
        out_flat, out_xh, out_s = [], [], []
        for c, x, x_hat, s_acc in zip(local, flat, carry["x_hat"],
                                      carry["s"]):
            dev = x.device
            if dev not in flags_on:
                flags_on[dev] = flags_t.to(dev)
                if alive is not None:
                    alive_on[dev] = torch.as_tensor(
                        alive, dtype=torch.float32).to(dev)
            vals = msgs[c][0]

            def block_at(d: int):
                """Card ``(c + d) mod C``'s ``(vals, idx)`` on card c: a
                move of the ``[L, k]`` blocks between two devices (or two
                processes), none between virtual cards of one device."""
                src = (c + d) % cards
                if src not in msgs:
                    v, i = remote[src]
                    return v.to(dev).to(vals.dtype), i.to(dev)
                v, i = msgs[src]
                if v.device != dev:
                    if src not in wire_vals:
                        wire_vals[src] = v if wire is None else v.to(wire)
                    v = wire_vals[src].to(dev, non_blocking=True).to(
                        vals.dtype)
                    i = i.to(dev, non_blocking=True)
                return v, i

            received = [block_at(d) for d in offsets[c]]
            if len(received) == 1:
                table_v, table_i = received[0]
            else:
                table_v = torch.cat([v for v, _ in received])
                table_i = torch.cat([i for _, i in received])
            table_i = table_i.long()
            idx = table_i[:rows_per_card]

            def gather_msg(j, sel=selects[c], table_v=table_v,
                           table_i=table_i):
                return (table_v.index_select(0, sel[j]),
                        table_i.index_select(0, sel[j]))

            partnered_eff = partnered[c]
            if alive is not None:
                gate = alive_on[dev]
                partnered_eff = (partnered[c] * gate[cols[c]][None, :]
                                 * gate[partners[c]])
            new_x, x_hat, s = _choco_core(
                vals, idx, x_hat, s_acc, x,
                flags_on[dev], gather_msg=gather_msg,
                partnered_rows=partnered_eff, matching_nonempty=nonempty,
                alpha=alpha, consensus_lr=consensus_lr,
                aligned_full=aligned_full)
            out_flat.append(new_x)
            out_xh.append(x_hat)
            out_s.append(s)
        out = {"x_hat": WorkerBlocks(out_xh, flat.mesh),
               "s": WorkerBlocks(out_s, flat.mesh)}
        if stochastic:
            key = gens[0].get_state() if 0 in local else None
            out["key"] = (broadcast_object(key, mesh.owner(0))
                          if mesh.multi_process else key)
        return WorkerBlocks(out_flat, flat.mesh), out

    return Communicator(name=name + ",shard_map]", init=init, step=step,
                        encode_probe=encode_probe)


def folded_message_bytes(schedule: Schedule, num_cards: int, dim: int,
                         ratio: float = 0.9, wire_dtype=None) -> int:
    """The bytes of compressed messages the ``shard_map`` backend moves
    between cards in one step at width ``dim``: for each card, one
    ``[L, k]`` value block (at the wire dtype) and one int32 index block
    from every other card that a partner of its rows sits on, in any
    matching with an edge.  Between virtual cards of one device the same
    blocks are read in place."""
    perms = np.asarray(schedule.perms)
    nonempty = (perms != np.arange(perms.shape[1])[None, :]).any(axis=1)
    offsets, _ = _message_tables(perms, num_cards, nonempty)
    wire = resolve_wire_dtype(wire_dtype)
    value_bytes = 4 if wire is None else torch.finfo(wire).bits // 8
    blocks = sum(len(used) - 1 for used in offsets)
    return (blocks * (perms.shape[1] // num_cards)
            * top_k_ratio_size(dim, ratio) * (value_bytes + 4))
