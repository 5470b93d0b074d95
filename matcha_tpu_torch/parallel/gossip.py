"""Gossip averaging on a worker-stacked ``[N, ...]`` tensor.

Port of ``matcha_tpu/parallel/gossip.py``: the wire-dtype seam
(``resolve_wire_dtype``, :78), the precision seam (``mxu_precision``,
:101), the per-matching byte account (``matching_wire_bytes``, :113), the
gather oracle (``gossip_mix``, :138), its skipping twin
(``gossip_mix_skip``, :182) and the dense backend (``masked_laplacians``
:239, ``gossip_mix_dense`` :260, ``dense_gossip_fn`` :305), and the
folded backend over a worker mesh (``gossip_mix_folded`` :413,
``shard_map_gossip_fn`` :508).  One gossip
step with matchings ``π_j`` (involutions over workers, fixed points =
unmatched) and per-step weights ``w_j = α·flag_j``:

    x_i ← x_i + Σ_j w_j · (x_{π_j(i)} − x_i)

which the dense backend computes as one matrix product ``x ← W_t @ x``,
``W_t = I − Σ_j w_j·L_j`` with ``L_j`` the matchings' Laplacians.

An optional ``alive: f32[N]`` survivor mask realizes an edge only when both
endpoints live (its delta is scaled by ``alive_i · alive_{π_j(i)}``, or its
Laplacian entries are), so every realized mixing matrix stays doubly
stochastic over the survivors.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .folded import FoldedPlan, build_folded_plan
from .mesh import WORKER_AXIS, WorkerBlocks, check_blocks
from .multihost import exchange_reads

__all__ = ["dense_gossip_fn", "gossip_mix", "gossip_mix_dense",
           "gossip_mix_folded", "gossip_mix_skip", "masked_laplacians",
           "matching_wire_bytes", "mxu_precision", "resolve_wire_dtype",
           "shard_map_gossip_fn"]


def resolve_wire_dtype(wire_dtype):
    """Normalize the wire-dtype knob to ``None`` (exact f32 program) or the
    torch dtype the exchange casts to at the gossip boundary.

    ``"f32"``/``None``/``torch.float32`` mean no cast anywhere; ``"bf16"``
    quantizes every exchanged value to bfloat16 while the state and the
    delta accumulation stay f32.
    """
    if wire_dtype is None:
        return None
    if isinstance(wire_dtype, str):
        if wire_dtype in ("f32", "float32"):
            return None
        if wire_dtype in ("bf16", "bfloat16"):
            return torch.bfloat16
        raise ValueError(f"unknown wire_dtype '{wire_dtype}' (f32|bf16)")
    if not isinstance(wire_dtype, torch.dtype):
        raise ValueError(f"unknown wire_dtype {wire_dtype!r} (f32|bf16 or a "
                         f"torch dtype)")
    return None if wire_dtype == torch.float32 else wire_dtype


@contextlib.contextmanager
def mxu_precision():
    """The context every product of the dense path runs under: true f32.

    The JAX seam maps a compute dtype to a TPU precision so that f32 means
    f32.  The port's dense products always multiply f32 operands (values
    already rounded to the compute dtype) and accumulate in f32, so one
    rule serves every compute dtype and the context takes none: on the
    card it turns TF32 off, whatever the caller set, and restores the
    caller's setting after.  TF32 would round f32 operands to 10 mantissa
    bits; bf16-rounded operands it would leave exact.
    """
    matmul = torch.backends.cuda.matmul
    prev = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32 = prev


def matching_wire_bytes(decomposed, dim: int, wire_dtype=None) -> np.ndarray:
    """``f64[M]`` — bytes that cross the wire when matching ``j`` fires:
    each of its ``E_j`` edges moves both endpoint rows (``2·E_j·dim``
    values) at the wire dtype's width (f32 unless a narrower wire)."""
    dt = resolve_wire_dtype(wire_dtype)
    itemsize = 4 if dt is None else dt.itemsize
    return np.asarray([2.0 * len(m) * dim * itemsize for m in decomposed],
                      np.float64)


def _rows(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Broadcast a per-row ``[R]`` mask over the trailing dims of ``[R, ...]``."""
    return mask.reshape(mask.shape + (1,) * (x.ndim - 1))


def gossip_mix(x: torch.Tensor, perms, weights, alive=None,
               wire_dtype=None) -> torch.Tensor:
    """``x_i + Σ_j weights[j]·(x[π_j(i)] − x_i)`` over the leading axis.

    ``perms``: ``int[M, N]`` partner tables (numpy); ``weights``: ``[M]``
    (a tensor on ``x``'s device, typically ``alpha * flags[t]``).  With a
    narrow ``wire_dtype`` the exchanged values are quantized once, before
    the gathers, and both endpoints form the delta from the quantized
    values, so pairwise cancellation (exact worker-mean preservation)
    survives the narrow wire.  Same operation order as the JAX oracle.
    """
    perms = np.asarray(perms)
    if perms.ndim != 2 or perms.shape[1] != x.shape[0]:
        raise ValueError(f"perms {perms.shape} incompatible with x "
                         f"{tuple(x.shape)}")
    wire = resolve_wire_dtype(wire_dtype)
    xw = x if wire is None else x.to(wire).to(x.dtype)
    index = torch.as_tensor(perms, dtype=torch.long, device=x.device)
    rows = np.arange(perms.shape[1])
    acc = torch.zeros_like(x)
    for j in range(perms.shape[0]):
        if np.array_equal(perms[j], rows):
            continue  # empty matching: zero delta regardless of flag
        delta = xw.index_select(0, index[j]) - xw
        if alive is not None:
            delta = _rows(alive * alive.index_select(0, index[j]), delta) * delta
        acc = acc + weights[j] * delta
    return x + acc


def gossip_mix_skip(x: torch.Tensor, perms, weights, alive=None,
                    wire_dtype=None) -> torch.Tensor:
    """``gossip_mix`` with a host branch per matching: a matching whose
    weight is 0 (inactive this step) is skipped and launches nothing, so
    the MATCHA budget buys time back, not only masked-out arithmetic.

    ``weights``: the ``[M]`` row, read on the host (pass a CPU tensor or
    an array; a tensor on the card is copied to the host, which waits for
    the card).  The active matchings are summed as ``gossip_mix`` sums
    them, into one accumulator added to ``x`` at the end, so on finite
    inputs the result has ``gossip_mix``'s bits (an inactive matching adds
    an exact zero there).  The JAX package's ``lax.cond`` form adds each
    matching to ``x`` in turn instead: the same values within f32
    rounding.  An all-zero row returns ``x`` itself.  ``alive`` masks
    edges inside the taken branches; the skip decision is the weight's
    (``!= 0``, so a negative weight is applied, as masking applies it).
    """
    perms = np.asarray(perms)
    if perms.ndim != 2 or perms.shape[1] != x.shape[0]:
        raise ValueError(f"perms {perms.shape} incompatible with x "
                         f"{tuple(x.shape)}")
    w = torch.as_tensor(weights, dtype=torch.float32, device="cpu").tolist()
    rows = np.arange(perms.shape[1])
    active = [j for j in range(perms.shape[0])
              if w[j] != 0 and not np.array_equal(perms[j], rows)]
    if not active:
        return x
    wire = resolve_wire_dtype(wire_dtype)
    xw = x if wire is None else x.to(wire).to(x.dtype)
    index = torch.as_tensor(perms[active], dtype=torch.long, device=x.device)
    acc = torch.zeros_like(x)
    for k, j in enumerate(active):
        delta = xw.index_select(0, index[k]) - xw
        if alive is not None:
            delta = _rows(alive * alive.index_select(0, index[k]), delta) * delta
        acc = acc + w[j] * delta
    return x + acc


# ---------------------------------------------------------------------------
# Dense backend
# ---------------------------------------------------------------------------

def masked_laplacians(laplacians: torch.Tensor,
                      alive: torch.Tensor) -> torch.Tensor:
    """Survivor-masked Laplacian stack: edge (u, v) kept iff both alive.

    ``L_j = D_j − A_j``; masking scales the adjacency by
    ``alive_u·alive_v`` and recomputes the degree, so each masked matrix is
    still a Laplacian (symmetric, zero row sums) and the mixing built from
    it stays doubly stochastic.  ``alive`` may hold survival probabilities
    as well as 0/1 (the expected masked Laplacian).
    """
    lap = torch.as_tensor(laplacians)
    alive = torch.as_tensor(alive, dtype=lap.dtype, device=lap.device)
    adj = torch.diag_embed(torch.diagonal(lap, dim1=-2, dim2=-1)) - lap
    adj = adj * (alive[:, None] * alive[None, :])[None]
    return torch.diag_embed(adj.sum(dim=-1)) - adj


def _mixing_matrices(weights: torch.Tensor,
                     laplacians: torch.Tensor) -> torch.Tensor:
    """``f32[T, N, N]``: ``W_t = I − Σ_j weights[t, j]·L_j``.  The sum runs
    elementwise in ``j`` order, so a step's matrix has the same bits whether
    it is built alone (the dense step) or in a stack (the fused chain)."""
    n = laplacians.shape[-1]
    acc = torch.zeros((weights.shape[0], n, n), dtype=torch.float32,
                      device=laplacians.device)
    for j in range(laplacians.shape[0]):
        acc = acc + weights[:, j, None, None] * laplacians[j]
    return torch.eye(n, dtype=torch.float32, device=laplacians.device) - acc


def _dense_apply(w: torch.Tensor, x: torch.Tensor,
                 compute_dtype) -> torch.Tensor:
    """``cast_x(W @ cast_c(x))``: both operands rounded to
    ``compute_dtype``, then multiplied as f32 and accumulated in f32, the
    sum cast once to ``x.dtype``.  Multiplying the rounded operands in f32
    (not as two bf16 tensors, whose product PyTorch would round to bf16
    before the cast) is what JAX's ``preferred_element_type=float32``
    does."""
    with mxu_precision():
        out = torch.matmul(w.to(compute_dtype).to(torch.float32),
                           x.to(compute_dtype).to(torch.float32))
    return out.to(x.dtype)


def gossip_mix_dense(x: torch.Tensor, laplacians: torch.Tensor,
                     weights: torch.Tensor, compute_dtype=torch.float32,
                     alive=None) -> torch.Tensor:
    """One gossip step as a single matrix product: ``x ← W_t @ x`` with
    ``W_t = I − Σ_j weights[j]·L_j`` built from the flag weights.

    ``laplacians``: the ``[M, N, N]`` stack (used as f32 on ``x``'s
    device).  ``compute_dtype``: the dtype both operands are rounded to
    (bf16 is the bf16 wire); the product accumulates in f32 and is cast
    back to ``x.dtype`` (a float64 state goes through f32, as in the JAX
    package).  ``alive`` rebuilds the Laplacians through
    :func:`masked_laplacians` first.
    """
    laplacians = torch.as_tensor(laplacians, dtype=torch.float32,
                                 device=x.device)
    if alive is not None:
        laplacians = masked_laplacians(laplacians, alive)
    weights = torch.as_tensor(weights, dtype=torch.float32, device=x.device)
    w = _mixing_matrices(weights[None], laplacians)[0]
    return _dense_apply(w, x, compute_dtype)


def dense_gossip_fn(laplacians, compute_dtype=torch.float32, device=None):
    """Build ``(x, weights[, alive]) -> x`` closing over the Laplacian stack
    (an array or a tensor, placed on ``device`` once, as f32)."""
    lap = torch.as_tensor(laplacians, dtype=torch.float32, device=device)

    def fn(x, weights, alive=None):
        return gossip_mix_dense(x, lap, weights, compute_dtype=compute_dtype,
                                alive=alive)

    return fn


# ---------------------------------------------------------------------------
# Folded backend: workers card-major across a mesh
# ---------------------------------------------------------------------------

def _identity_matchings(plan: FoldedPlan) -> list:
    """``bool[M]``: matching j maps every worker to itself (every slot in
    the offset-0 part, picking its own row).  Such a matching adds an exact
    zero, and the gather oracle skips it; so does the folded executor."""
    rows = np.arange(plan.rows_per_chip)
    return [all(p.offset == 0 and np.array_equal(
        np.where(p.mask > 0, p.src_local, rows), np.broadcast_to(
            rows, p.src_local.shape)) for p in parts)
        for parts in plan.matchings]


def _card_tables(plan: FoldedPlan, devices) -> tuple:
    """``(identity, tables, needs)``: which matchings are the identity
    (``_identity_matchings``); for card ``c`` on ``devices[c]`` (None for
    a card another process holds, which gets no table), per matching,
    the pieces ``(offset, rows, src)`` of its nonempty offset parts
    (``rows`` None when one piece serves all L rows) and the partners'
    global worker indices ``int64[L]`` (the survivor mask's second gate);
    and per matching the ``(card, offset)`` pairs, offset > 0, whose card
    reads the block ``offset`` cards on (what crosses processes)."""
    C, L = plan.num_chips, plan.rows_per_chip
    tables = []
    for c, dev in enumerate(devices):
        if dev is None:
            tables.append(None)
            continue
        card = []
        for parts in plan.matchings:
            pieces = []
            partner = np.zeros(L, np.int64)
            for p in parts:
                rows = np.flatnonzero(p.mask[c] > 0)
                if rows.size == 0:
                    continue
                src = p.src_local[c][rows].astype(np.int64)
                partner[rows] = ((c + p.offset) % C) * L + src
                pieces.append((p.offset,
                               None if rows.size == L
                               else torch.as_tensor(rows, device=dev),
                               torch.as_tensor(src, device=dev)))
            card.append((pieces, torch.as_tensor(partner, device=dev)))
        tables.append(card)
    needs = [[(c, p.offset) for p in parts if p.offset
              for c in np.flatnonzero((p.mask > 0).any(axis=1)).tolist()]
             for parts in plan.matchings]
    return _identity_matchings(plan), tables, needs


def gossip_mix_folded(blocks, plan: FoldedPlan, weights, skip: bool = False,
                      alive=None, wire_dtype=None,
                      tables=None) -> WorkerBlocks:
    """One gossip step on a folded state: the port of the JAX per-chip
    body (``gossip.py:413``), run for every card in turn from one host
    thread.

    ``blocks``: the C card-major ``[L, ...]`` blocks (a ``WorkerBlocks``
    or a sequence), block c on card c.  ``weights``: the ``[M]`` row,
    read on the host (the replicated flag predicate; pass a CPU tensor or
    an array).  For card c and matching j, the edges of each offset part d
    pick their partner rows out of card ``(c + d) mod C``'s wire image:
    a row gather on the card for d = 0, else that card's block moved to
    card c once a step (a copy between real cards, none at all between
    virtual cards on one device).  The parts partition card c's rows, so the
    assembled partner block is exactly ``x̃[π_j]`` on those rows.

    ``skip``: an inactive matching (weight 0) moves and computes nothing,
    and a step with none active returns ``blocks`` themselves; without
    it every matching's delta is formed and masked by its weight, as the
    JAX masked body does.  ``alive``: a replicated ``f32[N]`` survivor
    mask (any device; copied to each card once a call); each edge is gated
    by ``alive[own]·alive[partner]``.  ``wire_dtype``: each block is cast
    once before the exchange, and both sides of every delta read the
    quantized values in f32.  ``tables``: ``_card_tables(plan, devices)``
    for the blocks' devices, made here when not given.

    The result is formed in new tensors and no input is written, so a
    caller may write card c's result back into its state while card c+1's
    old block is still to be read.  Each row's arithmetic is the gather
    oracle's (``gossip_mix`` without ``skip``, ``gossip_mix_skip`` with
    it): the same ops in the same order, so the result has their bits
    whatever C is.  Returns a ``WorkerBlocks``.

    On a mesh that spans processes (``blocks.mesh`` set: this process's
    cards only) each card c reads card ``(c + d) mod C``'s wire image
    for offset d as before: in place or by a copy when both cards are in
    this process, else received from the process that holds it.  Every
    such move of the step (a function of the plan and the replicated
    weight row alone) is posted in one batch of send/recv before any
    card's mix is formed (``multihost.exchange_reads``); the row
    arithmetic is unchanged, so each process's rows are bitwise the
    one-process fold's.
    """
    mesh = blocks.mesh if isinstance(blocks, WorkerBlocks) else None
    blocks = list(blocks)
    C, L = plan.num_chips, plan.rows_per_chip
    cards = list(range(C)) if mesh is None else list(mesh.local_cards)
    if (mesh is not None and mesh.size != C) or len(blocks) != len(cards) \
            or any(b.shape[0] != L for b in blocks):
        raise ValueError(f"plan folds {C} cards of {L} rows; got blocks "
                         f"{[tuple(b.shape) for b in blocks]} of cards "
                         f"{cards}")
    w = torch.as_tensor(weights, dtype=torch.float32, device="cpu").tolist()
    if len(w) != plan.num_matchings:
        raise ValueError(f"{len(w)} weights for {plan.num_matchings} "
                         f"matchings")
    wire = resolve_wire_dtype(wire_dtype)
    if tables is None:
        devices = [None] * C
        for c, b in zip(cards, blocks):
            devices[c] = b.device
        tables = _card_tables(plan, devices)
    empty, tables, needs = tables
    local = dict(zip(cards, blocks))
    images = {c: b if wire is None else b.to(wire) for c, b in local.items()}
    xw = {c: b if wire is None else images[c].to(b.dtype)
          for c, b in local.items()}
    active = [j for j in range(plan.num_matchings)
              if not empty[j] and (w[j] != 0 or not skip)]
    remote = {}
    if mesh is not None and active:
        like = next(iter(images.values()))
        remote = exchange_reads(
            mesh, [read for j in active for read in needs[j]],
            lambda c: (images[c],),
            lambda c: ((tuple(like.shape), like.dtype, mesh.home),))
    out = []
    for c, x in local.items():
        if skip and not active:
            out.append(x)
            continue
        received = {0: xw[c]}

        def block_at(d: int) -> torch.Tensor:
            if d not in received:
                s = (c + d) % C
                if s not in local:  # another process's card: its image
                    received[d] = remote[s][0].to(x.device).to(x.dtype)
                else:
                    # torch's copy between two cards waits for both cards'
                    # current streams and makes both wait for the copy, so
                    # the block is whole when read
                    received[d] = (xw[s] if local[s].device == x.device
                                   else images[s].to(x.device,
                                                     non_blocking=True)
                                   .to(x.dtype))
            return received[d]

        if alive is not None:
            gate_all = torch.as_tensor(alive, dtype=torch.float32,
                                       device=x.device)
            gate_own = gate_all[c * L:(c + 1) * L]
        acc = torch.zeros_like(x)
        for j in active:
            pieces, partners = tables[c][j]
            if pieces[0][1] is None:
                d, _, src = pieces[0]
                partner = block_at(d).index_select(0, src)
            else:
                partner = torch.empty_like(x)
                for d, rows, src in pieces:
                    partner.index_copy_(0, rows,
                                        block_at(d).index_select(0, src))
            delta = partner - xw[c]
            if alive is not None:
                delta = _rows(gate_own * gate_all.index_select(0, partners),
                              delta) * delta
            acc = acc + w[j] * delta
        out.append(x + acc)
    return WorkerBlocks(out, mesh)


def shard_map_gossip_fn(perms, mesh, axis: str = WORKER_AXIS,
                        skip: bool = False, wire_dtype=None):
    """Build ``(x, weights[M][, alive[N]]) -> x`` over a folded state on
    ``mesh``: the JAX package's shard_map backend (``gossip.py:508``),
    with :func:`gossip_mix_folded` as its body on the plan
    ``build_folded_plan(perms, C)``.  ``x``: a ``WorkerBlocks`` whose
    block c lies on ``mesh.devices[c]`` (``shard_workers`` makes one)."""
    plan = build_folded_plan(np.asarray(perms), mesh.shape[axis])
    local = mesh.local_cards
    tables = _card_tables(plan, [d if c in local else None
                                 for c, d in enumerate(mesh.devices)])

    def fn(x, weights, alive=None):
        check_blocks(x, mesh, plan.rows_per_chip, "the folded backend")
        return gossip_mix_folded(x, plan, weights, skip=skip, alive=alive,
                                 wire_dtype=wire_dtype, tables=tables)

    return fn
