"""CHOCO-SGD communicator: gossip on compressed model differences.

Port of ``matcha_tpu/communicator/choco.py`` (``_choco_core`` :59,
``make_choco`` :106) with its batched backend, after the reference's
``ChocoCommunicator`` (``communicator.py:161-268``):

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

The ``shard_map`` backend (workers across cards, only the compressed
blocks exchanged) waits for multi-GPU support (``ROADMAP.md``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import DETERMINISTIC_COMPRESSORS, scatter_rows, select_compressor
from ..parallel import resolve_wire_dtype
from ..schedule import Schedule
from ..utils import resolve_device
from .base import Communicator

__all__ = ["make_choco"]


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
) -> Communicator:
    """Build the CHOCO communicator.

    ``ratio``: keep the top ``1 − ratio`` fraction (the reference's
    semantics).  ``consensus_lr`` is γ.  ``compressor`` names an entry of
    ``ops.COMPRESSOR_NAMES``; the stochastic ones draw from a generator
    seeded ``seed``, whose state rides the carry.  ``wire_dtype``
    (``"f32"``/``"bf16"``/None): the compressed values are quantized to
    the wire dtype once, right after ``compress``, so the exchange, the
    self message and the ``x̂`` update all read the same values.
    ``backend``: ``batched`` (``auto`` means it); ``shard_map`` raises.
    ``device``: where the partner tables live (``None``: the card)."""
    if backend == "shard_map":
        raise NotImplementedError(
            "CHOCO's shard_map backend (workers across cards) is not ported "
            "yet (ROADMAP.md, Queue 1: multi-GPU); use backend='batched'")
    if backend not in ("batched", "auto"):
        raise KeyError(f"unknown choco backend '{backend}'")
    dev = resolve_device(device)
    perms = np.asarray(schedule.perms)
    alpha = float(schedule.alpha)
    m, n = perms.shape
    wire = resolve_wire_dtype(wire_dtype)
    # partner masks: a fixed point exchanges nothing (communicator.py:210)
    partnered_np = (perms != np.arange(n)[None, :]).astype(np.float32)
    nonempty = [bool(partnered_np[j].any()) for j in range(m)]
    perms_t = torch.as_tensor(perms, dtype=torch.long, device=dev)
    partnered = torch.as_tensor(partnered_np, device=dev)
    base_compress = select_compressor(compressor)
    if wire is None:
        compress = base_compress
    else:
        def compress(q, ratio_, gen):
            vals, idx = base_compress(q, ratio_, gen)
            return vals.to(wire).to(q.dtype), idx
    stochastic = compressor not in DETERMINISTIC_COMPRESSORS
    name = f"choco[r{ratio}" + ("" if compressor == "top_k"
                                else f",{compressor}")
    if wire is not None:
        name += ",wire=bfloat16"

    def generator(flat, state=None):
        gen = torch.Generator(device=flat.device)
        if state is None:
            return gen.manual_seed(seed)
        gen.set_state(state.cpu())
        return gen

    def init(flat: torch.Tensor):
        carry = {"x_hat": torch.zeros_like(flat), "s": torch.zeros_like(flat)}
        if stochastic:
            carry["key"] = generator(flat).get_state()
        return carry

    def encode_probe(flat: torch.Tensor, x_hat: torch.Tensor) -> torch.Tensor:
        """The compress path alone (subtract, top-k, gather) and CHOCO's
        ``x̂ += scatter(q)``, for the comm-split timer's encode chain; a
        stochastic compressor draws from a fresh generator seeded 0 (the
        probe models the cost, not the sample path)."""
        gen = torch.Generator(device=flat.device).manual_seed(0)
        vals, idx = compress(flat - x_hat, ratio, gen)
        return scatter_rows(x_hat, idx, vals, 1.0)

    def step(flat: torch.Tensor, carry, flags_t: torch.Tensor, alive=None):
        gen = generator(flat, carry["key"]) if stochastic else None
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
            consensus_lr=consensus_lr, aligned_full=compressor == "top_k")
        out = {"x_hat": x_hat, "s": s}
        if stochastic:
            out["key"] = gen.get_state()
        return flat, out

    return Communicator(name=name + "]", init=init, step=step,
                        encode_probe=encode_probe)
