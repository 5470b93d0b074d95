"""Permutation-form gossip: T matching-exchange steps on an ``[N, D]`` state.

Port of the perm half of ``matcha_tpu/parallel/pallas_gossip.py``:
``involution_tables`` (:244) and ``perm_gossip_run`` (:389).  The two Pallas
kernels behind ``perm_gossip_run`` (``_make_perm_kernel_dbuf`` :340 and
``_make_perm_kernel`` :281, both running ``_perm_window_body`` :308) become
one hand-written CUDA kernel, ``csrc/perm_gossip.cu``, instantiated twice:

* ``perm_gossip_dbuf`` (``dbuf=True``, the default) prefetches the next
  weight window with ``cp.async`` into a 2-slot shared buffer;
* ``perm_gossip_stream`` (``dbuf=False``) loads each window synchronously.

Both compute the same chain bitwise.  Per step, with ``w`` the α-scaled flag
row: quantize the state to the wire dtype once, then for every matching
accumulate ``(w_j·gate_j)·(x̃[π_j] − x̃)`` in f32 in ``j`` order and cast the
sum ``x + acc`` back to the state dtype.

``perm_gossip_run`` takes the plain PyTorch version, ``perm_gossip_plain``
(the same loop in the same operation order), for a tensor on the CPU only;
a CUDA tensor launches the kernel or raises.  ``LAUNCHES`` counts kernel
launches per instantiation, so a run can show that its gossip went through
the kernel.
"""

from __future__ import annotations

import ctypes
import operator

import numpy as np
import torch

from .gossip import resolve_wire_dtype

__all__ = [
    "LAUNCHES",
    "involution_tables",
    "perm_gossip_plain",
    "perm_gossip_run",
    "reset_launch_counts",
]

#: kernel launches per instantiation, counted by the wrapper at launch
LAUNCHES = {"perm_gossip_dbuf": 0, "perm_gossip_stream": 0}

# Launch shape, chosen by timing tiles and row groups on an H100: columns
# per CTA (widest first), rows per thread (a CTA holds about N / 16 row
# groups, at most 1024 threads), and the CTAs a tile should leave room for
# on one SM.
_TILES = (128, 64, 32)
_ROWS_PER_THREAD = 16
_BLOCKS_PER_SM = 4


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def involution_tables(perms) -> tuple[np.ndarray, np.ndarray]:
    """The table seam of the perm backend: validate and normalize matchings.

    ``perms``: ``int[M, N]`` — one total involution per matching (partner
    index, or self for unmatched slots), exactly ``Schedule.perms``.
    Returns ``(perms int32[M, N], partnered f32[M, N])`` with
    ``partnered[j, i] = 1`` iff slot ``i`` has a partner in matching ``j``.
    Raises ``ValueError`` naming the first offender unless every row is a
    total involution (``π[π[i]] == i``, entries in range): a gather against
    a non-involution would silently double- or zero-weight rows.
    """
    p = np.asarray(perms)
    if p.ndim != 2:
        raise ValueError(f"perms must be [M, N], got shape {p.shape}")
    m, n = p.shape
    if not np.issubdtype(p.dtype, np.integer):
        raise ValueError(f"perms must be integer partner indices, "
                         f"got dtype {p.dtype}")
    if m and ((p < 0).any() or (p >= n).any()):
        j = int(np.argwhere((p < 0) | (p >= n))[0][0])
        raise ValueError(f"matching {j}: partner index out of range [0, {n})")
    rows = np.arange(n)
    for j in range(m):
        if not np.array_equal(p[j][p[j]], rows):
            bad = int(np.argwhere(p[j][p[j]] != rows)[0][0])
            raise ValueError(
                f"matching {j} is not an involution: "
                f"π(π({bad})) = {int(p[j][p[j]][bad])} != {bad} — a matching "
                f"must pair slots symmetrically (fixed points map to self)")
    return p.astype(np.int32), (p != rows[None, :]).astype(np.float32)


def _prepare(x, weights, perms, partnered, alive, block_d, w_window,
             wire_dtype):
    """Validate and normalize the arguments shared by the kernel and its
    plain version.  Returns None for an empty chain (identity), else
    ``(weights f32[T', M] front-padded, perms int32[M, N], gate f32[M, N],
    w_window, block_d, wire)`` on ``x``'s device."""
    if x.ndim != 2:
        raise ValueError(f"x must be [N, D], got {tuple(x.shape)}")
    n, d = x.shape
    dev = x.device
    weights = torch.as_tensor(weights, device=dev)
    if weights.ndim != 2:
        raise ValueError(f"weights must be [T, M], got {tuple(weights.shape)}")
    t_steps, m = weights.shape
    perms = torch.as_tensor(perms, device=dev)
    partnered = torch.as_tensor(partnered, device=dev)
    if tuple(perms.shape) != (m, n) or tuple(partnered.shape) != (m, n):
        raise ValueError(
            f"tables {tuple(perms.shape)}/{tuple(partnered.shape)} "
            f"incompatible with weights {tuple(weights.shape)} and state "
            f"{tuple(x.shape)}")
    wire = resolve_wire_dtype(wire_dtype)
    block_d = min(operator.index(block_d), d)
    if t_steps == 0 or m == 0:
        return None
    w_window = max(1, min(operator.index(w_window), t_steps))
    weights = weights.to(torch.float32)
    pad = (-t_steps) % w_window
    if pad:
        # front-pad with zero weights: an all-zero row adds 0·delta to the
        # f32 accumulator, an identity step for finite states
        weights = torch.cat(
            [torch.zeros((pad, m), dtype=torch.float32, device=dev), weights])
    gate = partnered.to(torch.float32)
    if alive is not None:
        av = torch.as_tensor(alive, device=dev).to(torch.float32)
        # both-endpoints edge gate folded into the static partnered mask;
        # 0/1 alive keeps the product exact
        gate = gate * av[None, :] * av[perms.long()]
    return (weights.contiguous(), perms.to(torch.int32).contiguous(),
            gate.contiguous(), w_window, block_d, wire)


def _plain(x, weights, perms, gate, wire):
    """The window body of the TPU kernel, step by step, in its operation
    order: one rounding per product and per sum (separate kernels)."""
    index = perms.long()
    out = x
    for k in range(weights.shape[0]):
        curf = out.to(torch.float32)
        xw = curf if wire is None else out.to(wire).to(torch.float32)
        acc = torch.zeros_like(curf)
        for j in range(weights.shape[1]):
            delta = xw.index_select(0, index[j]) - xw
            acc = acc + (weights[k, j] * gate[j])[:, None] * delta
        out = (curf + acc).to(x.dtype)
    return out


def perm_gossip_plain(x: torch.Tensor, weights, perms, partnered, *,
                      alive=None, block_d: int = 2048, w_window: int = 1,
                      wire_dtype=None) -> torch.Tensor:
    """The plain PyTorch version of the perm kernel, on any device: the
    CPU path of :func:`perm_gossip_run` and the kernel's yardstick on the
    card.  ``block_d`` and ``w_window`` change no arithmetic."""
    prep = _prepare(x, weights, perms, partnered, alive, block_d, w_window,
                    wire_dtype)
    if prep is None:
        return x
    w, p, gate, _, _, wire = prep
    return _plain(x, w, p, gate, wire)


def _tile_width(lib, n: int, m: int, w_window: int, block_d: int) -> int:
    """Columns per CTA: the widest tile ≤ ``block_d`` (at least 32) whose
    shared memory leaves room for ``_BLOCKS_PER_SM`` CTAs on one SM; else
    the narrowest tile, which keeps the most CTAs in flight, if it fits one
    block at all."""
    limit = lib.perm_gossip_smem_limit()
    cap = max(32, block_d)
    for tile in _TILES:
        if tile <= cap and lib.perm_gossip_smem_bytes(
                n, tile, w_window, m) <= limit // _BLOCKS_PER_SM:
            return tile
    need = lib.perm_gossip_smem_bytes(n, _TILES[-1], w_window, m)
    if need <= limit:
        return _TILES[-1]
    raise ValueError(
        f"perm_gossip: {n} workers need {need} B of shared memory at the "
        f"narrowest tile ({_TILES[-1]} columns), more than the {limit} B a "
        f"block may use; a large-N tiling is still to be ported (ROADMAP.md)")


def _library():
    from .. import _kernels

    lib = _kernels.load("perm_gossip")
    if not getattr(lib, "_matcha_typed", False):
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.perm_gossip_launch.argtypes = [vp, vp, vp, vp, vp, i, ll, i, i, i,
                                           i, i, i, i, i, vp]
        lib.perm_gossip_launch.restype = i
        lib.perm_gossip_smem_bytes.argtypes = [i, i, i, i]
        lib.perm_gossip_smem_bytes.restype = ll
        lib.perm_gossip_smem_limit.argtypes = []
        lib.perm_gossip_smem_limit.restype = ll
        lib.perm_gossip_error_string.argtypes = [i]
        lib.perm_gossip_error_string.restype = ctypes.c_char_p
        lib._matcha_typed = True
    return lib


_STATE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _launch(x, weights, perms, gate, w_window, block_d, wire, dbuf):
    if x.dtype not in _STATE_CODES:
        raise ValueError(f"perm_gossip kernel takes a float32 or bfloat16 "
                         f"state, got {x.dtype}")
    if wire not in (None, torch.bfloat16):
        raise ValueError(f"perm_gossip kernel takes an f32 or bf16 wire, "
                         f"got {wire}")
    lib = _library()
    n, d = x.shape
    t_padded, m = weights.shape
    tile = _tile_width(lib, n, m, w_window, block_d)
    groups = min(-(-n // _ROWS_PER_THREAD), 1024 // tile)
    x = x.contiguous()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.perm_gossip_launch(
            x.data_ptr(), out.data_ptr(), weights.data_ptr(), perms.data_ptr(),
            gate.data_ptr(), n, d, t_padded, m, w_window, tile, tile * groups,
            _STATE_CODES[x.dtype], 0 if wire is None else 1, int(dbuf), stream)
    if rc != 0:
        raise RuntimeError(f"perm_gossip kernel launch failed: "
                           f"{lib.perm_gossip_error_string(rc).decode()}")
    LAUNCHES["perm_gossip_dbuf" if dbuf else "perm_gossip_stream"] += 1
    return out


def perm_gossip_run(x: torch.Tensor, weights, perms, partnered, *,
                    alive=None, block_d: int = 2048, w_window: int = 1,
                    wire_dtype=None, dbuf: bool = True) -> torch.Tensor:
    """Apply ``T`` gossip steps in permutation form.

    ``x``: ``[N, D]`` worker state (float32, or bfloat16 state).
    ``weights``: ``f32[T, M]`` α-scaled activation flags.
    ``perms``/``partnered``: the ``[M, N]`` tables from
    :func:`involution_tables`.  ``alive``: optional ``f32[N]`` survivor
    mask; each matching's per-slot gate becomes ``partnered_j · alive ·
    alive[π_j]``.  ``wire_dtype``: ``"f32"``/``"bf16"`` (quantize the
    exchanged image once per step; accumulation is always f32).
    ``w_window``: steps per weight window (front-padded with zero rows when
    ``T % w_window != 0``); ``block_d``: the widest column tile a CTA may
    take (at least 32, at most 128).  Neither changes the arithmetic.
    ``dbuf``: prefetch the next weight window (``perm_gossip_dbuf``) or
    load each synchronously (``perm_gossip_stream``).

    An empty chain (``T == 0`` or ``M == 0``) returns ``x`` itself.  A CPU
    tensor runs :func:`perm_gossip_plain`; a CUDA tensor launches the
    kernel on the current stream and raises if the launch fails.
    """
    prep = _prepare(x, weights, perms, partnered, alive, block_d, w_window,
                    wire_dtype)
    if prep is None:
        return x
    w, p, gate, w_window, block_d, wire = prep
    if x.device.type == "cpu":
        return _plain(x, w, p, gate, wire)
    if x.device.type == "cuda":
        return _launch(x, w, p, gate, w_window, block_d, wire, dbuf)
    raise ValueError(f"perm_gossip_run takes a CPU or CUDA tensor, got "
                     f"device {x.device}")
