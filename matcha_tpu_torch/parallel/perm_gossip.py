"""Permutation-form gossip: T matching-exchange steps on an ``[N, D]`` state.

Port of the perm half of ``matcha_tpu/parallel/pallas_gossip.py``:
``involution_tables`` (:244) and ``perm_gossip_run`` (:389).  The two Pallas
kernels behind ``perm_gossip_run`` (``_make_perm_kernel_dbuf`` :340 and
``_make_perm_kernel`` :281, both running ``_perm_window_body`` :308) become
one hand-written CUDA kernel, ``csrc/perm_gossip.cu``, instantiated twice:

* ``perm_gossip_dbuf`` (``dbuf=True``, the default) prefetches the next
  weight window with ``cp.async`` into a 2-slot shared buffer;
* ``perm_gossip_stream`` (``dbuf=False``) loads each window synchronously.

Where no slab fits a CTA (N above 8192, or more matchings than the tables
beside the image allow), and for one step from 4096 workers, the same
source's band path runs instead: one persistent, cooperatively launched
grid that walks column bands ``[N, cols]`` of the state, each band's
whole chain through two buffers sized to stay in L2 (``_launch_shape``
picks the path by shape alone; it never retries after a failed launch).
Both paths compute the same chain bitwise.  Per step, with ``w`` the
α-scaled flag row: quantize the state to the wire dtype once, then for
every matching accumulate ``(w_j·gate_j)·(x̃[π_j] − x̃)`` in f32 in ``j``
order and cast the sum ``x + acc`` back to the state dtype.

``perm_gossip_run`` takes the plain PyTorch version, ``perm_gossip_plain``
(the same loop in the same operation order), for a tensor on the CPU only;
a CUDA tensor launches the kernel or raises.  ``LAUNCHES`` (shared with
the port's other kernels, ``_kernels.py``) counts kernel launches per
instantiation (``perm_gossip_dbuf`` / ``perm_gossip_stream`` by ``dbuf``)
and per path (``perm_gossip/slab``, ``perm_gossip/band``), so a run can
show that its gossip went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import operator
from typing import NamedTuple

import numpy as np
import torch

from .._kernels import (LAUNCHES, add_kernel_flops, perm_gossip_flops,
                       reset_launch_counts)
from .gossip import resolve_wire_dtype

__all__ = [
    "LAUNCHES",
    "involution_tables",
    "perm_gossip_plain",
    "perm_gossip_run",
    "reset_launch_counts",
]

# Launch shape.  A persistent grid of CTAs (the kernel's cap per SM) walks
# the column slabs [N, cols]; each thread holds up to ``rows`` rows of two
# adjacent columns in registers.  Widest slab first (a row's table entry
# is read once per step and matching, whatever the slab's width); four
# rows per thread, eight where four would need more than a CTA's threads
# (rows past N are masked, so four take N < 4 too).  The tables go to
# shared memory as int2 up to _TABLE_SMEM_BYTES, else as one uint16 per
# entry (uint16 fits at N = 4096); the CTA's shared memory leaves room for
# as many CTAs on one SM as the SM's registers allow at 64 a thread (two
# at most), else for one.  Each choice was timed against its alternative
# on an H100 (``probes/perm_bench.py ab``, PERF.md).
_COLS = (64, 32, 16, 8, 4, 2)
_ROWS = (4, 8)
_THREADS_AT_64_REGISTERS = 65536 // 64  # per SM
_TABLE_SMEM_BYTES = 32 << 10
TABLES_WIDE, TABLES_COMPACT = 1, 2


class LaunchShape(NamedTuple):
    cols: int     # columns per slab (two per thread)
    rows: int     # rows per thread at most (the kernel's R)
    threads: int  # threads per CTA
    nbuf: int     # wire-image buffers: 2 (one barrier per step) or 1
    tables: int   # TABLES_WIDE or TABLES_COMPACT


class BandShape(NamedTuple):
    """The band path's shape: ``cols`` columns a band."""
    cols: int


# The band path.  The band's two ping-pong buffers, 2 * N * cols values,
# stay within _L2_BAND_BYTES of the H100's 50 MB L2; cols is the widest
# power-of-two multiple of a lane's 16 bytes, up to _BAND_MAX_BYTES a row,
# that keeps them there.  One perm_bench bands call on an H100 (PERF.md
# § 6) timed half and twice that width at five f32 shapes: 16 MB was 2-9 %
# slower everywhere; 64 MB 1-6 % faster at four and 8.5 % slower at the
# 4096-worker hypercube at T = 1.
_L2_BAND_BYTES = 32 << 20
_BAND_MAX_BYTES = 4096
# Where both paths take a shape: the band path for one step from this many
# workers, the slab kernel otherwise, for every state dtype and wire.  One
# perm_bench ab call on an H100 (PERF.md § 6): at T = 1 the band beats the
# 4- and 2-column slabs (4096-worker hypercube, 13 matchings: 11.49
# against 15.93 ms with an f32 state, 10.32 against 12.63 with a bf16
# state, 12.01 against 21.85 with an f32 state on a bf16 wire; 8192-worker
# torus, 5 matchings: 20.27 against 50.02, 10.18 against 36.13, 21.15
# against 115.3); from T = 2 the slab kernel, whose state stays in
# registers, wins (19.94 against 23.03 at 4096 and T = 2; 76.97 against
# 128.6 at 8192 and T = 8, f32), whatever the matchings.
_BAND_MIN_WORKERS = 4096


def band_shape(n: int, state_bytes: int) -> BandShape:
    """The band path's shape for ``n`` rows of ``state_bytes``-byte
    values: the widest band within the L2 budget (one lane's 16 bytes a
    row at least)."""
    lane = 16 // state_bytes
    cols = _BAND_MAX_BYTES // state_bytes
    while cols > lane and 2 * n * cols * state_bytes > _L2_BAND_BYTES:
        cols //= 2
    return BandShape(cols)


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


def _slab_shape(lib, n: int, m: int, w_window: int, block_d: int,
                wire_bf16: bool):
    """The widest slab ``LaunchShape`` that takes ``n`` rows and ``m``
    matchings (``block_d`` caps its width), or None."""
    limit = lib.perm_gossip_smem_limit()
    max_threads = lib.perm_gossip_max_threads()
    tables = TABLES_WIDE if 8 * m * n <= _TABLE_SMEM_BYTES else TABLES_COMPACT
    for fit in (2, 1):
        for cols in _COLS:
            if cols > max(block_d, _COLS[-1]):
                continue
            lanes = cols // 2
            rows = next((r for r in _ROWS
                         if lanes * -(-n // r) <= max_threads), None)
            if rows is None:
                continue
            threads = lanes * -(-n // rows)
            share = min(fit, max(1, _THREADS_AT_64_REGISTERS // threads))
            for nbuf in (2, 1):
                smem = lib.perm_gossip_smem_bytes(
                    n, cols, w_window, m, int(wire_bf16), nbuf, tables)
                if smem <= limit // share:
                    return LaunchShape(cols, rows, threads, nbuf, tables)
    return None


@functools.lru_cache(maxsize=None)
def _launch_shape(lib, n: int, m: int, w_window: int, block_d: int,
                  wire_bf16: bool, state_bytes: int = 4, steps: int = 1):
    """The kernel's launch shape for ``steps`` steps on an ``[n, D]`` state
    of ``state_bytes``-byte values with ``m`` matchings: a pure function
    of its arguments and the library's limits (``perm_gossip_smem_bytes``,
    ``perm_gossip_smem_limit``, ``perm_gossip_max_threads``), kept per
    arguments.  The band path's ``BandShape`` for one step from
    ``_BAND_MIN_WORKERS`` workers and wherever no slab shape takes ``n``
    and ``m``; else a slab ``LaunchShape`` (``_slab_shape``)."""
    slab = None
    if steps > 1 or n < _BAND_MIN_WORKERS:
        slab = _slab_shape(lib, n, m, w_window, block_d, wire_bf16)
    return slab if slab is not None else band_shape(n, state_bytes)


_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "perm_gossip_launch": ([_VP] * 5 + [_I, _LL] + [_I] * 11 + [_VP], _I),
    "perm_gossip_smem_bytes": ([_I] * 7, _LL),
    "perm_gossip_smem_limit": ([], _LL),
    "perm_gossip_max_threads": ([], _LL),
    "perm_gossip_error_string": ([_I], ctypes.c_char_p),
    "perm_gossip_band_launch": ([_VP] * 5 + [_I, _LL] + [_I] * 5 + [_VP],
                                _I),
    "perm_gossip_band_scratch_bytes": ([_I, _LL] + [_I] * 3, _LL),
}


def _library():
    from .. import _kernels

    return _kernels.load("perm_gossip", _SIGNATURES)


_STATE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _launch(x, weights, perms, gate, w_window, block_d, wire, dbuf,
            shape=None):
    """Launch the kernel on the current stream; ``shape`` (a slab
    ``LaunchShape`` or a ``BandShape``) overrides ``_launch_shape``."""
    if x.dtype not in _STATE_CODES:
        raise ValueError(f"perm_gossip kernel takes a float32 or bfloat16 "
                         f"state, got {x.dtype}")
    if wire not in (None, torch.bfloat16):
        raise ValueError(f"perm_gossip kernel takes an f32 or bf16 wire, "
                         f"got {wire}")
    lib = _library()
    n, d = x.shape
    t_padded, m = weights.shape
    state, wire_code = _STATE_CODES[x.dtype], 0 if wire is None else 1
    if shape is None:
        shape = _launch_shape(lib, n, m, w_window, block_d, wire is not None,
                              x.element_size(), t_padded)
    x = x.contiguous()
    out = torch.empty_like(x)
    counter = "perm_gossip_dbuf" if dbuf else "perm_gossip_stream"
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if isinstance(shape, BandShape):
            # a row's entries side by side: {partner, gate bits} [N, M]
            table = torch.stack((perms, gate.view(torch.int32)),
                                dim=-1).transpose(0, 1).contiguous()
            nbytes = lib.perm_gossip_band_scratch_bytes(
                n, d, t_padded, state, shape.cols)
            if nbytes < 0:
                raise ValueError(f"perm_gossip band path refuses {shape}")
            scratch = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
            rc = lib.perm_gossip_band_launch(
                x.data_ptr(), out.data_ptr(), weights.data_ptr(),
                table.data_ptr(), scratch.data_ptr(), n, d, t_padded, m,
                state, wire_code, shape.cols, stream)
            path = "band"
        else:
            rc = lib.perm_gossip_launch(
                x.data_ptr(), out.data_ptr(), weights.data_ptr(),
                perms.data_ptr(), gate.data_ptr(), n, d, t_padded, m,
                w_window, shape.cols, shape.rows, shape.threads, state,
                wire_code, int(dbuf), shape.nbuf, shape.tables, stream)
            path = "slab"
    if rc != 0:
        raise RuntimeError(f"perm_gossip {path} kernel launch failed: "
                           f"{lib.perm_gossip_error_string(rc).decode()}")
    LAUNCHES[counter] += 1
    LAUNCHES[f"perm_gossip/{path}"] += 1
    add_kernel_flops(perm_gossip_flops(m, n, d, t_padded))
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
    ``T % w_window != 0``); ``block_d``: the widest column slab a CTA may
    take (the kernel takes 2 to 64 columns).  Neither changes the
    arithmetic.  The slab kernel takes N up to 4096 with up to 24
    matchings, up to 8192 with up to 10; one step from 4096 workers and
    any shape the slabs cannot take run the band path (the state in device
    memory, walked in column bands that stay in L2; ``block_d`` does not
    enter it), with the same bits (``_launch_shape``).
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
