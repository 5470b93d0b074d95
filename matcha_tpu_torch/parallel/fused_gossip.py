"""Fused W-stack gossip: T dense mixing steps on an ``[N, D]`` state in one
kernel launch.

Port of the fused half of ``matcha_tpu/parallel/pallas_gossip.py``:
``build_mixing_stack`` (:77), ``canonical_chunk`` (:95),
``compose_mixing_stack`` (:107) and ``fused_gossip_run`` (:182).  The
Pallas kernel behind ``fused_gossip_run`` (``_make_kernel`` :156) becomes
the hand-written CUDA source ``csrc/fused_gossip.cu``: a column's whole
chain runs in one CTA, its state on chip for all T steps while the
``[T, N, N]`` stack streams past it.

Per step: ``x ← cast_state(W_t @ cast_stack(x))``, f32 accumulation.  The
state is rounded to the stack's dtype at each step's input and the f32 sum
to the state's dtype at its output, exactly as the per-step dense backend
(``gossip.gossip_mix_dense``) does, so a chain equals stepping through it.

The stack's dtype and N pick the kernel's path (:func:`kernel_path`):

* float32 stack — FP32 FMA on CUDA cores (never TF32, which would change
  the result): for N ≤ ``N_REG_F32`` each thread holds its columns of all
  N rows in registers (``FMA_REGS``); up to ``N_CHAIN_F32`` one step's
  sums fit the CTA's registers and the state tile sits in shared memory
  once (``FMA``); above that one launch per step, the state in device
  memory (``FMA_STEP``).  All three sum in the same order and give the
  same bits; held to the plain version within f32 rounding.
* bfloat16 stack — the tensor cores (bf16 operands, f32 accumulators): for
  N ≤ ``N_REG_TC`` a warp chains the steps' products in registers
  (``mma.sync``, ``TC_REGS``); up to ``N_SMEM_TC`` the state tile is held
  in shared memory as bf16 while a producer warp streams ``W_t`` by TMA to
  two ``wgmma`` warpgroups (``TENSOR_CORE``); above that one launch per
  step on ``wgmma`` (``TC_STEP``), bitwise equal to ``TENSOR_CORE``; held
  to the plain version within one bf16 ulp of the output.  The split-step probe
  (``probes/split_probe.py``, K4) runs the shared-memory mainloop with its
  split schedule (``SPLIT``).

``fused_gossip_run`` takes the plain PyTorch version, ``fused_gossip_plain``
(one ``torch.matmul`` per step, TF32 off), for a tensor on the CPU only; a
CUDA tensor launches the kernel of its path or raises: no path falls back
to another.  ``LAUNCHES["fused_gossip"]`` counts kernel launches, and
``LAUNCHES["fused_gossip/<path name>"]`` those of each path (a per-step
path's call counts once, whatever its T launches).  A per-step path (and
the FMA chain, for its transposed copy of the stack) takes scratch in
device memory from PyTorch's allocator; where the card cannot hold it, the
allocation raises.
"""

from __future__ import annotations

import ctypes
import functools
import operator
from typing import NamedTuple

import torch

from .._kernels import (LAUNCHES, add_kernel_flops, fused_gossip_flops,
                       pick_tile)
from .gossip import _dense_apply, _mixing_matrices, mxu_precision

__all__ = [
    "LaunchShape",
    "build_mixing_stack",
    "canonical_chunk",
    "compose_mixing_stack",
    "fused_gossip_plain",
    "fused_gossip_run",
    "kernel_path",
    "kernel_shape",
    "launch_kernel",
    "prepare_stack",
]

# The kernel's paths (``fused_gossip_launch``'s ``path``): FP32 FMA for an
# f32 stack, the tensor cores for a bf16 stack (unsplit or split); at small
# N with the columns in registers, in the middle with the state tile in
# shared memory, at large N one launch per step.
FMA, TENSOR_CORE, SPLIT, FMA_REGS, TC_REGS, FMA_STEP, TC_STEP = range(7)
PATH_NAMES = {FMA: "fma", TENSOR_CORE: "tensor_core", SPLIT: "split",
              FMA_REGS: "fma_regs", TC_REGS: "tc_regs", FMA_STEP: "fma_step",
              TC_STEP: "tc_step"}
#: The largest N each register path takes (``fused_gossip_reg_max_n``).
N_REG_F32, N_REG_TC = 16, 16
#: The largest N of the FMA chain (one step's N x tile sums in the CTA's
#: registers: 256 threads of 8 x 8) and of the shared-memory tensor cores
#: (whose tile-32 state and two W stages fit shared memory to 1,280
#: workers).
N_CHAIN_F32, N_SMEM_TC = 256, 1024

# The FMA chain: 256 threads of an 8 x 8 block hold 16,384 sums, so its
# tile is 16384 / rows columns for rows = 32, 64, 128 or 256 >= N: the
# widest (the fewest re-reads of the stack from L2, (D/tile)·T·N²
# elements in all) unless ``block_d`` caps it.
_CHAIN_OUTPUTS = 16384
_CHAIN_TILES = (512, 256, 128, 64)
# The tensor cores' shared-memory mainloop: the CTAs a column tile should
# leave room for on one SM (one CTA keeps up to four W stages in flight
# itself, and N = 256 takes the 128-column tile).
_BLOCKS_PER_SM = {TENSOR_CORE: 1, SPLIT: 1}
# The per-step paths (FMA_STEP, TC_STEP): the columns of a CTA's output
# tile come from the library (``fused_gossip_step_tile``).
_STEP_PATHS = (FMA_STEP, TC_STEP)
# Register paths: the rows a thread may hold (FMA_REGS pads N up to one of
# them), and the columns a CTA takes per round of its grid: 256 threads of
# one column pair (FMA_REGS), 8 warps of two m16 tiles (TC_REGS).
_REG_ROWS = (8, 16)
_REG_COLS = {FMA_REGS: 512, TC_REGS: 256}

_DTYPES = (torch.float32, torch.bfloat16)


def build_mixing_stack(laplacians, alpha: float, flags,
                       dtype=torch.bfloat16) -> torch.Tensor:
    """``W[t] = I − Σ_j α·flags[t,j]·L_j`` for every step — ``[T, N, N]``,
    built in f32 on the device of ``flags`` and cast to ``dtype`` at the
    end.  Each ``W[t]`` has the bits the dense step builds for step t."""
    device = flags.device if isinstance(flags, torch.Tensor) else None
    lap = torch.as_tensor(laplacians, dtype=torch.float32, device=device)
    w = alpha * torch.as_tensor(flags, dtype=torch.float32, device=device)
    return _mixing_matrices(w, lap).to(dtype)


def canonical_chunk(chunk: int) -> int:
    """The chunk size :func:`compose_mixing_stack` actually executes:
    powers of two (pairwise doubling); values ≤ 1 disable composition.
    ``operator.index`` refuses a float instead of truncating it."""
    chunk = operator.index(chunk)
    return chunk if chunk <= 1 else 1 << (chunk - 1).bit_length()


def compose_mixing_stack(stack: torch.Tensor, chunk: int) -> torch.Tensor:
    """Collapse runs of ``chunk`` consecutive mixing matrices into their
    product: ``P_c = W_{cS+S−1} ⋯ W_{cS}`` — ``[⌈T/S⌉, N, N]``.

    By associativity one ``P_c`` per chunk computes the same ``x_T`` as the
    S steps (intermediate iterates are not materialized: consensus-only
    chains, not training).  ``chunk`` rounds up to a power of two S; the
    composition runs as log₂(S) pairwise-doubling levels of batched f32
    products (TF32 off), later steps on the left, with identity matrices
    padding the back of the stream, and casts to the stack's dtype once at
    the end.
    """
    t_steps, n, _ = stack.shape
    chunk2 = canonical_chunk(chunk)
    if chunk2 <= 1:
        return stack
    levels = chunk2.bit_length() - 1
    pad = (-t_steps) % chunk2
    w = stack.to(torch.float32)
    if pad:
        eye = torch.eye(n, dtype=torch.float32, device=stack.device)
        w = torch.cat([w, eye.expand(pad, n, n)])
    with mxu_precision():
        for _ in range(levels):
            # steps (2i, 2i+1) fuse to W_{2i+1} @ W_{2i}
            w = torch.matmul(w[1::2], w[0::2])
    return w.to(stack.dtype)


def prepare_stack(x, mixing_stack, block_d, w_window):
    """Validate and normalize the arguments shared by the kernel and its
    plain version.  Returns None for an empty stream (identity), else
    ``(stack [T', N, N] front-padded, block_d)`` on ``x``'s device."""
    if x.ndim != 2:
        raise ValueError(f"x must be [N, D], got {tuple(x.shape)}")
    n, d = x.shape
    stack = torch.as_tensor(mixing_stack, device=x.device)
    if stack.ndim != 3 or tuple(stack.shape[1:]) != (n, n):
        raise ValueError(f"mixing stack {tuple(stack.shape)} vs state "
                         f"{tuple(x.shape)}")
    for what, dtype in (("state", x.dtype), ("mixing stack", stack.dtype)):
        if dtype not in _DTYPES:
            raise ValueError(f"fused_gossip takes a float32 or bfloat16 "
                             f"{what}, got {dtype}")
    block_d = min(operator.index(block_d), d)
    t_steps = stack.shape[0]
    if t_steps == 0:
        return None
    w_window = max(1, min(operator.index(w_window), t_steps))
    pad = (-t_steps) % w_window
    if pad:
        # front identity padding, as the reference: the pad steps give
        # cast_state(I @ cast_stack(x)), which the first real step's input
        # cast makes indistinguishable from x
        eye = torch.eye(n, dtype=stack.dtype, device=x.device)
        stack = torch.cat([eye.expand(pad, n, n), stack])
    return stack.contiguous(), block_d


def _plain(x, stack):
    out = x
    for t in range(stack.shape[0]):
        out = _dense_apply(stack[t], out, stack.dtype)
    return out


def fused_gossip_plain(x: torch.Tensor, mixing_stack, *, block_d: int = 2048,
                       w_window: int = 1) -> torch.Tensor:
    """The plain PyTorch version of the fused kernel, on any device: per
    step ``(W_t.float() @ x.to(stack dtype).float()).to(x.dtype)`` with TF32
    off.  The CPU path of :func:`fused_gossip_run` and the kernel's
    yardstick on the card; ``block_d`` and ``w_window`` change nothing."""
    prep = prepare_stack(x, mixing_stack, block_d, w_window)
    if prep is None:
        return x
    return _plain(x, prep[0])


def _tile_width(lib, n: int, block_d: int, path: int = TENSOR_CORE) -> int:
    """Columns per CTA of the tensor cores' shared-memory mainloop
    (``_kernels.pick_tile``: 256 (unsplit only), 128, 64 or 32), leaving
    room for ``_BLOCKS_PER_SM[path]`` CTAs on one SM."""
    return pick_tile("split_gossip" if path == SPLIT else "fused_gossip",
                     lambda tile: lib.fused_gossip_smem_bytes(n, tile, path),
                     lib.fused_gossip_smem_limit(), n, block_d,
                     _BLOCKS_PER_SM[path])


class LaunchShape(NamedTuple):
    """How one launch cuts the work (``fused_gossip_launch``'s arguments).
    ``tile``: columns per CTA (per round on the register paths, whose grid
    is persistent).  ``rows``: rows a thread holds (FMA_REGS: N padded to
    8 or 16; TC_REGS: 16), or the FMA chain's rows of sums (16384 /
    tile).  ``window``: steps of the stack staged in shared
    memory at a time (the whole stack where it fits).  0 where the path
    has no such choice."""

    path: int
    tile: int
    rows: int = 0
    window: int = 0


def _launch_shape(lib, n: int, block_d: int, path: int,
                  t_steps: int) -> LaunchShape:
    """The launch shape of ``path`` for ``t_steps`` steps of an ``[n, D]``
    state; ``block_d`` caps the shared-memory paths' tile only (a register
    or per-step path's columns per CTA are fixed)."""
    if path == FMA:
        if n > N_CHAIN_F32:
            raise ValueError(f"fused_gossip: the FMA chain holds a step's "
                             f"sums in registers for N <= {N_CHAIN_F32}, "
                             f"got {n}")
        tiles = [t for t in _CHAIN_TILES if _CHAIN_OUTPUTS // t >= n]
        tile = next((t for t in tiles if t <= block_d), tiles[-1])
        return LaunchShape(path, tile, _CHAIN_OUTPUTS // tile)
    if path in _STEP_PATHS:
        return LaunchShape(path, lib.fused_gossip_step_tile(path))
    if path == FMA_REGS:
        if n > lib.fused_gossip_reg_max_n(path):
            raise ValueError(f"fused_gossip: the register FMA path takes "
                             f"N <= {N_REG_F32}, got {n}")
        rows = next(r for r in _REG_ROWS if r >= n)
        return LaunchShape(path, _REG_COLS[path], rows,
                           min(t_steps, lib.fused_gossip_stage_bytes()
                               // (4 * rows * rows)))
    if path == TC_REGS:
        if n > lib.fused_gossip_reg_max_n(path):
            raise ValueError(f"fused_gossip: the register tensor-core path "
                             f"takes N <= {N_REG_TC}, got {n}")
        return LaunchShape(path, _REG_COLS[path], 16,
                           min(t_steps, lib.fused_gossip_stage_bytes() // 512))
    return LaunchShape(path, _tile_width(lib, n, block_d, path))


_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "fused_gossip_launch": ([_VP] * 4 + [_I, _LL] + [_I] * 6 + [_VP], _I),
    "fused_gossip_scratch_bytes": ([_I, _LL, _I, _I, _I, _I], _LL),
    "fused_gossip_smem_bytes": ([_I, _I, _I], _LL),
    "fused_gossip_smem_limit": ([], _LL),
    "fused_gossip_reg_max_n": ([_I], _LL),
    "fused_gossip_stage_bytes": ([], _LL),
    "fused_gossip_step_tile": ([_I], _LL),
    "fused_gossip_error_string": ([_I], ctypes.c_char_p),
}


def _library():
    from .. import _kernels

    return _kernels.load("fused_gossip", _SIGNATURES)


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def kernel_path(stack_dtype, n: int, split: bool = False) -> int:
    """The kernel path a stack of ``stack_dtype`` takes for ``n`` workers:
    float32 runs FP32 FMA, with the columns in registers up to
    ``N_REG_F32`` workers, the state tile in shared memory up to
    ``N_CHAIN_F32``, one launch per step above; bfloat16 runs the tensor
    cores, chained in registers up to ``N_REG_TC`` workers, the state tile
    in shared memory up to ``N_SMEM_TC``, one launch per step above.
    ``split`` picks K4's split schedule, which only the shared-memory
    tensor-core mainloop has.  The state's dtype never changes the
    path."""
    if stack_dtype == torch.bfloat16:
        if split:
            return SPLIT
        if n <= N_REG_TC:
            return TC_REGS
        return TENSOR_CORE if n <= N_SMEM_TC else TC_STEP
    if split:
        raise ValueError("the split schedule runs on the tensor cores: it "
                         "takes a bfloat16 mixing stack")
    if n <= N_REG_F32:
        return FMA_REGS
    return FMA if n <= N_CHAIN_F32 else FMA_STEP


@functools.lru_cache(maxsize=256)
def kernel_shape(n: int, block_d: int, path: int,
                 t_steps: int) -> LaunchShape:
    """The launch shape ``path`` takes for ``t_steps`` steps of an
    ``[n, D]`` state when ``block_d`` caps a shared-memory tile; loads the
    library."""
    return _launch_shape(_library(), n, block_d, path, t_steps)


def launch_kernel(x, stack, shape: LaunchShape, *,
                  counter: str = "fused_gossip") -> torch.Tensor:
    """Launch the kernel on CUDA tensors along ``shape.path`` (from
    :func:`kernel_shape`).  A bf16 stack's ``[T, N, N]`` is zero-padded to
    a multiple of 16 first.  ``stack`` is :func:`prepare_stack`'s.  Counts
    the launch in ``LAUNCHES[counter]`` (the calling wrapper's name) and
    ``LAUNCHES[counter + "/" + path name]``.  Raises if the launch
    fails."""
    lib = _library()
    n, d = x.shape
    pad = (-n) % 16 if stack.dtype == torch.bfloat16 else 0
    if pad:
        stack = torch.nn.functional.pad(stack, (0, pad, 0, pad))
    stack = stack.contiguous()
    if stack.data_ptr() % 16:  # TMA reads the bf16 stack from 16-byte steps
        stack = stack.clone()
    x = x.contiguous()
    out = torch.empty_like(x)
    t_steps = stack.shape[0]
    state_code = _DTYPE_CODES[x.dtype]
    scratch = None
    nbytes = lib.fused_gossip_scratch_bytes(n, d, t_steps, shape.path,
                                            shape.tile, state_code)
    if nbytes > 0:
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.fused_gossip_launch(
            x.data_ptr(), out.data_ptr(), stack.data_ptr(),
            None if scratch is None else scratch.data_ptr(), n, d, t_steps,
            shape.path, shape.tile, shape.rows, shape.window, state_code,
            stream)
    if rc != 0:
        raise RuntimeError(f"fused_gossip kernel launch failed: "
                           f"{lib.fused_gossip_error_string(rc).decode()}")
    LAUNCHES[counter] += 1
    LAUNCHES[f"{counter}/{PATH_NAMES[shape.path]}"] += 1
    add_kernel_flops(fused_gossip_flops(n, d, t_steps))
    return out


def fused_gossip_run(x: torch.Tensor, mixing_stack, *, block_d: int = 2048,
                     w_window: int = 1) -> torch.Tensor:
    """Apply ``T`` gossip steps ``x ← cast(W_t @ x)`` in one kernel launch.

    ``x``: ``[N, D]`` worker state (float32 or bfloat16).  ``mixing_stack``:
    ``[T, N, N]`` (float32 or bfloat16) from :func:`build_mixing_stack`,
    optionally composed.  Each step accumulates in f32 and casts back to
    ``x.dtype``, step for step the dense backend's arithmetic.

    ``block_d``: the widest column tile a shared-memory CTA may take
    (64, 128, 256 or 512 columns on the FMA chain, 32, 64, 128 or 256 on
    the tensor cores; below the narrowest, the narrowest); the register paths
    of N ≤ ``N_REG_F32`` (16, f32 stack) and N ≤ ``N_REG_TC`` (16, bf16
    stack) and the per-step paths take fixed column groups and ignore it.
    ``w_window``: the reference's steps per grid visit; the stack is
    front-padded with identity matrices to a multiple of it, as the
    reference does, and the kernel otherwise ignores it.  Neither changes
    a bit of the result.

    An empty stream (``T == 0``) returns ``x`` itself.  A CPU tensor runs
    :func:`fused_gossip_plain`.  A CUDA tensor launches the kernel of
    :func:`kernel_path` on the current stream and raises if the launch
    fails: an f32 stack runs FP32 FMA on CUDA cores, a bf16 stack the
    tensor cores (bf16 operands, f32 accumulation, the state rounded to
    bf16 between steps), with no fallback from one path to another.  The
    path depends on N alone and takes every N (above ``N_CHAIN_F32``
    and ``N_SMEM_TC``, one launch per step).
    """
    prep = prepare_stack(x, mixing_stack, block_d, w_window)
    if prep is None:
        return x
    stack, block_d = prep
    if x.device.type == "cpu":
        return _plain(x, stack)
    if x.device.type == "cuda":
        n = x.shape[0]
        shape = kernel_shape(n, block_d, kernel_path(stack.dtype, n),
                             stack.shape[0])
        return launch_kernel(x, stack, shape)
    raise ValueError(f"fused_gossip_run takes a CPU or CUDA tensor, got "
                     f"device {x.device}")
