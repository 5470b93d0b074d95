"""Build and load the port's hand-written CUDA kernels, and count their
launches.

Each ``csrc/<name>.cu`` has a plain C interface.  At first use it is
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``matcha_tpu_torch/_build/`` and loaded with ``ctypes``; nothing includes
PyTorch's headers, so a build takes seconds.  The library's file name
carries a hash of its source and flags, so an edited source never loads a
stale build.  ``build_all`` compiles several sources at once, one ``nvcc``
each.  ``pick_tile`` is the column-tile rule of the tensor cores'
shared-memory mainloop.

``LAUNCHES`` holds one count per kernel; each wrapper adds one where it
launches its kernel and nowhere else, so a run can show that its gossip
went through the kernels.  Beside the count, each wrapper reports its
launch's operations to the open :func:`kernel_flop_meter` (``obs.costs``:
``FlopCounterMode`` does not see a ``ctypes`` launch).  Each kernel's
operation count has one function here (:func:`fused_gossip_flops`,
:func:`perm_gossip_flops`), which the wrappers and the roofline both call.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

__all__ = ["LAUNCHES", "NVCC_FLAGS", "TILES", "add_kernel_flops", "build",
           "build_all", "fused_gossip_flops", "kernel_flop_meter", "load",
           "nvcc_path", "perm_gossip_flops", "pick_tile",
           "reset_launch_counts"]

_PKG = Path(__file__).resolve().parent
SOURCE_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

#: -fmad=false keeps every product and sum separately rounded, which is what
#: makes the perm kernel bitwise equal to its plain PyTorch version
#: (separate mul and add kernels); a kernel that wants a fused multiply-add
#: calls ``__fmaf_rn``, which the flag leaves alone.  -Xptxas -v reports
#: registers, shared memory and spills.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
              "-Xptxas", "-v")

_LOADED: dict = {}

#: kernel launches, counted by each wrapper where it launches its kernel;
#: the fused and perm wrappers also count each path ("fused_gossip/<path>",
#: "perm_gossip/<path>")
LAUNCHES = {"perm_gossip_dbuf": 0, "perm_gossip_stream": 0,
            "fused_gossip": 0, "split_gossip": 0,
            "fused_gossip/fma_regs": 0, "fused_gossip/fma": 0,
            "fused_gossip/tc_regs": 0, "fused_gossip/tensor_core": 0,
            "fused_gossip/fma_step": 0, "fused_gossip/tc_step": 0,
            "perm_gossip/slab": 0, "perm_gossip/band": 0,
            "split_gossip/tensor_core": 0, "split_gossip/split": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def fused_gossip_flops(n: int, d: int, t_steps: int = 1) -> float:
    """The fused kernel's operations (the JAX package's hand model):
    ``W_t @ x`` a step, ``2·N²·D·T``."""
    return 2.0 * n * n * d * t_steps


def perm_gossip_flops(m: int, n: int, d: int, t_steps: int = 1) -> float:
    """The perm kernel's operations (the JAX package's hand model): a
    gather-subtract, a gate-scale and two f32 accumulates per matching,
    row and column, each step: ``(4·M+2)·N·D·T``."""
    return float((4 * m + 2) * n * d * t_steps)


_FLOP_METERS: list = []


@contextlib.contextmanager
def kernel_flop_meter():
    """Sum the hand-model operations of the kernels launched inside the
    block: yields a one-element list holding the running total."""
    meter = [0.0]
    _FLOP_METERS.append(meter)
    try:
        yield meter
    finally:
        _FLOP_METERS.remove(meter)


def add_kernel_flops(flops: float) -> None:
    """A wrapper's report of one launch's operations to the open meters."""
    for meter in _FLOP_METERS:
        meter[0] += float(flops)


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels are compiled at first use on the card's host")


def _library_path(name: str) -> Path:
    src = (SOURCE_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str) -> dict:
    """Compile ``csrc/<name>.cu`` unless a current build exists.  Returns
    ``{"seconds", "ptxas", "cached"}``; raises ``RuntimeError`` with the
    compiler's output if the build fails."""
    lib = _library_path(name)
    if lib.exists():
        return {"seconds": 0.0, "ptxas": "", "cached": True}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           str(SOURCE_DIR / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"kernel build failed: {name}: nvcc exit "
                           f"{proc.returncode}\n{proc.stdout}")
    os.replace(tmp, lib)
    return {"seconds": time.perf_counter() - t0, "ptxas": proc.stdout,
            "cached": False}


def build_all(names) -> dict:
    """``build`` every source in ``names`` at once (one ``nvcc`` each, all
    started together).  Returns ``{name: build report}``; raises the first
    failure."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(build, names)))


def load(name: str, signatures=None) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed.
    ``signatures`` (``{function: (argtypes, restype)}``) types the C
    functions once, at first load."""
    lib = _LOADED.get(name)
    if lib is None:
        path = _library_path(name)
        if not path.exists():
            build(name)
        lib = ctypes.CDLL(str(path))
        for fn, (argtypes, restype) in (signatures or {}).items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _LOADED[name] = lib
    return lib


TILES = (256, 128, 64, 32)


def pick_tile(kernel: str, smem_bytes, limit: int, n: int, block_d: int,
              blocks_per_sm: int, tiles=TILES) -> int:
    """Columns per CTA for an ``[n, D]`` state: the widest of ``tiles``
    (widest first) that is ≤ ``block_d`` and whose shared memory,
    ``smem_bytes(tile)``, leaves room for ``blocks_per_sm`` CTAs on one SM
    (``limit`` is what one block may use); else the narrowest tile, which
    keeps the most CTAs in flight, if it fits one block at all.  A tile
    whose ``smem_bytes`` is negative is one the kernel does not take at
    this ``n``, and is skipped."""
    tiles = [t for t in tiles if smem_bytes(t) >= 0]
    for tile in tiles:
        if tile <= block_d and smem_bytes(tile) <= limit // blocks_per_sm:
            return tile
    need = smem_bytes(tiles[-1])
    if need <= limit:
        return tiles[-1]
    raise ValueError(
        f"{kernel}: {n} workers need {need} B of shared memory at the "
        f"narrowest tile ({tiles[-1]} columns), more than the {limit} B a "
        f"block may use (the split probe's schedule keeps this cap, "
        f"ROADMAP.md; fused_gossip_run takes such N one step at a time)")
