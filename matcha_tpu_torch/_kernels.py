"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface.  At first use it is
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``matcha_tpu_torch/_build/`` and loaded with ``ctypes``; nothing includes
PyTorch's headers, so a build takes seconds.  The library's file name
carries a hash of its source and flags, so an edited source never loads a
stale build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build", "load", "nvcc_path"]

_PKG = Path(__file__).resolve().parent
SOURCE_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

#: -fmad=false keeps every product and sum separately rounded, which is what
#: makes a kernel bitwise equal to its plain PyTorch version (separate mul
#: and add kernels); -Xptxas -v reports registers, shared memory and spills.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
              "-Xptxas", "-v")

_LOADED: dict = {}


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


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        path = _library_path(name)
        if not path.exists():
            build(name)
        lib = ctypes.CDLL(str(path))
        _LOADED[name] = lib
    return lib
