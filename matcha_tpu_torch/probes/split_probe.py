"""The split-step probe (K4): does splitting each step's product over the
two column halves of a tile, so that one half's cast and store can overlap
the other half's products, speed up a step of the fused W-stack chain?

    python -m matcha_tpu_torch.probes.split_probe [--reps 5] [--out FILE]

Port of ``benchmarks/split_probe.py``.  It runs T = 2000 steps of
``x ← bf16(W_t @ x)`` (f32 accumulation) on a bf16 ``[256, 273258]`` state
with a bf16 ``[2000, 256, 256]`` stack, once with each schedule of the
tensor-core kernel in ``csrc/fused_gossip.cu``: unsplit (K3's bf16 path)
and split (the two column halves of a tile owned by two halves of the
CTA's warps, each with its own W ring and named barrier).  The split is a
schedule, not arithmetic: the two outputs must be bitwise equal.  It
prints the reference's one-line record, with the ratio of the two step
rates (best of ``--reps``, CUDA events).

Unlike the reference, it catches nothing: a failed launch raises, and
unequal outputs raise after the record is printed, so the command exits
non-zero.  The inputs follow the reference's distributions (``x ~ N(0, 1)``,
``W_t = 0.9·I + 0.01·N(0, 1)``, both bf16) from a ``torch.Generator``
seeded by ``--seed``; JAX's random bits are not reproduced.  Each step
shrinks the state by about 0.914, so by T = 2000 it is zeros and
subnormals (``PERF.md``): the equality there is bitwise but says little
about the arithmetic, which ``chip_smoke.py`` checks at T ≤ 64.
"""

from __future__ import annotations

import argparse
import json
import operator
import time

import torch

from ..parallel.fused_gossip import (
    SPLIT,
    TENSOR_CORE,
    fused_gossip_plain,
    kernel_shape,
    launch_kernel,
    prepare_stack,
)
from ..utils.device import resolve_device

__all__ = ["N", "D", "T", "BLOCK_D", "W_WINDOW", "main", "make_inputs",
           "split_gossip_plain", "split_gossip_run"]

# the reference's constants (benchmarks/split_probe.py:29)
N, D, T, BLOCK_D, W_WINDOW = 256, 273258, 2000, 4096, 8

#: The plain PyTorch version: the split is a schedule, not arithmetic, so
#: both schedules have this one plain form.
split_gossip_plain = fused_gossip_plain


def make_inputs(n: int, d: int, steps: int, generator: torch.Generator):
    """The probe's inputs on ``generator``'s device: ``x ~ N(0, 1)`` as
    bf16 ``[n, d]`` and ``W_t = 0.01·N(0, 1) + 0.9·I`` drawn in f32 and cast
    to bf16, ``[steps, n, n]`` — the reference's distributions
    (``benchmarks/split_probe.py:50-55``)."""
    dev = generator.device
    x = torch.randn(n, d, generator=generator, device=dev)
    stack = torch.randn(steps, n, n, generator=generator, device=dev) * 0.01
    stack += 0.9 * torch.eye(n, device=dev)
    return x.to(torch.bfloat16), stack.to(torch.bfloat16)


def split_gossip_run(x: torch.Tensor, stack, *, split: bool,
                     block_d: int = BLOCK_D,
                     w_window: int = W_WINDOW) -> torch.Tensor:
    """``T`` steps of ``x ← cast_state(W_t @ bf16(x))`` in one launch of the
    tensor-core kernel, with the split schedule when ``split``.

    ``x``: ``[N, D]`` float32 or bfloat16; ``stack``: bfloat16
    ``[T, N, N]``.  ``T`` must be a multiple of ``w_window``: the
    reference's grid ``T // w_window`` would drop the remainder, and the
    probe has no identity padding.  ``block_d`` caps the column tile; both
    schedules take the tile the split one fits, so the two are compared at
    one tile.  The kernel stages one ``W_t`` at a time, and neither knob
    changes a bit.  ``T == 0`` returns ``x`` itself.  A CPU tensor runs the
    plain version; a CUDA tensor launches the kernel or raises.
    """
    return _run(x, stack, split, block_d, w_window)[0]


def _run(x, stack, split, block_d, w_window):
    """:func:`split_gossip_run`, and the tile its launch took (None where
    nothing was launched)."""
    prep = prepare_stack(x, stack, block_d, 1)
    stack = torch.as_tensor(stack)
    if stack.dtype != torch.bfloat16:
        raise ValueError(f"split_gossip takes a bfloat16 mixing stack, got "
                         f"{stack.dtype}")
    w_window = operator.index(w_window)
    if w_window < 1 or stack.shape[0] % w_window:
        raise ValueError(f"split_gossip: {stack.shape[0]} steps are not a "
                         f"multiple of w_window={w_window}")
    if prep is None:
        return x, None
    stack, block_d = prep
    if x.device.type == "cpu":
        return split_gossip_plain(x, stack), None
    if x.device.type == "cuda":
        shape = kernel_shape(x.shape[0], block_d, SPLIT, stack.shape[0])
        if not split:  # the unsplit schedule at the split one's tile
            shape = shape._replace(path=TENSOR_CORE)
        return launch_kernel(x, stack, shape,
                             counter="split_gossip"), shape.tile
    raise ValueError(f"split_gossip_run takes a CPU or CUDA tensor, got "
                     f"device {x.device}")


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    as_int = torch.int32 if a.element_size() == 4 else torch.int16
    return a.dtype == b.dtype and torch.equal(a.view(as_int), b.view(as_int))


def _best_seconds(fn, reps: int, device: torch.device) -> float:
    """Best of ``reps`` timed calls after one warm-up: CUDA events on the
    card, the host clock on the CPU."""
    fn()
    best = float("inf")
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize(device)
            seconds = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            fn()
            seconds = time.perf_counter() - t0
        best = min(best, seconds)
    return best


def main(argv=None) -> dict:
    """Run the probe, print its one-line record (and write it to
    ``--out``), and return it.  Raises if the two schedules disagree."""
    p = argparse.ArgumentParser(
        prog="python -m matcha_tpu_torch.probes.split_probe",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=None, help="also write the record here")
    p.add_argument("--reps", type=int, default=5,
                   help="timed runs per schedule; the best counts")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="'cpu' for the plain version; the card otherwise")
    p.add_argument("--n", type=int, default=N)
    p.add_argument("--d", type=int, default=D)
    p.add_argument("--steps", type=int, default=T)
    args = p.parse_args(argv)
    if args.reps < 1:
        p.error("--reps must be >= 1 (best-of-0 would emit Infinity, which "
                "is not valid JSON)")
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    x, stack = make_inputs(args.n, args.d, args.steps, gen)
    # block_d: the tile both schedules' launches took (on the CPU, where
    # nothing is launched, the cap)
    rec = {"probe": "split-cast-overlap", "n": args.n, "d": args.d,
           "steps": args.steps, "block_d": min(BLOCK_D, args.d),
           "w_window": W_WINDOW,
           "device_kind": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu")}
    y0, tile = _run(x, stack, False, BLOCK_D, W_WINDOW)
    y1, _ = _run(x, stack, True, BLOCK_D, W_WINDOW)
    if tile is not None:
        rec["block_d"] = tile
    rec["outputs_equal"] = _same_bits(y0, y1)
    rec["slice_sums_equal"] = rec["outputs_equal"]  # the reference's key
    del y0, y1
    rates = {}
    for split in (False, True):
        best = _best_seconds(lambda: split_gossip_run(x, stack, split=split),
                             args.reps, dev)
        rates[split] = args.steps / best
    rec["base_steps_per_sec"] = round(rates[False], 1)
    rec["split_steps_per_sec"] = round(rates[True], 1)
    rec["ratio"] = round(rates[True] / rates[False], 4)
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    if not rec["outputs_equal"]:
        raise AssertionError("split and unsplit schedules gave different "
                             "bits")
    return rec


if __name__ == "__main__":
    main()
