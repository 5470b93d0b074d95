"""The fused kernel (K3, and K4's split schedule) on the card: another
tree's kernel against this one.

    python -m matcha_tpu_torch.probes.fused_bench ab --old DIR [DIR ...]
        [--rounds 3] [--only SUBSTRING ...]

``ab`` loads the ``matcha_tpu_torch`` package found in ``DIR`` (an unpacked
``git archive`` of an earlier commit, or a copy of this tree with one
choice changed) beside this one (``perm_bench.load_package``), builds both
kernel libraries, and at each shape times the two trees'
``fused_gossip_run`` in turns (old, new, new, old; ``--rounds`` times) with
CUDA events, the L2 cache flushed before each call (``perm_bench.time_ms``),
and each side's host time per call (``perm_bench.host_us``).  The two
outputs must be bitwise equal (every path sums each element in one fixed
order: an FMA chain, or the tensor cores' k16 sequence); any bit that
differs raises, after the row with the share of elements that differ is
printed.  Several ``DIR`` are compared with this tree one after another,
each row naming its ``old_tree``.

Shapes, all at D = 273,258 (ResNet-20): the training slice's ``[16, D]``
(zoo graph 4, its MATCHA schedule at budget 0.5) at T = 1, 4 (the
comm-split timer's chains) and 64, for an f32 state and stack, an f32
state with a bf16 stack, and a bf16 state and stack (N = 16 is where both
register paths stop); a ring's stack at the next N, 17, in f32 and bf16
(the shared-memory paths) at T = 1 and 64; ``[256, D]`` bf16 at T = 64 on
the 256-worker hypercube (chain (b)), and the ends of the bf16
shared-memory path's range, N = 64 (T = 64) and 1024 (T = 8), on
hypercubes; K4, the split probe's schedule, on
its own ``[256, D]`` inputs at T = 64; the f32 sweep of the FMA paths
on hypercubes, N = 32, 64, 128 and 256 at T = 64, 512 and 1024 at T = 8
(``fma_step`` above 256); ``tc_step`` on the 2048-worker hypercube, bf16,
T = 8; and the per-step paths at the end of the reference's fused range,
N = 4095, T = 1 on an f32 state (``W_t = 0.5·I + U(0, 0.5/N)``), with an
f32 stack (``fma_step``) and a bf16 one (``tc_step``).
``--only`` keeps the shapes whose label holds one of its substrings.  A
side that refuses a shape (an older tree's cap) is recorded as
"refused" and the other side is timed alone.  Every result is one JSON
line on stdout; the card's name and power limit come first.  Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import importlib
import json
import statistics
import subprocess
import sys

import torch

from ..parallel import build_mixing_stack, fused_gossip
from ..schedule import fixed_schedule, matcha_schedule
from ..topology import decompose, hypercube_graph, ring_graph, select_graph
from . import split_probe
from .perm_bench import host_us, load_package, time_ms

__all__ = ["ab", "main", "shapes"]

SEED = 9001
D = 273258
F32, BF16 = torch.float32, torch.bfloat16


def _stack(sched, t_steps, dtype, dev):
    flags = torch.as_tensor(sched.flags[:t_steps], dtype=torch.float32,
                            device=dev)
    return build_mixing_stack(sched.laplacians(), sched.alpha, flags, dtype)


def _cube(n):
    return fixed_schedule(decompose(hypercube_graph(n), n, seed=SEED), n, 64,
                          budget=0.5, mode="bernoulli", seed=SEED)


def shapes(dev, only=()):
    """``(label, x, stack, kind)`` of every shape whose label holds one of
    ``only`` (all where it is empty), on ``dev``; ``kind`` is "fused"
    (``fused_gossip_run``) or "split" (K4)."""
    for label, make in _makers(dev):
        if not only or any(o in label for o in only):
            yield (label, *make())


def _makers(dev):
    """``(label, make)``: ``make()`` returns ``(x, stack, kind)``."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    slice_sched = matcha_schedule(select_graph(4), 16, 64, budget=0.5,
                                  seed=SEED)
    x16 = torch.randn(16, D, generator=g, device=dev)
    out = []
    for t_steps in (1, 4, 64):
        for state, stack in ((F32, F32), (F32, BF16), (BF16, BF16)):
            out.append((f"slice N=16 T={t_steps} state={state} "
                        f"stack={stack}",
                        lambda t=t_steps, s=state, k=stack: (
                            x16.to(s), _stack(slice_sched, t, k, dev),
                            "fused")))
    for n, dtype in ((17, F32), (17, BF16)):
        ring = fixed_schedule(decompose(ring_graph(n), n, seed=SEED), n, 64,
                              budget=0.5, mode="bernoulli", seed=SEED)
        x = torch.randn(n, D, generator=g, device=dev).to(dtype)
        for t_steps in (1, 64):
            out.append((f"ring N={n} T={t_steps} {dtype}",
                         lambda x=x, r=ring, t=t_steps, k=dtype: (
                             x, _stack(r, t, k, dev), "fused")))
    # the bf16 shared-memory path (tensor_core): chain (b), and its range's
    # ends
    for n, t_steps in ((256, 64), (64, 64), (1024, 8)):
        out.append((f"hypercube N={n} T={t_steps} bf16",
                    lambda n=n, t=t_steps: (
                        torch.randn(n, D, generator=g, device=dev).to(BF16),
                        _stack(_cube(n), t, BF16, dev), "fused")))
    out.append(("K4 split probe N=256 T=64",
                lambda: (*split_probe.make_inputs(256, D, 64, g), "split")))
    for n in (32, 64, 128, 256, 512, 1024):
        t_steps = 64 if n <= 256 else 8
        out.append((f"hypercube N={n} T={t_steps} f32", lambda n=n, t=t_steps: (
            torch.randn(n, D, generator=g, device=dev),
            _stack(_cube(n), t, F32, dev), "fused")))
    out.append(("hypercube N=2048 T=8 bf16", lambda: (
        torch.randn(2048, D, generator=g, device=dev).to(BF16),
        _stack(_cube(2048), 8, BF16, dev), "fused")))
    for dtype in (F32, BF16):
        out.append((f"N=4095 T=1 f32 state, {dtype} stack", lambda k=dtype: (
            torch.randn(4095, D, generator=g, device=dev),
            _random_stack(4095, 1, k, g, dev), "fused")))
    return out


def _random_stack(n, t_steps, dtype, g, dev):
    """``[T, n, n]``, ``W_t = 0.5·I + U(0, 0.5/n)``: rows summing near one,
    no ``W_t`` symmetric."""
    eye = torch.eye(n, device=dev)
    return (0.5 * eye + torch.rand(t_steps, n, n, generator=g, device=dev)
            * (0.5 / n)).to(dtype)


def _same_bits(a, b) -> bool:
    as_int = torch.int32 if a.element_size() == 4 else torch.int16
    return a.dtype == b.dtype and torch.equal(a.view(as_int), b.view(as_int))


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def ab(old_root, rounds: int = 3, only=(),
       alias: str = "matcha_tpu_torch_old") -> list:
    dev = torch.device("cuda")
    alias = load_package(old_root, alias).__name__
    old = {"fused": importlib.import_module(
               f"{alias}.parallel.fused_gossip").fused_gossip_run,
           "split": importlib.import_module(
               f"{alias}.probes.split_probe").split_gossip_run}
    new = {"fused": fused_gossip.fused_gossip_run,
           "split": split_probe.split_gossip_run}
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rows = []
    for label, x, stack, kind in shapes(dev, only):
        kw = {"split": True} if kind == "split" else {}

        def new_fn():
            return new[kind](x, stack, **kw)

        def old_fn():
            return old[kind](x, stack, **kw)

        n = x.shape[0]
        row = {"shape": label, "old_tree": str(old_root), "N": n,
               "T": stack.shape[0],
               "state": str(x.dtype), "stack": str(stack.dtype),
               "new_path": fused_gossip.PATH_NAMES[
                   fused_gossip.kernel_path(stack.dtype, n,
                                            split=kind == "split")],
               "old_ms": [], "new_ms": [], "old_host_us": [],
               "new_host_us": []}
        new_out = new_fn()
        try:
            old_out = old_fn()
        except ValueError as e:  # the older tree's cap
            old_out, row["old"] = None, f"refused: {e}"
        torch.cuda.synchronize()
        sides = ("old", "new", "new", "old")
        if old_out is None:
            sides = ("new",)
        else:
            row["bitwise_equal"] = _same_bits(new_out, old_out)
            row["differ_share"] = float((new_out != old_out).float().mean())
            if not row["bitwise_equal"]:
                _emit({"phase": "fused_ab", **row})
                raise AssertionError(f"{label}: old and new outputs differ")
        del new_out, old_out
        fns = {"old": old_fn, "new": new_fn}
        for _ in range(rounds):
            for side in sides:
                row[f"{side}_ms"].append(time_ms(fns[side], flush))
                row[f"{side}_host_us"].append(host_us(fns[side]))
        for side in set(sides):
            row[f"{side}_median_ms"] = statistics.median(row[f"{side}_ms"])
            row[f"{side}_median_host_us"] = statistics.median(
                row[f"{side}_host_us"])
        if "old_median_ms" in row:
            row["old_over_new"] = row["old_median_ms"] / row["new_median_ms"]
        _emit({"phase": "fused_ab", **row})
        rows.append(row)
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m "
                                 "matcha_tpu_torch.probes.fused_bench")
    sub = ap.add_subparsers(dest="cmd", required=True)
    a = sub.add_parser("ab", help="an older tree's fused kernel against "
                                  "this one, in turns")
    a.add_argument("--old", required=True, nargs="+",
                   help="directories holding older (or one-change) "
                        "matcha_tpu_torch trees, each timed against this "
                        "one in turn")
    a.add_argument("--rounds", type=int, default=3)
    a.add_argument("--only", nargs="*", default=(),
                   help="time only the shapes whose label holds one of "
                        "these substrings")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("fused_bench needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    _emit({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    for i, root in enumerate(args.old):
        ab(root, args.rounds, tuple(args.only),
           alias=f"matcha_tpu_torch_old{i}")


if __name__ == "__main__":
    main()
