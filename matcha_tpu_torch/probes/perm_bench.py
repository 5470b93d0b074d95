"""The perm kernel (K1/K2) on the card: another tree's kernel against this
one.

    python -m matcha_tpu_torch.probes.perm_bench ab --old DIR [--rounds 3]

``ab`` loads the ``matcha_tpu_torch`` package found in ``DIR`` (an unpacked
``git archive`` of an earlier commit, or a copy of this tree with one
choice changed) under another name beside this one, builds both kernels,
and at each shape times them in turns (old, new, new, old; ``--rounds``
times) with CUDA events, the L2 cache flushed before each call.  The two
outputs must be bitwise equal: both kernels compute the plain version's
arithmetic.  A shape the old kernel refuses is timed on the new one alone.
Each side's host time per call (``perm_gossip_run`` from Python to the
launch, the card kept busy meanwhile) is measured beside it.

Shapes: the training slice's ``[16, 273258]`` f32 state (zoo graph 4, its
MATCHA schedule at budget 0.5) at T = 1 and 64; ``[256, 273258]`` on the
256-worker hypercube at T = 64; ``[4096, 273258]`` on the 4096-worker
hypercube at T = 1 (each hypercube matching active with probability 0.5).
Every result is one JSON line on stdout; the card's name and power limit
come first.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from ..parallel import involution_tables, perm_gossip
from ..schedule import fixed_schedule, matcha_schedule
from ..topology import decompose, hypercube_graph, select_graph

__all__ = ["host_us", "load_package", "main", "shapes", "time_ms"]

SEED = 9001
D = 273258


def load_package(root, alias: str = "matcha_tpu_torch_old"):
    """The ``matcha_tpu_torch`` package under ``root``, imported as
    ``alias`` (its imports are relative, so it runs beside this one)."""
    init = Path(root) / "matcha_tpu_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        alias, init, submodule_search_locations=[str(init.parent)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[alias] = module
    spec.loader.exec_module(module)
    return module


def shapes(dev, which=("slice T=1", "slice T=64", "hypercube N=256 T=64",
                       "hypercube N=4096 T=1")):
    """``(label, x, weights, perms, partnered)`` of each shape in
    ``which``, on ``dev``, at the slice's D."""
    out = []
    scheds = {}
    for label in which:
        kind, rest = label.split(" ", 1)
        t_steps = int(rest.rsplit("T=", 1)[1])
        if kind == "slice":
            n = 16
            key = (n, "slice")
            if key not in scheds:
                scheds[key] = matcha_schedule(select_graph(4), n, 64,
                                              budget=0.5, seed=SEED)
        else:
            n = int(rest.split()[0].split("=")[1])
            key = (n, "hypercube")
            if key not in scheds:
                scheds[key] = fixed_schedule(
                    decompose(hypercube_graph(n), n, seed=SEED), n, 64,
                    budget=0.5, mode="bernoulli", seed=SEED)
        sched = scheds[key]
        perms, partnered = involution_tables(sched.perms)
        g = torch.Generator(device=dev).manual_seed(SEED)
        x = torch.randn(n, D, generator=g, device=dev)
        w = torch.as_tensor(sched.alpha * sched.flags[:t_steps],
                            dtype=torch.float32, device=dev)
        out.append((label, x, w, torch.as_tensor(perms, device=dev),
                    torch.as_tensor(partnered, device=dev)))
    return out


def time_ms(fn, flush, runs: int = 20) -> float:
    """Median of ``runs`` calls, each timed with CUDA events after an L2
    flush and a spin that keeps the card busy while the host enqueues."""
    fn()
    times = []
    for _ in range(runs):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us(fn, calls: int = 20) -> float:
    """Host microseconds per call of ``fn``, ``calls`` calls enqueued in a
    row behind a spin that keeps the card busy until they are all in."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    start = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - start
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def _same_bits(a, b) -> bool:
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    return torch.equal(nan_a, nan_b) and torch.equal(
        a.masked_fill(nan_a, 0).view(torch.int32),
        b.masked_fill(nan_b, 0).view(torch.int32))


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def ab(old_root, rounds: int = 3) -> list:
    dev = torch.device("cuda")
    alias = load_package(old_root).__name__
    old = importlib.import_module(f"{alias}.parallel.perm_gossip")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rows = []
    for label, x, w, p, part in shapes(dev):
        def new_fn():
            return perm_gossip.perm_gossip_run(x, w, p, part)

        def old_fn():
            return old.perm_gossip_run(x, w, p, part)

        new_out = new_fn()
        try:
            old_out = old_fn()
        except ValueError as err:  # the old kernel's N limit
            old_out, refused = None, str(err)
        torch.cuda.synchronize()
        row = {"shape": label, "N": x.shape[0], "T": w.shape[0],
               "M": w.shape[1], "old_ms": [], "new_ms": [], "old_host_us": [],
               "new_host_us": []}
        if old_out is None:
            row["old_refused"] = refused
            for _ in range(rounds):
                row["new_ms"].append(time_ms(new_fn, flush))
                row["new_host_us"].append(host_us(new_fn))
        else:
            if not _same_bits(new_out, old_out):
                raise AssertionError(f"{label}: old and new kernels disagree")
            row["bitwise_equal"] = True
            for _ in range(rounds):
                for side, fn in (("old", old_fn), ("new", new_fn),
                                 ("new", new_fn), ("old", old_fn)):
                    row[f"{side}_ms"].append(time_ms(fn, flush))
                    row[f"{side}_host_us"].append(host_us(fn))
            row["old_median_ms"] = statistics.median(row["old_ms"])
            row["old_median_host_us"] = statistics.median(row["old_host_us"])
        row["new_median_ms"] = statistics.median(row["new_ms"])
        row["new_median_host_us"] = statistics.median(row["new_host_us"])
        _emit({"phase": "perm_ab", **row})
        rows.append(row)
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m "
                                 "matcha_tpu_torch.probes.perm_bench")
    sub = ap.add_subparsers(dest="cmd", required=True)
    a = sub.add_parser("ab", help="an older tree's perm kernel against "
                                  "this one, in turns")
    a.add_argument("--old", required=True,
                   help="directory holding the older matcha_tpu_torch")
    a.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("perm_bench needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    _emit({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    ab(args.old, args.rounds)


if __name__ == "__main__":
    main()
