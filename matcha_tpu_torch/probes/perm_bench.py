"""The perm kernel (K1/K2) on the card: another tree's kernel against this
one, and the band path's shapes against each other.

    python -m matcha_tpu_torch.probes.perm_bench ab --old DIR [--rounds 3]
        [--only SUBSTRING ...]
    python -m matcha_tpu_torch.probes.perm_bench bands [--only ...]
    python -m matcha_tpu_torch.probes.perm_bench library [--only ...]

``ab`` loads the ``matcha_tpu_torch`` package found in ``DIR`` (an unpacked
``git archive`` of an earlier commit, or a copy of this tree with one
choice changed) under another name beside this one, builds both kernels,
and at each shape times them in turns (old, new, new, old; ``--rounds``
times) with CUDA events, the L2 cache flushed before each call.  Where both
of this tree's paths take a shape (the slab kernel and the band path), each
is also timed forced, in the same turns.  Every output must be bitwise
equal to every other: all compute the plain version's arithmetic.  A shape
the old kernel refuses is timed on the new one alone.  Each side's host
time per call (``perm_gossip_run`` from Python to the launch, the card kept
busy meanwhile) and device time per call (``torch.profiler``, the kernels
of the perm source) are measured beside it, and the bytes the band path
gathers through L2 at the shape are counted (``gathered_bytes``).

``bands`` times the band path at each shape for ``band_shape``'s width,
half of it and twice it (over the L2 budget), every output bitwise equal
to the chosen shape's.

``library`` times the kernel and the library call (``T`` calls of
``torch.matmul(W_t, x)``, ``perm_yardstick``) and computes the bound
(``bound``, the rule of ``chip_smoke.py``'s kernels line) at
``LIBRARY_SHAPES``: the 8192-worker torus at T = 1 and 8, the
16,384-worker hypercube at full width, T = 4, and chain (d)'s
4096-worker hypercube at full width, T = 64 (64 products of
``[4096, 4096]`` by ``[4096, 273258]`` a call: about a minute).

Shapes: the training slice's ``[16, 273258]`` f32 state (zoo graph 4, its
MATCHA schedule at budget 0.5) at T = 1 and 64; ``[256, 273258]`` on the
256-worker hypercube at T = 64; ``[4096, 273258]`` on the 4096-worker
hypercube at T = 1, 2, 4, 8 and 64 (chain (d)); the 8192-worker 2-D torus
(5 matchings) at T = 1 and 8; chain (d) and the torus at T = 1 also with a
bf16 state and with an f32 state on a bf16 wire; a 4096-worker Erdős–Rényi
graph of mean degree 30 (54 matchings) at full width, T = 1 and 4; the
16,384-worker hypercube at D = 32,768, T = 1 and 4 (each matching active
with probability 0.5).  Every result is one JSON line on stdout; the card's
name and power limit come first.  Needs a CUDA card.
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

from ..obs.costs import H100
from ..parallel import involution_tables, perm_gossip
from ..schedule import fixed_schedule, matcha_schedule
from ..topology import (decompose, erdos_renyi_graph, hypercube_graph,
                        make_graph, select_graph)

__all__ = ["FP32_OPS_PER_S", "HBM_BYTES_PER_S", "bands", "bound",
           "device_ms", "gathered_bytes", "host_us", "library",
           "load_package", "main", "perm_yardstick", "shapes", "time_ms"]

# the H100's HBM bandwidth and FP32 (non-tensor) peak, from the port's one
# chip table (obs/costs.py: the NVIDIA H100 SXM data sheet)
HBM_BYTES_PER_S = H100.peak_gbps * 1e9
FP32_OPS_PER_S = H100.peak_tflops_fp32 * 1e12
SEED = 9001
D = 273258
SHAPES = ("slice T=1", "slice T=64", "hypercube N=256 T=64",
          "hypercube N=4096 T=1", "hypercube N=4096 T=2",
          "hypercube N=4096 T=4", "hypercube N=4096 T=8",
          "hypercube N=4096 T=64", "hypercube N=4096 T=1 state=bf16",
          "hypercube N=4096 T=1 wire=bf16", "torus N=8192 T=1",
          "torus N=8192 T=8", "torus N=8192 T=1 state=bf16",
          "torus N=8192 T=1 wire=bf16", "ER N=4096 T=1", "ER N=4096 T=4",
          "hypercube N=16384 D=32768 T=1",
          "hypercube N=16384 D=32768 T=4")
# the K1 rows of PERF.md's table that lacked a bound or a library time
LIBRARY_SHAPES = ("torus N=8192 T=1", "torus N=8192 T=8",
                  "hypercube N=16384 T=4", "hypercube N=4096 T=64")
BAND_SHAPES = ("hypercube N=4096 T=1", "ER N=4096 T=1", "ER N=4096 T=4",
               "hypercube N=16384 D=32768 T=1",
               "hypercube N=16384 D=32768 T=4")


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


def _schedule(kind: str, n: int):
    if kind == "slice":
        return matcha_schedule(select_graph(4), n, 64, budget=0.5, seed=SEED)
    edges = {"hypercube": hypercube_graph,
             "torus": lambda n: make_graph("torus", n),
             "ER": lambda n: erdos_renyi_graph(n, 30.0 / (n - 1), seed=SEED)
             }[kind](n)
    return fixed_schedule(decompose(edges, n, seed=SEED), n, 64, budget=0.5,
                          mode="bernoulli", seed=SEED)


def shapes(dev, which=SHAPES):
    """Yield ``(label, x, weights, perms, partnered, wire)`` of each shape
    in ``which`` (``"<slice|hypercube|torus|ER> [N=n] [D=d] T=t
    [state=bf16] [wire=bf16]"``; N = 16 for the slice, D = 273,258, an f32
    state and no wire cast unless given), on ``dev``."""
    scheds = {}
    for label in which:
        kind, *fields = label.split()
        spec = dict(f.split("=") for f in fields)
        n = int(spec.get("N", 16))
        d = int(spec.get("D", D))
        if (kind, n) not in scheds:
            scheds[kind, n] = _schedule(kind, n)
        sched = scheds[kind, n]
        perms, partnered = involution_tables(sched.perms)
        g = torch.Generator(device=dev).manual_seed(SEED)
        x = torch.randn(n, d, generator=g, device=dev)
        if spec.get("state") == "bf16":
            x = x.to(torch.bfloat16)
        w = torch.as_tensor(sched.alpha * sched.flags[:int(spec["T"])],
                            dtype=torch.float32, device=dev)
        yield (label, x, w, torch.as_tensor(perms, device=dev),
               torch.as_tensor(partnered, device=dev), spec.get("wire"))


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


def device_ms(fn, flush, steps: int, runs: int = 5):
    """Device milliseconds per call of ``fn`` from ``torch.profiler``: the
    mean time of each perm kernel over the launches the trace recorded (it
    can drop records), times its launches a call (``steps`` for an older
    tree's per-step kernel, else one), the L2 flushed before each call;
    None when the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        spent = getattr(e, "device_time_total", 0.0)
        if spent and e.count and ("perm_" in e.key or "tame_scan" in e.key):
            total += spent / e.count * (steps if "perm_step" in e.key else 1)
    return total / 1e3 if total else None


def gathered_bytes(x, weights, partnered) -> int:
    """Bytes one band-path call gathers through L2, counted from the
    schedule: each step reads every row once, writes it once and reads one
    partner row for each active partnered term (nonzero weight and gate);
    from T = 2 the copy of x into a band buffer adds a read and a write of
    every row."""
    n, d = x.shape
    steps = weights.shape[0]
    terms = sum(int(partnered[w != 0].sum()) for w in weights)
    rows = 2 * n * steps + terms + (2 * n if steps > 1 else 0)
    return rows * d * x.element_size()


def bound(x, weights, perms, gate):
    """The least time the card could take: bytes moved (state read once and
    written once, weights and tables read once) over the HBM rate, and the
    operations these inputs need (per active matching and gated slot: one
    subtract, one multiply and one add per column; one add per updated row
    and column) over the FP32 peak.  Returns (ms, "bytes"|"operations")."""
    n, d = x.shape
    t_steps, m = weights.shape
    nbytes = 2 * n * d * x.element_size() + weights.numel() * 4 \
        + perms.numel() * 4 + gate.numel() * 4
    w = weights.detach().cpu().numpy()
    g = gate.detach().cpu().numpy() != 0
    ops = 0
    for t in range(t_steps):
        active = w[t] != 0
        ops += 3 * int(g[active].sum()) * d
        ops += int(g[active].any(axis=0).sum()) * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def perm_yardstick(weights, perms, gate, x):
    """``T`` calls of ``torch.matmul(W_t, x)`` with ``W_t = I − Σ_j
    w[t,j]·L_j`` built on the card from the tables (the Laplacians of
    16,384 workers would not fit the host as dense matrices); the stack is
    built outside the timing."""
    t_steps, m = weights.shape
    n = perms.shape[1]
    rows = torch.arange(n, device=x.device)
    stack = torch.zeros(t_steps, n, n, device=x.device)
    for t in range(t_steps):
        coef = weights[t][:, None] * gate  # [M, N]; zero where unpartnered
        stack[t].index_put_((rows.repeat(m), perms.long().reshape(-1)),
                            coef.reshape(-1), accumulate=True)
        stack[t][rows, rows] += 1.0 - coef.sum(0)

    def run():
        out = x
        for t in range(t_steps):
            out = torch.matmul(stack[t], out)
        return out

    return run


def _same_bits(a, b) -> bool:
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    as_int = torch.int32 if a.element_size() == 4 else torch.int16
    return a.dtype == b.dtype and torch.equal(nan_a, nan_b) and torch.equal(
        a.masked_fill(nan_a, 0).view(as_int),
        b.masked_fill(nan_b, 0).view(as_int))


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _forced(x, w, p, part, shape, wire_dtype=None):
    """This tree's kernel on ``shape`` (a slab ``LaunchShape`` or a
    ``BandShape``), whatever the launch rule picks."""
    wt, pt, gate, w_window, block_d, wire = perm_gossip._prepare(
        x, w, p, part, None, 2048, 1, wire_dtype)
    return perm_gossip._launch(x, wt, pt, gate, w_window, block_d, wire,
                               True, shape=shape)


def _runs(fn, flush) -> tuple:
    """(event runs, host calls) for a call of ``fn``: 20 each where a call
    takes under 20 ms, else 5."""
    return (20, 20) if time_ms(fn, flush, runs=1) < 20.0 else (5, 5)


def _only(labels, only):
    return [s for s in labels if not only or any(o in s for o in only)]


def ab(old_root, rounds: int = 3, only=()) -> list:
    dev = torch.device("cuda")
    alias = load_package(old_root).__name__
    old = importlib.import_module(f"{alias}.parallel.perm_gossip")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    lib = perm_gossip._library()
    rows = []
    for label, x, w, p, part, wire in shapes(dev, _only(SHAPES, only)):
        sides = {"new": lambda: perm_gossip.perm_gossip_run(
                     x, w, p, part, wire_dtype=wire),
                 "old": lambda: old.perm_gossip_run(
                     x, w, p, part, wire_dtype=wire)}
        n, m = p.shape[1], p.shape[0]
        slab = perm_gossip._slab_shape(lib, n, m, 1, 2048, wire is not None)
        if slab is not None:
            band = perm_gossip.band_shape(n, x.element_size())
            sides["slab"] = lambda: _forced(x, w, p, part, slab, wire)
            sides["band"] = lambda: _forced(x, w, p, part, band, wire)
        outs, refused = {}, None
        for side, fn in sides.items():
            try:
                outs[side] = fn()
            except (ValueError, RuntimeError) as err:  # the old kernel's cap
                if side != "old":
                    raise
                refused = str(err)
        torch.cuda.synchronize()
        ref = outs["new"]
        for side, out in outs.items():
            if not _same_bits(out, ref):
                raise AssertionError(f"{label}: {side} and new disagree")
        del outs
        row = {"shape": label, "N": n, "D": x.shape[1], "T": w.shape[0],
               "M": m, "state": str(x.dtype), "wire": wire,
               "bitwise_equal": True,
               "gathered_bytes": gathered_bytes(x, w, part),
               "new_path": type(perm_gossip._launch_shape(
                   lib, n, m, 1, 2048, wire is not None, x.element_size(),
                   w.shape[0])).__name__}
        timed = list(sides)
        if refused is not None:
            row["old_refused"] = refused
            timed.remove("old")
        runs, calls = _runs(sides["new"], flush)
        order = timed + timed[::-1]
        for side in timed:
            row[f"{side}_ms"], row[f"{side}_host_us"] = [], []
        for _ in range(rounds):
            for side in order:
                row[f"{side}_ms"].append(time_ms(sides[side], flush, runs))
                row[f"{side}_host_us"].append(host_us(sides[side], calls))
        for side in timed:
            row[f"{side}_median_ms"] = statistics.median(row[f"{side}_ms"])
            row[f"{side}_median_host_us"] = statistics.median(
                row[f"{side}_host_us"])
            row[f"{side}_device_ms"] = device_ms(sides[side], flush,
                                                 w.shape[0])
        row["runs"] = runs
        _emit({"phase": "perm_ab", **row})
        rows.append(row)
        del x, w, ref
        torch.cuda.empty_cache()
    return rows


def _candidates(n: int, state_bytes: int) -> list:
    """Band shapes around ``band_shape``'s choice: its width, twice it
    (over the L2 budget) and half of it, at least one lane's 16 bytes."""
    (cols,) = perm_gossip.band_shape(n, state_bytes)
    lane = 16 // state_bytes
    return [perm_gossip.BandShape(c) for c in (cols * 2, cols, cols // 2)
            if c >= lane]


def bands(only=()) -> list:
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rows = []
    for label, x, w, p, part, _ in shapes(dev, _only(BAND_SHAPES, only)):
        n = p.shape[1]
        chosen = perm_gossip.band_shape(n, x.element_size())
        ref = _forced(x, w, p, part, chosen)
        for shape in _candidates(n, x.element_size()):
            fn = lambda: _forced(x, w, p, part, shape)  # noqa: E731
            if not _same_bits(fn(), ref):
                raise AssertionError(f"{label} {shape}: not bitwise equal "
                                     f"to {chosen}")
            runs, _ = _runs(fn, flush)
            row = {"shape": label, "N": n, "D": x.shape[1], "T": w.shape[0],
                   "M": p.shape[0], "cols": shape.cols,
                   "gathered_bytes": gathered_bytes(x, w, part),
                   "chosen": shape == chosen,
                   "l2_bytes": 2 * n * shape.cols * x.element_size(),
                   "ms": time_ms(fn, flush, runs),
                   "device_ms": device_ms(fn, flush, w.shape[0]),
                   "runs": runs}
            _emit({"phase": "perm_bands", **row})
            rows.append(row)
        del x, w, ref
        torch.cuda.empty_cache()
    return rows


def library(only=()) -> list:
    """At each of ``LIBRARY_SHAPES``: the kernel (``perm_gossip_run``), the
    library call (``perm_yardstick``: ``T`` calls of ``torch.matmul``, TF32
    off) and the bound, median of 3 calls each, the L2 flushed before
    each."""
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rows = []
    for label, x, w, p, part, _ in shapes(dev, _only(LIBRARY_SHAPES, only)):
        row = {"shape": label, "N": p.shape[1], "D": x.shape[1],
               "T": w.shape[0], "M": p.shape[0]}
        row["bound_ms"], row["bound_by"] = bound(x, w, p, part)
        row["ms"] = time_ms(lambda: perm_gossip.perm_gossip_run(x, w, p, part),
                            flush, runs=3)
        torch.cuda.empty_cache()
        row["library_ms"] = time_ms(perm_yardstick(w, p, part, x), flush,
                                    runs=3)
        _emit({"phase": "perm_library", **row})
        rows.append(row)
        del x, w
        torch.cuda.empty_cache()
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
    a.add_argument("--only", nargs="*", default=(),
                   help="keep the shapes whose label holds one of these")
    b = sub.add_parser("bands", help="the band path's widths against each "
                                     "other")
    b.add_argument("--only", nargs="*", default=())
    c = sub.add_parser("library", help="the kernel, the library call and "
                                       "the bound at LIBRARY_SHAPES")
    c.add_argument("--only", nargs="*", default=())
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("perm_bench needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    _emit({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    if args.cmd == "ab":
        ab(args.old, args.rounds, args.only)
    elif args.cmd == "library":
        library(args.only)
    else:
        bands(args.only)


if __name__ == "__main__":
    main()
