#!/usr/bin/env python
"""Quickest proof that the PyTorch/CUDA port runs on the card.

    python3 chip_smoke.py

Needs one CUDA card.  Phases, each printed as a JSON line; any failure
raises and the script exits non-zero:

1. device — the card, CUDA and torch versions, and ``nvidia-smi``'s name
   and power limit (printed raw on a line of its own).
2. build — compiles the port's kernel source from ``matcha_tpu_torch/csrc``.
3. parity — each kernel against its plain PyTorch version on the card, at
   the shapes of the slice (N=16 workers, the M=8 matchings of zoo graph 4,
   D=273,258 ResNet-20 parameters, MATCHA weights): T in {1, 64},
   w_window in {1, 8}, dbuf on and off, f32 and bf16 wire, with and without
   a 0/1 alive mask; plus a bf16 state, a state holding a NaN and an inf,
   and N=256 on a hypercube at T=64.  Bitwise.
4. timing — kernel, plain version and the dense yardstick (T calls of
   ``torch.matmul(W_t, x)``, the JAX package's dense backend; the port
   never calls it), CUDA events, median of 20 runs with the L2 cache
   flushed before each; and the bound from the card's bandwidth and FP32
   peak.
5. slice — ``train()`` at full width: ResNet-20, 16 workers, graph 4,
   MATCHA budget 0.5, batch 32, perm backend, f32 wire, 2 epochs of 4
   steps.  Loss and disagreement finite; the kernel's launch count equals
   the training steps plus the comm-split timer's chains.  Then the step
   in steady state: host-clock ms per step and a ``torch.profiler`` split
   of its device time by part, with the card's idle share.  Then a small
   run on the card and on the CPU must agree.  Then the streamed-window
   instantiation, which ``train()`` does not take, runs one 64-step chain
   through ``perm_gossip_run(dbuf=False)``.
6. a ``{"kernels": [...]}`` summary line, then the ``nvidia-smi`` line.
7. last line: ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import torch

from matcha_tpu_torch import _kernels
from matcha_tpu_torch.communicator import make_decen
from matcha_tpu_torch.parallel import (
    LAUNCHES,
    involution_tables,
    perm_gossip_plain,
    perm_gossip_run,
    reset_launch_counts,
)
from matcha_tpu_torch.schedule import fixed_schedule, matcha_schedule
from matcha_tpu_torch.topology import (
    decompose,
    hypercube_graph,
    matching_laplacians,
    select_graph,
)
from matcha_tpu_torch.models import select_model
from matcha_tpu_torch.train import (
    TrainConfig,
    build_schedule,
    init_train_state,
    make_lr_schedule,
    make_optimizer,
    make_train_step,
    train,
)

# NVIDIA H100 SXM data sheet: HBM bandwidth and FP32 (non-tensor) peak
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

SEED = 9001
SLICE_D = 273258  # ResNet-20 parameters per worker
SOURCE = "matcha_tpu_torch/csrc/perm_gossip.cu"
KERNELS = {
    "perm_gossip_dbuf": {"dbuf": True,
                         "replaces": "matcha_tpu/parallel/pallas_gossip.py:340"},
    "perm_gossip_stream": {"dbuf": False,
                           "replaces": "matcha_tpu/parallel/pallas_gossip.py:281"},
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _tables(sched, dev):
    perms, partnered = involution_tables(sched.perms)
    return (sched, torch.as_tensor(perms, device=dev),
            torch.as_tensor(partnered, device=dev))


def slice_tables(dev):
    """Graph 4's tables and the slice's MATCHA schedule (budget 0.5), the
    tables placed on the card as ``make_decen`` places them."""
    return _tables(matcha_schedule(select_graph(4), 16, 64, budget=0.5,
                                   seed=SEED), dev)


def hypercube_tables(dev, n: int = 256):
    """A 256-worker hypercube, each matching active with probability 0.5
    (the fixed Bernoulli schedule: MATCHA's solver takes minutes of host
    time at this N and changes nothing the kernel sees but the weights)."""
    dec = decompose(hypercube_graph(n), n, seed=SEED)
    return _tables(fixed_schedule(dec, n, 64, budget=0.5, mode="bernoulli",
                                  seed=SEED), dev)


def state(n: int, d: int, dev) -> torch.Tensor:
    g = torch.Generator(device=dev).manual_seed(SEED)
    return torch.randn(n, d, generator=g, device=dev)


class L2Flush:
    """Writing 64 MB evicts the card's 50 MB L2 before a timed run, as the
    training step's forward/backward does for the gossip."""

    def __init__(self, dev):
        self.buf = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def __call__(self):
        self.buf.zero_()


def time_ms(fn, flush, runs: int = 20) -> float:
    """Median over ``runs`` of one call, timed with CUDA events.  A spin of
    about a millisecond on the card keeps it busy while the host enqueues
    the call, so the host's launch overhead does not count as card time
    (a call whose host side outlasts the spin still pays the rest)."""
    fn()
    times = []
    for _ in range(runs):
        flush()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, kernel: str, runs: int = 20):
    """Mean device time of ``kernel`` per call from ``torch.profiler``
    (launch gaps excluded), or None when the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "device_time_total", 0.0)
                for e in prof.key_averages() if kernel in e.key)
    return total / runs / 1e3 if total else None


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


def dense_yardstick(sched, weights, x):
    """``T`` calls of ``torch.matmul(W_t, x)``, ``W_t = I − Σ_j w[t,j]·L_j``
    (the JAX package's dense backend); the stack is built outside the
    timing."""
    lap = torch.as_tensor(matching_laplacians(sched.decomposed,
                                              sched.num_workers),
                          dtype=torch.float32, device=x.device)
    eye = torch.eye(sched.num_workers, device=x.device)
    stack = eye[None] - torch.einsum("tm,mnk->tnk", weights, lap)

    def run():
        out = x
        for t in range(stack.shape[0]):
            out = torch.matmul(stack[t], out)
        return out

    return run


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equality: the same NaN positions and the same bit patterns
    elsewhere (``torch.equal`` takes -0 for +0 and NaN for unequal)."""
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    as_int = torch.int32 if a.element_size() == 4 else torch.int16
    return (a.dtype == b.dtype and torch.equal(nan_a, nan_b) and torch.equal(
        a.masked_fill(nan_a, 0).view(as_int),
        b.masked_fill(nan_b, 0).view(as_int)))


def phase_parity(dev, tables, big_tables):
    """Each instantiation against the plain version, bitwise, at the
    slice's shapes; then a bf16 state, a state with a NaN and an inf, and
    N=256."""
    sched, perms, partnered = tables
    worst = {name: 0.0 for name in KERNELS}
    cases = 0

    def check(x, w, p, part, label, **kw):
        nonlocal cases
        ref = perm_gossip_plain(x, w, p, part, **kw)
        outs = []
        for name, spec in KERNELS.items():
            for w_window in (1, 8):
                out = perm_gossip_run(x, w, p, part, w_window=w_window,
                                      dbuf=spec["dbuf"], **kw)
                torch.cuda.synchronize()
                finite = torch.isfinite(ref)
                err = (out.float() - ref.float())[finite].abs().max().item()
                worst[name] = max(worst[name], err)
                if not same_bits(out, ref):
                    raise AssertionError(
                        f"{name} {label} w_window={w_window}: not bitwise "
                        f"equal to the plain version (max abs err {err})")
                outs.append(out)
                cases += 1
        if not all(same_bits(o, outs[0]) for o in outs):
            raise AssertionError(f"{label}: dbuf on and off disagree")

    x = state(16, SLICE_D, dev)
    alive = torch.ones(16, device=dev)
    alive[[3, 11]] = 0.0
    for t_steps in (1, 64):
        w = torch.as_tensor(sched.alpha * sched.flags[:t_steps],
                            dtype=torch.float32, device=dev)
        for wire in (None, "bf16"):
            for mask in (None, alive):
                check(x, w, perms, partnered,
                      f"T={t_steps} wire={wire} alive={mask is not None}",
                      alive=mask, wire_dtype=wire)
    check(x.to(torch.bfloat16), w, perms, partnered, "bf16 state T=64")
    bad = x.clone()
    bad[3, 100], bad[7, 500] = float("nan"), float("inf")
    check(bad, w, perms, partnered, "NaN/inf state T=64")
    big, bperms, bpart = big_tables
    wb = torch.as_tensor(big.alpha * big.flags, dtype=torch.float32,
                         device=dev)
    check(state(256, SLICE_D, dev), wb, bperms, bpart, "N=256 T=64")
    emit({"phase": "parity", "cases": cases, "bitwise": True,
          "max_abs_err": worst})
    return worst


def phase_timing(dev, tables, big_tables):
    flush = L2Flush(dev)
    sched, perms, partnered = tables
    big, bperms, bpart = big_tables
    shapes = [("slice T=1", sched, perms, partnered, 16, 1),
              ("slice T=64", sched, perms, partnered, 16, 64),
              ("hypercube N=256 T=64", big, bperms, bpart, 256, 64)]
    rows = []
    for label, sch, p, part, n, t_steps in shapes:
        x = state(n, SLICE_D, dev)
        w = torch.as_tensor(sch.alpha * sch.flags[:t_steps],
                            dtype=torch.float32, device=dev)
        row = {"shape": label, "N": n, "D": SLICE_D, "T": t_steps,
               "M": int(p.shape[0])}
        for name, spec in KERNELS.items():
            run = lambda: perm_gossip_run(x, w, p, part, dbuf=spec["dbuf"])
            row[f"{name}_ms"] = time_ms(run, flush)
            row[f"{name}_device_ms"] = device_ms(run, "perm_gossip_kernel")
        row["plain_ms"] = time_ms(
            lambda: perm_gossip_plain(x, w, p, part), flush)
        row["library_ms"] = time_ms(dense_yardstick(sch, w, x), flush)
        row["bound_ms"], row["bound_by"] = bound(x, w, p, part)
        rows.append(row)
        emit({"phase": "timing", **row})
        del x
    return rows


def timer_chains(steps_per_epoch: int, sample_steps: int = 32) -> int:
    """Chains the comm-split timer runs per epoch (train/loop.py): one
    warm-up and one timed run of each window it times — the whole epoch
    when it has at most 2k steps, else windows k and 2k."""
    k = min(sample_steps, max(steps_per_epoch // 2, 1))
    return 2 if steps_per_epoch <= 2 * k else 4


def slice_config(epochs: int) -> TrainConfig:
    return TrainConfig(model="resnet20", dataset="synthetic_image",
                       num_workers=16, graphid=4, matcha=True, budget=0.5,
                       batch_size=32, gossip_backend="perm", wire_dtype="f32",
                       epochs=epochs, seed=SEED,
                       dataset_kwargs={"num_train": 2048, "num_test": 512})


def phase_slice(dev):
    epochs = 2
    cfg = slice_config(epochs)
    reset_launch_counts()
    result = train(cfg, device=dev)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    hist = result.history
    bpe = 2048 // 16 // 32
    expected = epochs * bpe + epochs * timer_chains(bpe)
    for h in hist:
        for key in ("loss", "disagreement", "test_loss_mean"):
            if not math.isfinite(h[key]):
                raise AssertionError(f"epoch {h['epoch']}: {key} = {h[key]}")
    if launches["perm_gossip_dbuf"] != expected:
        raise AssertionError(f"perm_gossip_dbuf launched "
                             f"{launches['perm_gossip_dbuf']} times, "
                             f"expected {expected} (steps + timer chains)")
    flat = torch.cat([p.detach().reshape(16, -1) for p in
                      result.state.model.parameters()], dim=1)
    if flat.shape != (16, SLICE_D) or not bool(torch.isfinite(flat).all()):
        raise AssertionError(f"final parameters {tuple(flat.shape)} not "
                             f"finite [16, {SLICE_D}]")
    steady = hist[-1]
    emit({"phase": "slice", "model": "resnet20", "workers": 16, "graphid": 4,
          "budget": 0.5, "batch": 32, "steps_per_epoch": bpe,
          "launches": launches, "expected_launches": expected,
          "ms_per_step": [h["epoch_time"] / bpe * 1e3 for h in hist],
          "images_per_s": [16 * 32 * bpe / h["epoch_time"] for h in hist],
          "comm_ms_per_step": [h["comm_time"] / bpe * 1e3 for h in hist],
          "loss": [h["loss"] for h in hist],
          "disagreement": [h["disagreement"] for h in hist],
          "test_acc_mean": steady["test_acc_mean"],
          "alpha": float(result.schedule.alpha)})
    return launches


# kernel-name fragments of each part of the training step, checked in order
STEP_PARTS = (
    ("gossip (perm kernel)", ("perm_gossip",)),
    ("convolution", ("conv", "cudnn", "xmma", "gemm", "winograd", "fft")),
    ("batch norm", ("batch_norm", "bn_")),
    ("SGD", ("multi_tensor_apply", "foreach")),
)


def phase_profile(dev, steps: int = 20, profiled: int = 5):
    """The slice's training step in steady state, outside ``train()``'s
    epoch bookkeeping: ``steps`` steps on the host clock after 3 warm-up
    steps, then ``profiled`` steps under ``torch.profiler``, whose kernels
    are summed by part of the step.  One seeded batch on the card stands in
    for the loader.  The card's idle share is 1 − (union of the kernels'
    intervals) / wall time of the profiled steps."""
    from torch.profiler import ProfilerActivity, profile

    cfg = slice_config(1)
    sched = build_schedule(cfg, 3 + steps + profiled)
    comm = make_decen(sched, "perm", device=dev)
    opt = make_optimizer(make_lr_schedule(cfg.lr, 4))
    model = select_model("resnet20", "synthetic_image", num_workers=16)
    state, flattener = init_train_state(model, 16, opt, comm, seed=SEED,
                                        device=dev)
    step = make_train_step(opt, comm, flattener, sched.flags)
    g = torch.Generator(device=dev).manual_seed(SEED)
    xb = torch.randn(16, 32, 32, 32, 3, generator=g, device=dev)
    yb = torch.randint(0, 10, (16, 32), generator=g, device=dev)
    for _ in range(3):
        state, _ = step(state, xb, yb)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, _ = step(state, xb, yb)
    torch.cuda.synchronize()
    ms_per_step = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(profiled):
            state, _ = step(state, xb, yb)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_kernel, parts = {}, {}
    for e in kernels:
        ms = e.time_range.elapsed_us() / 1e3
        by_kernel[e.name] = by_kernel.get(e.name, 0.0) + ms
        part = next((label for label, keys in STEP_PARTS
                     if any(k in e.name.lower() for k in keys)), "other")
        parts[part] = parts.get(part, 0.0) + ms / profiled
    # busy time is the union of the kernels' intervals: cuDNN may run
    # kernels on more than one stream at once
    busy_us, reach = 0.0, float("-inf")
    for start, end in sorted((e.time_range.start, e.time_range.end)
                             for e in kernels):
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    busy_ms = busy_us / 1e3 / profiled
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    emit({"phase": "profile", "steps": steps, "ms_per_step": ms_per_step,
          "images_per_s": 16 * 32 / ms_per_step * 1e3,
          "profiled_ms_per_step": wall_ms / profiled,
          "device_busy_ms_per_step": busy_ms,
          "device_idle_share": 1.0 - busy_ms * profiled / wall_ms,
          "kernel_ms_per_step_by_part": parts,
          "kernels_launched_per_step": len(kernels) / profiled,
          "top_kernels_ms_per_step": [[name[:80], ms / profiled]
                                      for name, ms in top]})


def phase_agreement(dev):
    """A small run on the card against the same run on the CPU (the CPU
    path is held against the JAX package by the repo's tests): cuDNN and
    the CPU sum in other orders, so the tolerance is 1e-4 relative."""
    cfg = TrainConfig(model="resnet8", dataset="synthetic_image",
                      num_workers=8, graphid=0, batch_size=4, epochs=1,
                      gossip_backend="perm", seed=SEED,
                      dataset_kwargs={"num_train": 64, "num_test": 32})
    gpu = train(cfg, device=dev).history[0]
    cpu = train(cfg, device="cpu").history[0]
    worst = 0.0
    for key in ("loss", "disagreement", "test_loss_mean"):
        rel = abs(gpu[key] - cpu[key]) / max(abs(cpu[key]), 1e-12)
        worst = max(worst, rel)
        if rel > 1e-4:
            raise AssertionError(f"card vs CPU {key}: {gpu[key]} vs "
                                 f"{cpu[key]}")
    emit({"phase": "agreement", "max_rel_err": worst})


def phase_stream_chain(dev, tables):
    """The streamed-window instantiation, which no entry point of the port
    takes (``dbuf=True`` is the default, as in the JAX package): one chain
    of 64 steps at the slice's width through ``perm_gossip_run``, against
    the slice's communicator chain (the prefetching instantiation)."""
    sched, perms, partnered = tables
    flags = sched.flags[:64]
    x = state(16, SLICE_D, dev)
    w = torch.as_tensor(sched.alpha * flags, dtype=torch.float32,
                        device=dev)
    reset_launch_counts()
    out = perm_gossip_run(x, w, perms, partnered, dbuf=False)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    if launches["perm_gossip_stream"] != 1 or launches["perm_gossip_dbuf"]:
        raise AssertionError(f"stream chain launches {launches}")
    ref, _ = make_decen(sched, "perm", device=dev).run(x, flags)
    if not same_bits(out, ref):
        raise AssertionError("stream and dbuf chains disagree")
    emit({"phase": "stream_chain", "T": 64, "launches": launches})
    return launches


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA card; torch.cuda.is_available() "
                 "is False")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "cuda": torch.version.cuda,
          "torch": torch.__version__, "nvidia_smi": smi})

    t0 = time.perf_counter()
    report = _kernels.build("perm_gossip")
    ptxas = [line.strip() for line in report["ptxas"].splitlines()
             if "registers" in line or "spill" in line]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "source": SOURCE, "cached": report["cached"], "ptxas": ptxas[:16]})

    tables, big_tables = slice_tables(dev), hypercube_tables(dev)
    worst = phase_parity(dev, tables, big_tables)
    timings = phase_timing(dev, tables, big_tables)
    slice_launches = phase_slice(dev)
    phase_profile(dev)
    phase_agreement(dev)
    stream_launches = phase_stream_chain(dev, tables)

    main_shape = {"perm_gossip_dbuf": timings[0],    # T=1, the training mix
                  "perm_gossip_stream": timings[1]}  # T=64, the chain path
    kernels = []
    for name, spec in KERNELS.items():
        row = main_shape[name]
        launches = (slice_launches if name == "perm_gossip_dbuf"
                    else stream_launches)[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": spec["replaces"], "launches": launches,
            "bitwise": True, "max_abs_err": worst[name],
            "shape": row["shape"], "ms": row[f"{name}_ms"],
            "kernel_ms": row[f"{name}_ms"],
            "device_ms": row[f"{name}_device_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "timings": [{"shape": r["shape"], "ms": r[f"{name}_ms"],
                         "device_ms": r[f"{name}_device_ms"],
                         "plain_ms": r["plain_ms"],
                         "library_ms": r["library_ms"],
                         "bound_ms": r["bound_ms"],
                         "bound_by": r["bound_by"]} for r in timings],
        })
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
