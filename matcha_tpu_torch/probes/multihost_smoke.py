"""The worker mesh across processes: one SPMD program that every process
runs, the counterpart of the JAX package's ``tests/_multihost_child.py``.

    python -m matcha_tpu_torch.probes.multihost_smoke COORD NPROCS RANK \\
        --out DIR [--profile tiny|full] [--device cpu|cuda] [--cards K] \\
        [--backend gloo|nccl] [--save-rows]
    python -m torch.distributed.run --nproc-per-node=4 \\
        -m matcha_tpu_torch.probes.multihost_smoke --out DIR --device cuda

Each process joins the group (``parallel.multihost.initialize_multihost``,
with the three positional arguments or torchrun's environment), builds
``global_worker_mesh()`` (``--cards`` CPU cards a process on the CPU, one
card a process on CUDA), and runs every scenario of its profile on the
same seeded inputs, each process holding its own cards' rows:

* ``shard_map``, ``skip`` (one step all inactive), ``alive`` (a survivor
  mask) and ``bf16_wire``: the folded decen chain, blocks exchanged by
  batched send/recv;
* ``perm`` (a step and a chain) and ``fused`` (a chain): the one-tensor
  backends, the state gathered onto the first card's process;
* ``choco`` (a step and a 4-step run; ``choco_random_k`` a run) on the
  folded CHOCO backend, its compressed messages sent between processes;
* ``centralized``: the mean, and the masked mean, from per-card partials;
* ``schedule_digest``: a process with another flag stream, which
  ``make_decen`` must refuse at build on every process;
* ``train``: ``train()`` under the group, which must refuse.

It writes ``DIR/rank{r}.json`` (the mesh, the seconds from ``--spawned-at``
to the initialized group, each scenario's timings, the bytes this process
sent, the kernels' launches, the refusals' messages) and with
``--save-rows`` ``DIR/rank{r}.npz`` (its cards' rows of every result, by
``case/scenario/name``, with ``cards``).  The first process then gathers
every result, runs each scenario again in one process over the same
cards (``one_process_mesh``) and writes ``DIR/check.json``, every result
held bitwise to that run (and ``perm``/``fused`` to the one-card call); a
mismatch exits non-zero.  The profiles: ``tiny`` (``[8, 37]`` on
zoo graph 5 and ``[16, 64]`` on zoo graph 4, fixed Bernoulli schedules)
for the tests on the CPU; ``full`` (slice (a)'s gossip at ``[16,
273258]``, chain (b) at ``[256, 273258]`` bf16, CHOCO at cell (g)'s
``[64, 273258]``) for the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..communicator import make_centralized, make_choco, make_decen
from ..parallel import (
    LAUNCHES,
    gather_workers,
    reset_launch_counts,
    shard_workers,
    worker_mesh,
)
from ..parallel import multihost
from ..schedule import fixed_schedule, matcha_schedule
from ..topology import decompose, hypercube_graph, select_graph

__all__ = ["FULL", "TINY", "Case", "case_alive", "case_schedule",
           "case_state", "main", "one_process_mesh", "run_case",
           "skip_flags", "spawn", "wait_all"]

SEED = 9001
SLICE_D = 273258


@dataclasses.dataclass(frozen=True)
class Case:
    """One shape and schedule, and the scenarios run on it."""

    label: str
    workers: int
    dim: int
    steps: int
    graph: str  # "zoo4", "zoo5", "hypercube" or "er" (cell (g)'s)
    matcha: bool  # MATCHA's activation probabilities, else Bernoulli 0.5
    state_dtype: str  # "f32" or "bf16"
    scenarios: tuple
    choco_ratio: float = 0.5
    consensus_lr: float = 0.3
    seed: int = 0


_TINY_SCENARIOS = ("shard_map", "skip", "alive", "bf16_wire", "perm",
                   "fused", "choco", "choco_random_k", "centralized")
TINY = (Case("8x37", 8, 37, 4, "zoo5", False, "f32", _TINY_SCENARIOS,
             seed=1),
        Case("16x64", 16, 64, 4, "zoo4", False, "f32", _TINY_SCENARIOS,
             seed=2))
FULL = (Case("slice", 16, SLICE_D, 8, "zoo4", True, "f32",
             ("shard_map", "skip", "alive", "bf16_wire", "perm",
              "centralized"), seed=SEED),
        Case("chain_b", 256, SLICE_D, 64, "hypercube", False, "bf16",
             ("shard_map", "fused"), seed=SEED),
        Case("choco_g", 64, SLICE_D, 4, "er", True, "f32", ("choco",),
             choco_ratio=0.9, consensus_lr=0.1, seed=SEED))
PROFILES = {"tiny": TINY, "full": FULL}


def case_schedule(case: Case):
    """The case's schedule, the same in every process."""
    if case.graph == "er":
        # cell (g): BASELINE.json config 4's generated Erdős–Rényi graph
        from ..train import TrainConfig, build_schedule

        return build_schedule(TrainConfig(
            model="resnet20", dataset="synthetic_image",
            num_workers=case.workers, graphid=None, topology="erdos_renyi",
            matcha=True, budget=0.5, communicator="choco",
            compress_ratio=case.choco_ratio, seed=case.seed), 17)
    if case.graph == "hypercube":
        dec = decompose(hypercube_graph(case.workers), case.workers,
                        seed=case.seed)
    else:
        dec = select_graph(int(case.graph[3:]))
    if case.matcha:
        return matcha_schedule(dec, case.workers, 64, budget=0.5,
                               seed=case.seed)
    return fixed_schedule(dec, case.workers, max(case.steps, 8),
                          budget=0.5, mode="bernoulli", seed=case.seed)


def case_state(case: Case, device) -> torch.Tensor:
    """The ``[N, D]`` state: numpy normal draws on the CPU (what the tests
    feed the JAX package too), a ``torch.Generator``'s on a card."""
    device = torch.device(device)
    if device.type == "cpu":
        x = torch.from_numpy(np.random.default_rng(case.seed).normal(
            size=(case.workers, case.dim)).astype(np.float32))
    else:
        gen = torch.Generator(device=device).manual_seed(case.seed)
        x = torch.randn(case.workers, case.dim, generator=gen,
                        device=device)
    return x.to(torch.bfloat16) if case.state_dtype == "bf16" else x


def case_alive(case: Case) -> torch.Tensor:
    """The survivor mask: workers 1 and N − 3 dead."""
    alive = torch.ones(case.workers)
    alive[[1, case.workers - 3]] = 0.0
    return alive


def skip_flags(flags) -> np.ndarray:
    """The first rows of a flag stream with step 1 all inactive."""
    flags = np.asarray(flags, np.float32).copy()
    flags[1] = 0.0
    return flags


def _row(flags, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(flags[0], np.float32), device=device)


def run_case(mesh, case: Case, sched=None, names=None) -> dict:
    """``{scenario: {name: WorkerBlocks}}`` of ``case`` on ``mesh`` (a
    mesh of one process or of several): each scenario on the state folded
    afresh.  ``names``: a subset of the case's scenarios."""
    sched = case_schedule(case) if sched is None else sched
    home = mesh.home
    x = case_state(case, home)
    flags = np.asarray(sched.flags[:case.steps], np.float32)
    alive = case_alive(case)
    out = {}
    for name in names or case.scenarios:
        xs = shard_workers(x, mesh)
        if name in ("shard_map", "skip", "alive", "bf16_wire"):
            comm = make_decen(sched, "skip" if name == "skip" else
                              "shard_map", mesh=mesh,
                              wire_dtype="bf16" if name == "bf16_wire"
                              else None)
            got, _ = comm.run(xs, skip_flags(flags) if name == "skip"
                              else flags,
                              alive=alive if name == "alive" else None)
            out[name] = {"x": got}
        elif name == "perm":
            comm = make_decen(sched, "perm", mesh=mesh)
            out[name] = {"step": comm.step(xs, (), _row(flags, home))[0],
                         "run": comm.run(xs, flags)[0]}
        elif name == "fused":
            comm = make_decen(sched, "fused", mesh=mesh,
                              compute_dtype=torch.bfloat16)
            out[name] = {"run": comm.run(xs, flags)[0]}
        elif name in ("choco", "choco_random_k"):
            comm = make_choco(
                sched, ratio=case.choco_ratio,
                consensus_lr=case.consensus_lr, backend="shard_map",
                mesh=mesh, seed=4, compressor="random_k"
                if name == "choco_random_k" else "top_k")
            got = {}
            if name == "choco":
                step, carry = comm.step(xs, comm.init(xs),
                                        torch.as_tensor(flags[0]))
                got.update(step_x=step, step_x_hat=carry["x_hat"],
                           step_s=carry["s"])
            run, carry = comm.run(xs, flags[:4])
            got.update(run_x=run, run_x_hat=carry["x_hat"],
                       run_s=carry["s"])
            out[name] = got
        elif name == "centralized":
            comm = make_centralized()
            row = torch.as_tensor(flags[0])
            out[name] = {"mean": comm.step(xs, (), row)[0],
                         "masked": comm.step(xs, (), row, alive)[0]}
        else:
            raise KeyError(f"unknown scenario {name!r}")
    return out


def one_process_mesh(mesh):
    """The same cards in one process: what the cross-process run is held
    to."""
    return worker_mesh(devices=[str(d) for d in mesh.devices])


def _one_card_reference(case: Case, sched, name: str, device) -> dict:
    """``perm`` and ``fused`` as the one-card communicator computes them."""
    x = case_state(case, device)
    flags = np.asarray(sched.flags[:case.steps], np.float32)
    if name == "perm":
        comm = make_decen(sched, "perm", device=device)
        return {"step": comm.step(x, (), _row(flags, device))[0],
                "run": comm.run(x, flags)[0]}
    comm = make_decen(sched, "fused", device=device,
                      compute_dtype=torch.bfloat16)
    return {"run": comm.run(x, flags)[0]}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _step_ms(fn, device, reps: int, across: bool) -> float:
    """Median host-clock ms of ``fn()``, the card synchronized (and the
    processes met at a barrier) before each call, after one warm call."""
    import torch.distributed as dist

    fn()
    times = []
    for _ in range(reps):
        _sync(device)
        if across:
            dist.barrier()
        t0 = time.perf_counter()
        fn()
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _timings(mesh, case: Case, sched, reps: int) -> dict:
    """One step of each folded backend of the case (``shard_map``, CHOCO)
    and of ``perm`` on ``mesh``: ms (this process's clock; on a mesh that
    spans processes, all of them meet at a barrier before each call) and
    the bytes this process sent to others in the step."""
    home = mesh.home
    across = mesh.multi_process
    xs = shard_workers(case_state(case, home), mesh)
    row = np.asarray(sched.flags[0], np.float32)
    steps = {}
    if "shard_map" in case.scenarios:
        fold = make_decen(sched, "shard_map", mesh=mesh)
        steps["shard_map_step"] = lambda: fold.step(
            xs, (), torch.as_tensor(row))
    if "choco" in case.scenarios:
        choco = make_choco(sched, ratio=case.choco_ratio,
                           consensus_lr=case.consensus_lr,
                           backend="shard_map", mesh=mesh)
        carry = choco.init(xs)
        steps["choco_step"] = lambda: choco.step(xs, carry,
                                                 torch.as_tensor(row))
    if "perm" in case.scenarios:
        perm = make_decen(sched, "perm", mesh=mesh)
        steps["perm_step"] = lambda: perm.step(
            xs, (), torch.as_tensor(row, device=home))
    out = {}
    for key, fn in steps.items():
        multihost.reset_traffic()
        fn()
        out[f"{key}_bytes_sent"] = multihost.TRAFFIC["bytes"]
        out[f"{key}_ms"] = _step_ms(fn, home, reps, across)
    return out


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.contiguous().view(torch.uint8),
                            b.contiguous().view(torch.uint8)))


def _refusals(mesh, case: Case, sched, device) -> dict:
    """The two refusals: ``make_decen`` when rank 1 holds another flag
    stream, and ``train()`` under the group."""
    import torch.distributed as dist

    from ..train import TrainConfig, train

    out = {}
    other = sched
    if dist.get_rank() == 1:
        flags = np.asarray(sched.flags).copy()
        flags[0, 0] = 1 - flags[0, 0]
        other = dataclasses.replace(sched, flags=flags)
    try:
        make_decen(other, "shard_map", mesh=mesh)
    except ValueError as e:
        out["schedule_digest"] = str(e)
    else:
        out["schedule_digest"] = None
    try:
        train(TrainConfig(model="mlp", dataset="synthetic", num_workers=4,
                          graphid=None, topology="ring", epochs=1,
                          batch_size=4), device=device)
    except ValueError as e:
        out["train"] = str(e)
    else:
        out["train"] = None
    return out


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("coordinator", nargs="?", default=None,
                   help="host:port or an init-method URL (file:///path); "
                        "without it, torchrun's environment")
    p.add_argument("num_procs", nargs="?", type=int, default=None)
    p.add_argument("process_id", nargs="?", type=int, default=None)
    p.add_argument("--out", required=True)
    p.add_argument("--profile", choices=sorted(PROFILES), default="full")
    p.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    p.add_argument("--cards", type=int, default=2,
                   help="CPU cards a process (--device cpu)")
    p.add_argument("--backend", default=None,
                   help="gloo or nccl (default: nccl on CUDA cards, gloo "
                        "on the CPU)")
    p.add_argument("--timeout", type=float, default=120.0)
    p.add_argument("--reps", type=int, default=5,
                   help="timed calls of each step (0: no timings)")
    p.add_argument("--save-rows", action="store_true")
    p.add_argument("--spawned-at", type=float, default=None,
                   help="the launcher's time.time() at spawn")
    args = p.parse_args(argv)

    import torch.distributed as dist

    t0 = time.time()
    devices = ["cpu"] * args.cards if args.device == "cpu" else None
    if not multihost.initialize_multihost(
            args.coordinator, args.num_procs, args.process_id,
            backend=args.backend, timeout=args.timeout, devices=devices):
        raise SystemExit("multihost_smoke: no process group (give "
                         "COORDINATOR NPROCS RANK or run under torchrun)")
    joined = time.time()
    rank = dist.get_rank()
    mesh = multihost.global_worker_mesh(devices=devices)
    home = mesh.home
    record = {"rank": rank, "world": dist.get_world_size(),
              "backend": dist.get_backend(),
              "devices": [str(d) for d in mesh.devices],
              "ranks": list(mesh.ranks), "cards": list(mesh.local_cards),
              "entries": [[e.process_index, e.id] for e in mesh.entries],
              "init_seconds": joined - t0,
              "spawn_to_group_seconds": (None if args.spawned_at is None
                                         else joined - args.spawned_at),
              "cases": {}}
    os.makedirs(args.out, exist_ok=True)
    rows, checks = {}, {}
    for case in PROFILES[args.profile]:
        sched = case_schedule(case)
        reset_launch_counts()
        multihost.reset_traffic()
        t1 = time.perf_counter()
        results = run_case(mesh, case, sched)
        _sync(home)
        entry = {"seconds": time.perf_counter() - t1,
                 "launches": {k: v for k, v in LAUNCHES.items() if v},
                 "bytes_sent": multihost.TRAFFIC["bytes"],
                 "messages_sent": multihost.TRAFFIC["messages"]}
        if args.reps:
            entry["timings"] = _timings(mesh, case, sched, args.reps)
        record["cases"][case.label] = entry
        for name, got in results.items() if args.save_rows else ():
            for key, blocks in got.items():
                rows[f"{case.label}/{name}/{key}"] = np.stack(
                    [_to_numpy(b) for b in blocks])
        checks[case.label] = _check_case(mesh, case, sched, results,
                                         args.reps)
        del results
    record["refusals"] = _refusals(mesh, PROFILES[args.profile][0],
                                   case_schedule(PROFILES[args.profile][0]),
                                   args.device)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, record["cases"])
    with open(os.path.join(args.out, f"rank{rank}.json"), "w") as f:
        json.dump(record, f)
    if args.save_rows:
        np.savez(os.path.join(args.out, f"rank{rank}.npz"),
                 cards=np.asarray(mesh.local_cards), **rows)
    ok = True
    if rank == mesh.owner(0):
        ok = all(v for c in checks.values() for v in c["bitwise"].values())
        with open(os.path.join(args.out, "check.json"), "w") as f:
            json.dump({"ok": ok, "cases": checks, "per_rank": every}, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0 if ok else 1


def _check_case(mesh, case: Case, sched, results: dict, reps: int) -> dict:
    """Every result gathered onto the first card's process (all processes
    take part) and there held bitwise to the one-process run of the same
    fold, ``perm`` and ``fused`` also to the one-card call; the launches
    of the cross-process run are read before this runs."""
    gathered = {}
    for name, got in results.items():
        for key, blocks in got.items():
            gathered[(name, key)] = multihost.gather_to_first(blocks)
    if mesh.rank != mesh.owner(0):
        return {}
    one = one_process_mesh(mesh)
    want = run_case(one, case, sched)
    one_card = {name: _one_card_reference(case, sched, name, one.home)
                for name in ("perm", "fused") if name in results}
    bitwise = {}
    for (name, key), full in gathered.items():
        bitwise[f"{name}/{key}"] = _same_bits(
            full, gather_workers(want[name][key]))
        if name in one_card:
            bitwise[f"{name}/{key} one card"] = _same_bits(
                full, one_card[name][key].to(full.device))
    out = {"bitwise": bitwise}
    if reps:
        out["one_process_timings"] = _timings(one, case, sched, reps)
    return out


def spawn(num_procs: int, out: str, args=(), env=None) -> list:
    """Start ``num_procs`` processes of this program, ranks 0..K−1, joined
    by a FileStore at ``out/store`` (no port to race for), each writing
    its output to ``out/rank{r}.log``; returns the ``Popen`` handles
    (:func:`wait_all` ends them)."""
    os.makedirs(out, exist_ok=True)
    store = os.path.join(os.path.abspath(out), "store")
    if os.path.exists(store):
        os.remove(store)
    spawned = time.time()
    root = Path(__file__).resolve().parents[2]
    procs = []
    for rank in range(num_procs):
        with open(os.path.join(out, f"rank{rank}.log"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "matcha_tpu_torch.probes."
                 "multihost_smoke", f"file://{store}", str(num_procs),
                 str(rank), "--out", out, "--spawned-at", repr(spawned),
                 *args], cwd=root, stdout=log, stderr=subprocess.STDOUT,
                env=env))
    return procs


def wait_all(procs, timeout: float) -> list:
    """Every process's exit code, waiting at most ``timeout`` seconds in
    all; a process still running then is killed (its code is then the
    kill's, never 0), and so is every other when one fails, so that no
    peer waits on it."""
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(
                    p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    return [p.returncode for p in procs]


if __name__ == "__main__":
    sys.exit(main())
