#!/usr/bin/env python
"""Quickest proof that the PyTorch/CUDA port runs on the card.

    python3 chip_smoke.py
    python3 chip_smoke.py --phase perf_obs,observability

Needs one CUDA card.  Phases, each printed as a JSON line; any failure
raises and the script exits non-zero.  ``--phase`` runs the phases named
(and those whose results they read: ``planner`` reads ``fused_timing``,
``perf_obs`` both) after the build, and prints no kernels line:

1. device — the card, CUDA and torch versions, and ``nvidia-smi``'s name
   and power limit (printed raw on a line of its own).
2. build — compiles the port's kernel sources from ``matcha_tpu_torch/csrc``
   (one ``nvcc`` each, started together) and prints ptxas' registers and
   spills of every kernel instantiation: the perm kernel's (slabs and
   the band path), the fused kernel's FMA paths (columns in registers,
   the chain with its tile in shared memory, one launch per step) and
   tensor-core paths (chained in registers; in shared memory, unsplit and
   split; one launch per step); a spill store in a per-step kernel of the
   fused source, in the tensor cores' shared-memory mainloop or in the
   perm band kernel fails the run.
3. parity — the perm kernel's two instantiations against their plain PyTorch version on the card, at
   the shapes of the slice (N=16 workers, the M=8 matchings of zoo graph 4,
   D=273,258 ResNet-20 parameters, MATCHA weights): T in {1, 64},
   w_window in {1, 8}, dbuf on and off, f32 and bf16 wire, with and without
   a 0/1 alive mask; an odd D (1,031) in both state dtypes and both wires;
   plus a bf16 state, a state holding a NaN and an inf, a NaN that only an
   inactive matching reaches, values near the f32 limit (a difference that
   overflows, and a slab whose image leaves the range where terms may be
   skipped and comes back), N=2 and N=1 (rows past N masked), N=256 on a
   hypercube at T=64, and N=4096 on a hypercube at T=1 (the band path)
   and 8 (and at T=8 with gates of 0, 0.5 and 1).  Bitwise.
4. timing — kernel (CUDA events, and ``device_ms`` from the profiler),
   plain version and the dense yardstick (T calls of
   ``torch.matmul(W_t, x)``, the JAX package's dense backend; the port
   never calls it), median of 20 runs with the L2 cache flushed before
   each (for ``device_ms`` too); and the bound from the card's bandwidth
   and FP32 peak.  Shapes:
   the slice at T=1 and 64, N=256 at T=64, N=4096 at T=1 (the band
   path) and 64 (the slabs; plain and library at T=1 only, 3 runs).
   perm_large — the perm kernel's band path (no slab fits a CTA) on the
   16,384-worker hypercube and a 4096-worker ER graph of mean degree 30
   (more matchings than the slab tables hold): times first, at T = 1 and
   4 (the ER graph at full width, the hypercube at D = 32,768) with the
   profiler's device time, plain version, library call and bound, and
   the hypercube at full width, T = 4, with its peak device memory; then
   at D = 32,768: T = 1, 2, 3, 4 and 8, an f32 state on both wires, a
   bf16 state, an alive mask and a state holding inf and NaN, both
   instantiations, and the 8193-worker ring at D = 1,031, bitwise;
   ``make_decen(..., "perm").run`` on both graphs, launches by path.
   The hypercube's schedule (α's spectral solve: minutes of host numpy)
   is made in a spawned side process that starts before the build, and
   perm_large runs after ``communicators`` (11), when it is done.
5. slice — ``train()`` at full width: ResNet-20, 16 workers, graph 4,
   MATCHA budget 0.5, batch 32, perm backend, f32 wire, 2 epochs of 4
   steps.  Loss and disagreement finite; the kernel's launch count equals
   the training steps plus the comm-split timer's chains.  Then the step
   in steady state: host-clock ms per step and a ``torch.profiler`` split
   of its device time by part, with the card's idle share.  Then a small
   run on the card and on the CPU must agree.  Then the streamed-window
   instantiation, which ``train()`` does not take, runs one 64-step chain
   through ``perm_gossip_run(dbuf=False)``.
6. fused_parity — the fused W-stack kernel against its plain version on
   every path: an f32 stack (FMA: ``fma_regs`` up to 16 workers, the
   ``fma`` chain to 256, ``fma_step`` above; each held bitwise to the
   other FMA path that takes its N) and a bf16 stack on an f32 and a bf16
   state (tensor cores: ``tc_regs`` up to 16 workers, ``tensor_core`` to
   1024, ``tc_step`` above).  T in {1, 4, 64}
   at the slice's ``[16, 273258]`` (graph 4, MATCHA weights), and that
   stack composed four steps at a time (no W_t symmetric); N = 1 and 3
   (D = 1,031), N = 17 and a ragged D at N = 16 in every dtype pair;
   T in {1, 4, 64} (bf16) and T = 4 (f32) at ``[256, 273258]`` on the
   256-worker hypercube; the FMA chain's shapes at N = 32, 64 and 256 (D =
   1,031, hypercube stacks composed two steps at a time, T = 1, 4 and 32,
   and uncomposed at T = 64); N = 100 and N = 300 (rings, T = 8, f32 and
   bf16; N = 100 is also padded to 112 rows on the tensor cores); T = 0.
   Bars scaled by the output: f32 max |Δ| ≤ 1e-5·max|ref|, a bf16
   operand pass ≤ 2⁻⁷·max|ref| (whether it is bitwise and the share of
   elements that differ are printed); each
   register path against the shared-memory path of its stack dtype
   (bitwise required on f32; printed on bf16); bitwise against itself
   across ``w_window`` 1 vs 8 and ``block_d`` 32.  Then the dense mix on
   the card (f32 state, bf16 wire, and f32 with TF32 switched on by the
   caller) against a float64 product of the same rounded operands.
7. fused_timing — the fused kernel (CUDA events and the profiler's device
   time), its plain version, the library call (T calls of
   ``torch.matmul(W_t, x)``, by events and by device time) and the bound,
   at ``[16, 273258]`` for T = 1, 4 and 64 (f32; a bf16 stack on an f32
   and a bf16 state; at T = 1 also the device time of one copy of the
   state, a practical floor) and at ``[256, 273258]`` for T = 64 (bf16,
   also at a 64-column tile, twice the W_t reads from L2; and f32).
   fused_chain — consensus chains through ``make_decen(..., "fused").run``:
   ``[256, 273258]`` in bf16 and f32, stepped (one launch) and with
   ``chunk=64`` (composed first), and ``[16, 273258]`` in bf16, stepped;
   their launches counted by path, each held to the plain version on its
   own stack, the two f32 chains also to each other (f32 bar), and the
   times of the four at N = 256.
8. fused_slice — ``train()`` at full width with the fused backend (the
   dense product every step, the fused kernel in the comm-split timer's
   chains), 2 epochs of 4 steps: loss and disagreement finite, the fused
   kernel launched exactly once per timer chain, on its register FMA path.
9. fused_large — K3 above the shared-memory paths' old caps (843 workers
   on the FMA path, 1,424 on the tensor cores) at D = 4,099: f32 and
   bf16 stacks at N = 1024 (T = 8) and 4095 (T = 1) against the plain
   version (the fused bars; an f32 stack bitwise); the per-step paths
   bitwise against the on-chip ones where both take N (FMA at 256, tensor
   cores at 1024), and at ragged N (FMA at 200 against the chain and 257
   against the plain version, tensor cores at 1025 and 1040), and
   ``tensor_core`` against ``tc_step`` at N = 17, 64, 256, 1000 and 1024,
   with D = 1,031 and 4,098, both state dtypes; and
   ``make_decen(..., "fused").run`` at N = 1024 (f32: ``fma_step``; bf16:
   ``tensor_core``) and 2048 (bf16: ``tc_step``), launches counted by
   path.  fused_sweep — the f32 stack at full width across N = 17, 32,
   64, 128 and 256 (T = 64, the FMA chain) and 512 and 1024 (T = 8, one
   launch per step), and N = 4095, T = 1 in f32 and bf16: kernel, plain
   version, library call and bound; the per-step rows also the
   profiler's device time per call and per step launch, and the step
   kernels' spill stores.
10. split_probe — the split-step probe (K4, ``probes/split_probe.py``) on
   its full-width ``[256, 273258]`` bf16 inputs: the split schedule
   bitwise equal to the unsplit one at T = 1, 8, 16, 32 and 64, where the
   state is still normal (max|out| printed); both held to the plain
   version within one bf16 ulp of the output at T ≤ 8, and deeper within
   one ulp or twice the plain version's own spread (its sums taken in
   another order), whichever is larger, since the probe's random W_t do
   not contract rounding differences; every step of the T = 64 chain
   within one ulp of the plain step on the same input, the chain bitwise
   equal to its 64 one-step launches; one step on an f32 state against a
   float64 product; then max|out| of the T = 2000
   output and the probe's own record at T = 2000
   (``main(["--reps", "3"])``), its launches counted.
   split_timing — both schedules (CUDA events and the profiler's device
   time), the plain version (T = 64 only), the library call (T bf16
   ``torch.matmul`` calls) and the bound at T = 64 and T = 2000.
11. epoch_end — the end of the epoch at the slice's configuration, in a
   temporary savePath: ``train()`` for 2 epochs with ``save`` and a
   checkpoint every epoch (K1's launch count as in the slice phase; 16 × 8
   Recorder CSVs of 2 rows; every ``events.jsonl`` line valid under the
   port's ``validate_event``: ``run_start``, ``backend``, the cost
   ledger's three ``compile`` events, then ``epoch``, ``telemetry``,
   ``heartbeat`` (and any ``anomaly``) and ``checkpoint`` twice); ``save_checkpoint`` then ``restore_checkpoint`` of its live
   state, bitwise (every parameter, batch-norm and momentum buffer, the
   step); a run resumed from the epoch-0 checkpoint in the same folder
   (K1 launched for one epoch; epoch 1's loss, disagreement and test loss
   within 1e-4 relative of the uninterrupted run's and its final state
   bitwise, on ``train()``'s own deterministic cuDNN; the CSVs cut back
   to 2 rows, not 3).  The host seconds of each Recorder flush and each
   checkpoint save and restore, with the checkpoint's bytes; and the
   spread of two uninterrupted runs on cuDNN's default algorithms.
   communicators — one epoch each of the centralized and ``none``
   communicators and of decen on the skip backend at the slice's width:
   finite, no kernel launched, the centralized rows bitwise identical after
   every step.
12. determinism — what ``train()``'s deterministic cuDNN costs: the
   slice's steady step on the default and the deterministic algorithms,
   alternated, 3 rounds of 20 steps each way.
   choco — CHOCO at BASELINE.json config 4's shape (ResNet-20, 64 workers
   on a generated Erdős–Rényi graph, MATCHA budget 0.5, batch 32, top-k
   at ratio 0.9) through ``train()``, 2 epochs of 4 steps with a
   checkpoint every epoch: finite, ``comm_encode_time > 0``, the run
   resumed from epoch 0 bitwise the uninterrupted one (the ``{x̂, s}``
   carry included), a small run on the card against the CPU (1e-4); then
   one ``make_choco`` step at ``[64, 273258]`` (events, the profiler's
   top-k / scatter / rest split, the byte bound) and one step each of
   ``random_k``, ``top_k_q8`` (k distinct indices a row) and a bf16 wire.
   models — VGG-16 (8 workers, zoo graph 0), WRN-28-10 (16 workers, zoo
   graph 4, 100 classes) and the ImageNet ResNet-50 (4 workers, 224×224,
   1,000 classes) through ``train()`` on the perm backend, one epoch of 2
   steps (K1 launched 4 times each); each model's second step and peak
   memory, also on cuDNN's default algorithms, WRN-28-10 also with
   ``remat`` and with ``grad_chunk=4``; K1 at
   each model's D, T = 1, against its byte bound, its plain version and
   the library call (one ``torch.matmul(W, x)``).
   resilience — resilience and elastic membership at the slice's width,
   3 epochs of 4 steps (``phase_resilience``): ``train()`` under a fault
   plan with every event kind (``RESILIENCE_PLAN``: finite; 15 workers
   alive in epoch 0 and 16 in epoch 2; the ``plan`` and ``healed``
   events in ``faults.json``; worker 3's evaluation a NaN gap in epoch 0;
   the detector's rows finite outside the quarantine at every epoch
   boundary; K1 launched once per step under the step's survivor mask);
   K1's inputs at two faulted steps captured and each launch held bitwise
   to its plain version, and step 5's input with a dead worker's row
   poisoned through ``gossip_quarantined``: bitwise, survivors finite;
   a rollback (a NaN on all 16 workers, ``max_recoveries=1``: the retry
   starts from the snapshot's digest; its bytes and clone time); a
   membership trace 16 → 12 → 16, eager and at staleness 2 (the vacant
   rows frozen bitwise, the joined rows bitwise the donors' mean, α
   ``refold_for``'s, a resume from the shrink's checkpoint bitwise the
   uninterrupted run, ring included); ms per step of epoch 2 with and
   without the fault plan in alternated rounds.
   pipeline — the pipelined gossip schedule at the slice's width
   (``phase_pipeline``): ``train()`` with ``overlap="1step"``, staleness
   2 and 4, and staleness 2 with ``local_steps=2`` (finite; K1 launched
   once per issued step plus the timer's chains, so half as often under
   ``local_steps=2``; the final drain keeps the worker mean to f32
   rounding); ``run_pipelined(staleness=1)`` bitwise ``run_overlapped``
   and ``run_elided(flags, 2)`` bitwise ``run(flags[::2])`` at
   ``[16, 273258]`` through K1, the drained ``run_overlapped`` within
   T ulps of ``run``; a staleness-2 run resumed from its epoch-0
   checkpoint bitwise the uninterrupted one, ring included, and resumed
   at staleness 4 and eagerly; ms per step of eager, ``1step``,
   ``staleness=2`` and ``local_steps=2`` in alternated rounds.
   planner — the offline planner and ``gossip_backend="auto"``
   (``phase_planner``): ``sweep`` over zoo graph 4 at budgets 0.25 /
   0.5 / 0.75 through the port's planlint, its host seconds; the slice
   trained under the artifact with ``auto`` gated by r, K3's bound over
   its time at chain (b) in this run, read from a roofline report (the
   journaled ``backend`` event equal to ``choose_gossip_backend`` on r),
   and with the ratio 0.9 (``perm``: K1 launched 8 + 4 times, a step
   bitwise its plain version); ``make_decen(<4096-worker hypercube>,
   "auto")`` (``perm`` with no measurement) at ``[4096, 273258]``, T = 1,
   on K1's band path, bitwise; ``verify_plan_run`` on the gated run.
   observability — the training run's observability plane at the slice's
   width, 3 epochs of 4 steps, ``save`` on, telemetry and health on
   (``phase_observability``): one ``telemetry`` event an epoch whose
   matchings and wire bytes are exactly the schedule's flag rows', three
   heartbeats in ``{run}/health/`` and in the journal, ``run_start``'s
   ``predicted`` equal to ``compose_predicted_rho`` recomputed; gossip
   alone with no ``drift`` event at the solved α and one at 0.05·α;
   ``membership_live`` on a heartbeat directory where w3 is an hour
   stale (one ``leave``, K1 under the survivor mask every step, a step
   bitwise its plain version); synchronizing calls (the sync debug mode)
   equal with the accumulator on and off, in the step and in ``train()``;
   ms and launches a step, on and off, in alternated rounds.
   perf_obs — performance observability (``phase_perf_obs``, cell (m)):
   the observability run with ``trace_dir`` and ``trace_epoch=1``; the
   one trace attributed by ``obs.xprof`` (every K1 row of the traced
   epoch in ``comm``, 4 of them; every convolution row in ``comp``; the
   phases' seconds, the overlap, the device-busy share and the
   ``STEP_PARTS`` split printed); the cost ledger's ``compile`` events
   and the heartbeats' ``peak_bytes``; the step's spans, each a
   ``nullcontext`` outside a profiler and a ``record_function`` inside
   one, and ms a step with them and patched away; the roofline at
   chain (b) on the card's row, priced by one K3 launch, against the
   planner phase's r and read back by ``load_measured_vs_ceiling``;
   ``obs_torch.py``'s commands on the run with JAX blocked.
   serve — the run controller (``phase_serve``, cell (n)): slice (a) with
   ``save`` and a checkpoint every epoch.  ``train()`` under a
   ``TrainerHarness`` with identity knobs bitwise the run without a hook
   (K1's launches and the synchronizing calls equal, in ``train()`` and
   in 8 steps); a budget swap (0.25) before epoch 1 and a ``local_steps``
   swap (2) before epoch 2 (two journaled ``apply`` events whose numbers
   are ``resolve_budget_swap``'s on the host; K1 launched 4, 4, 2, 2
   times plus the timer's chains; K1's epoch-1 weights those built from
   the journaled scales, and K1 on them bitwise its plain version at
   T = 4); the daemon (``Controller`` in a thread behind a
   ``ServeEndpoint``, 3 epochs, a promotion an epoch): a run SIGKILLed
   after its first checkpoint, beside the uninterrupted run on the card,
   ends with its last epoch row and promoted arrays, one restart and two
   lifetimes; ``/status`` and ``/promoted`` answer 200, ``/healthz``
   its ``fleet_verdict`` (503: w4 flagged); ``serve_torch.py verify``
   exits 0, then 1 after a manifest byte is edited; no lifetime calls
   ``nvcc``; ms a step with identity knobs and without, alternated.
   chaos — the chaos harness (``phase_chaos``, cell (o)): slice (a)'s
   ``train()`` (2 epochs, ``save``) with ``MATCHA_CHAOS_KILL`` armed at
   ``epoch_boundary`` on a marker that exists, bitwise the unarmed run
   (K1's launches and profiler rows, 12 each, and the synchronizing calls
   equal), in this process while ``campaign.run_trial`` runs slice (a)
   in the place of the campaign's MLP ring, 4 epochs, a checkpoint an
   epoch, in trainer subprocesses on the card:
   seeds 6, 7, 8, 9 (the four kill families, SIGKILL and SIGTERM), 0
   (``ckpt_bitflip``) and 10 (``io_enospc``), three lifetimes at once
   after the kill families' three twins; every trial ``ok`` under the
   invariant suite, each kill trial 1 restart and its final epoch row
   float-equal to its twin's, every lifetime that ran to its end a
   ``perm`` backend event, no lifetime calling ``nvcc``; each lifetime's
   seconds and seconds to its first heartbeat.
13. a ``{"kernels": [...]}`` summary line (perm ×2 and its band path,
    fused_gossip per path ×6, split_gossip; K1's launches by entry point,
    the models', the resilience, the pipelined, the planner's, the
    observability, the perf_obs, the serve and the chaos phase's
    in-process runs included; K3's
    ``tensor_core`` path with the roofline's launch), then the
    ``nvidia-smi`` line.
14. last line: ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from matcha_tpu_torch import _kernels
from matcha_tpu_torch.communicator import make_decen
from matcha_tpu_torch.parallel import fused_gossip as fg
from matcha_tpu_torch.parallel import (
    LAUNCHES,
    build_mixing_stack,
    compose_mixing_stack,
    fused_gossip_plain,
    fused_gossip_run,
    gossip_mix_dense,
    involution_tables,
    perm_gossip_plain,
    perm_gossip_run,
    reset_launch_counts,
)
from matcha_tpu_torch.probes.perm_bench import (
    FP32_OPS_PER_S,
    HBM_BYTES_PER_S,
    bound,
    perm_yardstick,
)
from matcha_tpu_torch.schedule import fixed_schedule, matcha_schedule
from matcha_tpu_torch.topology import (
    decompose,
    erdos_renyi_graph,
    hypercube_graph,
    matching_laplacians,
    ring_graph,
    select_graph,
)
from matcha_tpu_torch.models import select_model
from matcha_tpu_torch.ops import WorkerFlattener
from matcha_tpu_torch.obs.costs import H100
from matcha_tpu_torch.obs.journal import read_journal, validate_event
from matcha_tpu_torch.train.checkpoint import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from matcha_tpu_torch.resilience.runtime import (
    finite_rows,
    gossip_quarantined,
    heal_and_mask,
    tensors_in,
)
from matcha_tpu_torch.resilience.runtime import \
    state_tensors as all_state_tensors
from matcha_tpu_torch.train.recorder import SERIES
from matcha_tpu_torch.train import (
    TrainConfig,
    build_schedule,
    init_train_state,
    make_lr_schedule,
    make_optimizer,
    make_train_step,
    train,
)

# the dense bf16 tensor-core peak, from the port's one chip table (the HBM
# bandwidth and the FP32 peak come with the perm kernel's bound)
BF16_OPS_PER_S = H100.peak_tflops * 1e12

SEED = 9001
SLICE_D = 273258  # ResNet-20 parameters per worker
SOURCE = "matcha_tpu_torch/csrc/perm_gossip.cu"
FUSED_SOURCE = "matcha_tpu_torch/csrc/fused_gossip.cu"
FUSED_REPLACES = "matcha_tpu/parallel/pallas_gossip.py:182"
SPLIT_REPLACES = "benchmarks/split_probe.py:86"
# the fused kernel's paths, as fused_gossip.PATH_NAMES names them (the
# split schedule is K4's)
FUSED_PATHS = ("fma_regs", "fma", "tc_regs", "tensor_core", "fma_step",
               "tc_step")
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


def hypercube_schedule(n: int):
    """An n-worker hypercube, each matching active with probability 0.5
    (the fixed Bernoulli schedule: MATCHA's solver takes minutes of host
    time at this N and changes nothing the kernel sees but the weights).
    Host numpy; its α's spectral solve takes minutes at N = 16,384."""
    dec = decompose(hypercube_graph(n), n, seed=SEED)
    return fixed_schedule(dec, n, 64, budget=0.5, mode="bernoulli",
                          seed=SEED)


def hypercube_tables(dev, n: int = 256, sched=None):
    """``hypercube_schedule(n)`` (or ``sched``, if already made) and its
    tables on the card."""
    return _tables(hypercube_schedule(n) if sched is None else sched, dev)


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


def device_ms(fn, kernel: str, flush, runs: int = 20):
    """Mean device time of one launch of ``kernel`` (each ``fn`` launches
    it once) from ``torch.profiler`` (launch gaps excluded), the L2 cache
    flushed before each call as for ``time_ms``, or None when the trace
    holds no device time.  The mean is over the launches the trace
    recorded: the profiler can drop a record now and then, and a short
    window of long kernels at times comes back with no device record at
    all, so such a window is profiled again with twice the calls (three
    tries)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                flush()
                fn()
            torch.cuda.synchronize()
        found = [e for e in prof.key_averages() if kernel in e.key]
        total = sum(getattr(e, "device_time_total", 0.0) for e in found)
        if total:
            return total / sum(e.count for e in found) / 1e3
        runs *= 2
    return None


def single_call_device_ms(fn, kernel: str, flush, runs: int):
    """Where ``device_ms`` found no record: one call per profiler session,
    ``runs`` sessions, the kernel's records read from the raw events (not
    ``key_averages``).  Returns ``(mean ms or None, census)``, the census
    listing what the sessions' traces held on the device: the count of
    records and the names of the first few."""
    from torch.profiler import ProfilerActivity, profile

    times, seen = [], {}
    for _ in range(runs):
        flush()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            seen[e.name[:60]] = seen.get(e.name[:60], 0) + 1
            if kernel in e.name:
                times.append(e.time_range.elapsed_us() / 1e3)
    census = {"sessions": runs, "device_records": sum(seen.values()),
              "names": sorted(seen.items(), key=lambda kv: -kv[1])[:6],
              "kernel_records": len(times)}
    return (statistics.mean(times) if times else None), census


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


def inactive_partner(sched, perms, step: int = 0):
    """``(i, p)``: a worker and its partner in a matching that is inactive
    at ``step``, where ``p`` is no partner of ``i`` in an active one."""
    flags = sched.flags[step]
    pm = perms.cpu().numpy()
    for j in np.flatnonzero(flags == 0):
        for i in range(pm.shape[1]):
            p = int(pm[j, i])
            active = {int(pm[k, i]) for k in np.flatnonzero(flags)}
            if p != i and p not in active:
                return i, p
    raise AssertionError("no matching is inactive at that step")


def phase_parity(dev, tables, big_tables, huge_tables):
    """Each instantiation against the plain version, bitwise, at the
    slice's shapes; then a bf16 state, an odd D, states with a NaN, an inf
    and values near the f32 limit, N = 256, and N = 4096."""
    sched, perms, partnered = tables
    worst = {name: 0.0 for name in KERNELS}
    cases = 0

    def check(x, w, p, part, label, **kw):
        nonlocal cases
        ref = perm_gossip_plain(x, w, p, part, **kw)
        first = None
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
                if first is None:
                    first = out
                elif not same_bits(out, first):
                    raise AssertionError(f"{label}: dbuf on and off disagree")
                del out
                cases += 1
        return ref

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
            # an odd D: every row's pairs unaligned, scalar edges
            for dtype in (torch.float32, torch.bfloat16):
                check(state(16, 1031, dev).to(dtype), w, perms, partnered,
                      f"D=1031 {dtype} T={t_steps} wire={wire}",
                      wire_dtype=wire)
    check(x.to(torch.bfloat16), w, perms, partnered, "bf16 state T=64")
    bad = x.clone()
    bad[3, 100], bad[7, 500] = float("nan"), float("inf")
    check(bad, w, perms, partnered, "NaN/inf state T=64")
    # a NaN that only an inactive matching reaches (the plain version
    # spreads it as 0 * NaN); a pair whose difference overflows although
    # both values are finite (|v| >= 2^127: no term may be skipped), and a
    # lone value near the limit that mixes down, so its slab's image is
    # out of range in early steps and in range later
    i, p = inactive_partner(sched, perms)
    w1 = torch.as_tensor(sched.alpha * sched.flags[:1], dtype=torch.float32,
                         device=dev)
    edge = x.clone()
    edge[p, 7] = float("nan")
    out = check(edge, w1, perms, partnered, "NaN via an inactive matching")
    if not bool(torch.isnan(out[i, 7])):
        raise AssertionError("the plain version no longer spreads 0 * NaN")
    edge = x.clone()
    edge[i, 300], edge[p, 300] = 3.0e38, -3.0e38
    edge[5, 9000] = 3.0e38
    w8 = torch.as_tensor(sched.alpha * sched.flags[:8], dtype=torch.float32,
                         device=dev)
    check(edge, w8, perms, partnered, "f32 limit T=8")
    check(edge, w8, perms, partnered, "f32 limit T=8 bf16 wire",
          wire_dtype="bf16")
    big, bperms, bpart = big_tables
    wb = torch.as_tensor(big.alpha * big.flags, dtype=torch.float32,
                         device=dev)
    check(state(256, SLICE_D, dev), wb, bperms, bpart, "N=256 T=64")
    # N = 2 and 1: four rows a thread, those past N masked
    pair, pperms, ppart = hypercube_tables(dev, 2)
    wp = torch.as_tensor(pair.alpha * pair.flags[:8], dtype=torch.float32,
                         device=dev)
    check(state(2, 1031, dev), wp, pperms, ppart, "N=2 D=1031 T=8")
    alone = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    check(state(1, 1030, dev), wp, alone, alone.float(), "N=1 T=8")
    huge, hperms, hpart = huge_tables
    xh = state(4096, SLICE_D, dev)
    for t_steps in (1, 8):
        wh = torch.as_tensor(huge.alpha * huge.flags[:t_steps],
                             dtype=torch.float32, device=dev)
        check(xh, wh, hperms, hpart, f"N=4096 T={t_steps}")
    # gates other than 0 and 1: the uint16 tables cannot hold them, so the
    # kernel reads them from device memory
    weak = torch.ones(4096, device=dev)
    weak[::7], weak[::11] = 0.5, 0.0
    check(xh, wh, hperms, hpart, "N=4096 T=8 alive in {0, 0.5, 1}",
          alive=weak)
    del xh
    emit({"phase": "parity", "cases": cases, "bitwise": True,
          "max_abs_err": worst})
    return worst


def phase_timing(dev, tables, big_tables, huge_tables):
    """Kernel (CUDA events and the profiler's device time), plain version,
    library call and bound at the slice's shapes, N = 256, and N = 4096
    (plain and library at T = 1 only)."""
    flush = L2Flush(dev)
    sched, perms, partnered = tables
    big, bperms, bpart = big_tables
    huge, hperms, hpart = huge_tables
    shapes = [("slice T=1", sched, perms, partnered, 16, 1),
              ("slice T=64", sched, perms, partnered, 16, 64),
              ("hypercube N=256 T=64", big, bperms, bpart, 256, 64),
              ("hypercube N=4096 T=1", huge, hperms, hpart, 4096, 1),
              ("hypercube N=4096 T=64", huge, hperms, hpart, 4096, 64)]
    rows = []
    for label, sch, p, part, n, t_steps in shapes:
        x = state(n, SLICE_D, dev)
        w = torch.as_tensor(sch.alpha * sch.flags[:t_steps],
                            dtype=torch.float32, device=dev)
        # the path the launch rule took: the band path (perm_band_kernel)
        # or the slabs (perm_gossip_kernel)
        before = LAUNCHES["perm_gossip/band"]
        perm_gossip_run(x, w, p, part)
        path = "band" if LAUNCHES["perm_gossip/band"] > before else "slab"
        row = {"shape": label, "N": n, "D": SLICE_D, "T": t_steps,
               "M": int(p.shape[0]), "path": path}
        for name, spec in KERNELS.items():
            run = lambda: perm_gossip_run(x, w, p, part, dbuf=spec["dbuf"])
            row[f"{name}_ms"] = time_ms(run, flush)
            row[f"{name}_device_ms"] = device_ms(
                run, "perm_band_kernel" if path == "band"
                else "perm_gossip_kernel", flush)
        slow = n == 4096 and t_steps > 1
        row["plain_ms"] = None if slow else time_ms(
            lambda: perm_gossip_plain(x, w, p, part), flush,
            runs=3 if n == 4096 else 20)
        row["library_ms"] = None if slow else time_ms(
            dense_yardstick(sch, w, x), flush, runs=3 if n == 4096 else 20)
        row["bound_ms"], row["bound_by"] = bound(x, w, p, part)
        rows.append(row)
        emit({"phase": "timing", **row})
        del x
        torch.cuda.empty_cache()
    return rows


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def fused_bound(x, stack):
    """The least time for T dense steps: bytes (state read and written
    once, the stack read once) over the HBM rate, and 2·N²·D·T operations
    over the peak of the stack's type (FP32, or bf16 tensor cores).
    Returns (ms, "bytes"|"operations")."""
    n, d = x.shape
    t_steps = stack.shape[0]
    nbytes = 2 * n * d * x.element_size() + stack.numel() * stack.element_size()
    peak = BF16_OPS_PER_S if stack.dtype == torch.bfloat16 else FP32_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * n * n * d * t_steps / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mixing_stack(sched, t_steps, dtype, dev):
    flags = torch.as_tensor(sched.flags[:t_steps], dtype=torch.float32,
                            device=dev)
    return build_mixing_stack(sched.laplacians(), sched.alpha, flags, dtype)


def ring_stack(n: int, t_steps: int, dtype, dev):
    """The mixing stack of a ring of ``n`` workers, each of its matchings
    active with probability 0.5: it mixes slowly, so a few steps leave the
    state far from consensus."""
    ring = fixed_schedule(decompose(ring_graph(n), n, seed=SEED), n, t_steps,
                          budget=0.5, mode="bernoulli", seed=SEED)
    return mixing_stack(ring, t_steps, dtype, dev)


def fused_bar(out_ref, x, stack) -> float:
    """The bar of the fused kernel against its plain version, scaled by the
    output: 1e-5·max|ref| for f32 operands (f32 sums in another order), one
    bf16 ulp at the output's largest magnitude, 2⁻⁷·max|ref|, when a step's
    operands are bf16 (a sum one f32 ulp apart may round a later operand
    the other way)."""
    exact = x.dtype == stack.dtype == torch.float32
    return (1e-5 if exact else 2.0 ** -7) * float(out_ref.float().abs().max())


def fused_path(x, stack) -> str:
    """The fused kernel's path for a state and stack: FP32 FMA for f32
    (``fma_regs`` up to 16 workers, ``fma`` above), the tensor cores for
    bf16 (``tc_regs`` up to 16 workers, ``tensor_core`` above)."""
    return fg.PATH_NAMES[fg.kernel_path(stack.dtype, x.shape[0])]


def forced_run(x, stack, path):
    """One launch of ``path`` whatever the path rule would take at this N
    (the C side refuses a shape the path cannot take)."""
    prep, _ = fg.prepare_stack(x, stack, 2048, 1)
    return fg.launch_kernel(x, prep, fg.kernel_shape(x.shape[0], 2048, path,
                                                     prep.shape[0]))


def smem_path_run(x, stack):
    """One launch of the shared-memory path of the stack's dtype (the FMA
    chain or the tensor cores), whatever N: what a register path is held
    to."""
    return forced_run(x, stack, fg.TENSOR_CORE if stack.dtype == torch.bfloat16
                      else fg.FMA)


def scalar_stack(t_steps: int, dtype, dev):
    """A one-worker stream: random scalar weights in [0.5, 1)."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    return (0.5 + 0.5 * torch.rand(t_steps, 1, 1, generator=g,
                                   device=dev)).to(dtype)


def phase_fused_parity(dev, tables, big_tables):
    """The fused kernel against its plain version (rounding bars scaled by
    the output) and against itself (bitwise across w_window and tile
    width); each register path against the shared-memory path of its
    stack dtype (bitwise required for f32); then the dense mix's precision
    on the card."""
    sched, big = tables[0], big_tables[0]
    f32, bf16 = torch.float32, torch.bfloat16
    x16 = state(16, SLICE_D, dev)
    cases = []
    for t_steps in (1, 4, 64):
        for state_dtype, stack_dtype in ((f32, f32), (f32, bf16),
                                         (bf16, bf16)):
            cases.append((f"slice T={t_steps} state={state_dtype} "
                          f"stack={stack_dtype}", x16.to(state_dtype),
                          lambda t=t_steps, s=stack_dtype:
                          mixing_stack(sched, t, s, dev)))
    # W_t that are not symmetric: the slice's stack composed four steps at
    # a time, so a transposed W_t would show
    for state_dtype, stack_dtype in ((f32, f32), (f32, bf16), (bf16, bf16)):
        cases.append((f"slice composed chunk=4 T=16 state={state_dtype} "
                      f"stack={stack_dtype}", x16.to(state_dtype),
                      lambda s=stack_dtype: compose_mixing_stack(
                          mixing_stack(sched, 64, f32, dev), 4).to(s)))
    # the register paths' edges: N = 1 and 3 (rows and k padded), N = 17
    # (the shared-memory paths again), an odd D in every dtype pair
    for state_dtype, stack_dtype in ((f32, f32), (f32, bf16), (bf16, bf16)):
        tag = f"state={state_dtype} stack={stack_dtype}"
        cases.append((f"N=1 D=1031 T=8 {tag}",
                      state(1, 1031, dev).to(state_dtype),
                      lambda s=stack_dtype: scalar_stack(8, s, dev)))
        cases.append((f"ring N=3 D=1031 T=8 {tag}",
                      state(3, 1031, dev).to(state_dtype),
                      lambda s=stack_dtype: ring_stack(3, 8, s, dev)))
        cases.append((f"ring N=17 T=8 {tag}",
                      state(17, SLICE_D, dev).to(state_dtype),
                      lambda s=stack_dtype: ring_stack(17, 8, s, dev)))
        cases.append((f"ragged D=1031 T=13 {tag}",
                      state(16, 1031, dev).to(state_dtype),
                      lambda s=stack_dtype: mixing_stack(sched, 13, s, dev)))
    # N = 256 (tile 32, one pass of 256 rows): T = 1 and 4 before the
    # hypercube reaches consensus, and T = 64, chain (b)'s length
    x256 = state(256, SLICE_D, dev)
    for t_steps, dtype in ((1, bf16), (4, bf16), (64, bf16), (4, f32)):
        cases.append((f"hypercube N=256 T={t_steps} {dtype}/{dtype}",
                      x256.to(dtype),
                      lambda t=t_steps, s=dtype: mixing_stack(big, t, s, dev)))
    # the FMA chain's launch shapes (32, 64 and 256 rows of sums) on
    # composed hypercube stacks (no W_t symmetric), an odd D, T = 1 to 64
    for n in (32, 64, 256):
        cube = hypercube_tables(dev, n)[0]
        for t_steps in (1, 4, 32):
            cases.append((f"hypercube N={n} composed chunk=2 D=1031 "
                          f"T={t_steps} f32/f32", state(n, 1031, dev),
                          lambda c=cube, t=t_steps: compose_mixing_stack(
                              mixing_stack(c, 64, f32, dev), 2)[:t]))
        cases.append((f"hypercube N={n} D=1031 T=64 f32/f32",
                      state(n, 1031, dev),
                      lambda c=cube: mixing_stack(c, 64, f32, dev)))
    # N = 100 (the tensor cores: two row passes of 64, or one at the
    # 32-column tile) and N = 300 (tile 32; the FMA path one step a launch)
    for n in (100, 300):
        for dtype in (f32, bf16):
            cases.append((f"ring N={n} T=8 {dtype}/{dtype} (2 passes)",
                          state(n, SLICE_D, dev).to(dtype),
                          lambda n=n, s=dtype: ring_stack(n, 8, s, dev)))
    rows, worst = [], {name: 0.0 for name in FUSED_PATHS}
    for label, x, make_stack in cases:
        stack = make_stack()
        ref = fused_gossip_plain(x, stack)
        out = fused_gossip_run(x, stack)
        torch.cuda.synchronize()
        bar = fused_bar(ref, x, stack)
        err = max_err(out, ref)
        path = fused_path(x, stack)
        worst[path] = max(worst[path], err)
        row = {"case": label, "path": path, "max_abs_err": err, "bar": bar,
               "max_abs_ref": float(ref.float().abs().max()),
               "bitwise": same_bits(out, ref),
               "differ_share": float((out != ref).float().mean())}
        if not err <= bar:
            raise AssertionError(f"fused {label}: max |Δ| {err} > {bar}")
        if path in ("fma", "fma_step"):
            # every FMA path sums each element in one order: the register
            # path (N <= 16) and the per-step path give the chain's bits
            other = (fg.FMA_STEP if path == "fma" else fg.FMA
                     if x.shape[0] <= fg.N_CHAIN_F32 else None)
            if other is not None:
                row["bitwise_vs_" + fg.PATH_NAMES[other]] = same_bits(
                    out, forced_run(x, stack, other))
                if not row["bitwise_vs_" + fg.PATH_NAMES[other]]:
                    raise AssertionError(f"fused {label}: {path} differs "
                                         f"from {fg.PATH_NAMES[other]}")
        if path in ("fma_regs", "tc_regs"):
            smem = smem_path_run(x, stack)
            row["bitwise_vs_smem_path"] = same_bits(out, smem)
            row["differ_share_vs_smem_path"] = float(
                (out != smem).float().mean())
            if path == "fma_regs" and not row["bitwise_vs_smem_path"]:
                raise AssertionError(f"fused {label}: the register FMA path "
                                     f"differs from the shared-memory one")
            del smem
        for kw in ({"w_window": 8}, {"block_d": 32}):
            again = fused_gossip_run(x, stack, **kw)
            if not same_bits(again, out):
                raise AssertionError(f"fused {label} {kw}: not bitwise "
                                     f"equal to the default launch")
        rows.append(row)
        del ref, out, stack
    del cases, x16, x256
    x = state(16, SLICE_D, dev)
    if fused_gossip_run(x, torch.zeros((0, 16, 16), device=dev)) is not x:
        raise AssertionError("fused T=0 must return the state itself")

    # the dense step's own matrix: build_mixing_stack makes each W_t with
    # the bits gossip_mix_dense makes for that step
    lap = torch.as_tensor(sched.laplacians(), dtype=f32, device=dev)
    flags = torch.as_tensor(sched.flags[5:6], dtype=f32, device=dev)
    w = sched.alpha * flags[0]
    wmat = build_mixing_stack(lap, sched.alpha, flags, f32)[0]
    dense = {}
    matmul = torch.backends.cuda.matmul
    for label, compute, tf32 in (("bf16 wire", bf16, False),
                                 ("f32, caller enabled TF32", f32, True)):
        exact64 = torch.matmul(wmat.to(compute).double(),
                               x.to(compute).double())
        matmul.allow_tf32 = tf32
        try:
            got = gossip_mix_dense(x, lap, w, compute_dtype=compute)
            naive = torch.matmul(wmat.to(compute), x.to(compute)).float()
        finally:
            matmul.allow_tf32 = False
        torch.cuda.synchronize()
        err = max_err(got, exact64)
        bar = 1e-5 * float(x.abs().max())
        dense[label] = {"max_abs_err_vs_f64": err, "bar": bar,
                        "one_matmul_in_compute_dtype_err": max_err(naive,
                                                                   exact64)}
        if not err <= bar:
            raise AssertionError(f"dense mix {label}: {err} > {bar} against "
                                 f"the float64 product")
    emit({"phase": "fused_parity", "cases": rows, "w_window_and_tile":
          "bitwise", "T0_identity": True, "dense_mix": dense})
    return worst


def calls_device_ms(fn, flush, runs: int = 20):
    """Mean device time of one call of ``fn`` (all its kernels, the L2
    flush before each call excluded) from ``torch.profiler``, or None when
    the trace holds no device time: the library call's counterpart of
    ``device_ms``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            flush()
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "device_time_total", 0.0)
                for e in prof.key_averages() if "Fill" not in e.key)
    return total / runs / 1e3 if total else None


def path_device_ms(fn, path: str, flush, runs: int):
    """The profiler's device time of one call of ``fn`` on a fused path:
    per recorded launch of each of its kernels (the FMA chain launches
    the stack's transposed copy too), summed; None when the trace holds
    none of them."""
    names = (("fma_chain_kernel", "transpose_stack") if path == "fma"
             else ("gossip_kernel",))
    times = [device_ms(fn, name, flush, runs) for name in names]
    return None if None in times else sum(times)


def phase_fused_timing(dev, tables, big_tables):
    """Kernel (CUDA events and the profiler's device time), plain version,
    library call (T calls of ``torch.matmul(W_t, x)``, by events and by
    device time) and bound at the slice's ``[16, 273258]`` (T = 1, 4 and
    64; f32, a bf16 stack on an f32 state, and bf16: the register paths),
    and at ``[256, 273258]`` T = 64 (bf16, also at a 64-column tile, and
    f32: the shared-memory paths)."""
    flush = L2Flush(dev)
    sched, big = tables[0], big_tables[0]
    f32, bf16 = torch.float32, torch.bfloat16
    shapes = []
    for t_steps in (1, 4, 64):
        for label, x_dtype, dtype in (("f32", f32, f32),
                                      ("f32 state, bf16 stack", f32, bf16),
                                      ("bf16", bf16, bf16)):
            shapes.append((f"slice T={t_steps} {label}", sched, 16, t_steps,
                           x_dtype, dtype, 2048))
    # the 64-column tile at N = 256 reads W_t from L2 twice as often as the
    # default 128-column one
    shapes += [("hypercube N=256 T=64 bf16", big, 256, 64, bf16, bf16, 2048),
               ("hypercube N=256 T=64 bf16, tile 64", big, 256, 64, bf16,
                bf16, 64),
               ("hypercube N=256 T=64 f32", big, 256, 64, f32, f32, 2048)]
    rows = []
    for label, sch, n, t_steps, x_dtype, dtype, block_d in shapes:
        x = state(n, SLICE_D, dev).to(x_dtype)
        stack = mixing_stack(sch, t_steps, dtype, dev)
        # the FMA path at N = 256 takes about 0.1 s a call
        runs = 5 if dtype == f32 and n == 256 else 20

        def library(x=x, stack=stack):
            out = x.to(stack.dtype)
            for t in range(stack.shape[0]):
                out = torch.matmul(stack[t], out)
            return out

        def kernel(x=x, stack=stack, block_d=block_d):
            return fused_gossip_run(x, stack, block_d=block_d)

        row = {"shape": label, "N": n, "D": SLICE_D, "T": t_steps,
               "dtype": str(dtype), "state_dtype": str(x_dtype),
               "path": fused_path(x, stack), "block_d": block_d,
               "ms": time_ms(kernel, flush, runs),
               "device_ms": path_device_ms(kernel, fused_path(x, stack),
                                           flush, runs),
               "plain_ms": time_ms(lambda: fused_gossip_plain(x, stack),
                                   flush, runs),
               "library_ms": time_ms(library, flush, runs),
               "library_device_ms": calls_device_ms(library, flush, runs)}
        row["bound_ms"], row["bound_by"] = fused_bound(x, stack)
        if n == 16 and t_steps == 1:
            # a practical floor beside the bound: one copy of the state
            row["state_copy_device_ms"] = calls_device_ms(x.clone, flush,
                                                          runs)
        rows.append(row)
        emit({"phase": "fused_timing", **row})
        del x, stack

    return rows


def phase_fused_chain(dev, tables, big_tables):
    """Consensus chains through ``make_decen(..., "fused").run``: at the
    bench shape, ``[256, 273258]``, in bf16 (the shared-memory tensor
    cores) and f32 (the shared-memory FMA path), each stepped (one launch
    for the 64-step stream) and with ``chunk=64`` (the stack composed
    first, one launch); and at the slice's ``[16, 273258]`` in bf16,
    stepped (the tensor cores chained in registers).  The launch counts,
    by path, are read right after these five runs.  Each chain is held to
    the plain version on its own stack (the fused bar); the two f32 chains
    at N = 256 must also agree to the f32 bar (in bf16 the composed stack
    is rounded once and the stepped state 64 times: their gap is printed,
    not held).  Then the times of the four chains at N = 256."""
    flush = L2Flush(dev)
    sched, big = tables[0], big_tables[0]
    bf16, f32 = torch.bfloat16, torch.float32
    runs = {}
    for dtype in (bf16, f32):
        x = state(256, SLICE_D, dev).to(dtype)
        for chunk in (1, 64):
            comm = make_decen(big, "fused", device=dev, compute_dtype=dtype,
                              chunk=chunk)
            runs[f"N=256 {dtype} chunk={chunk}"] = (big, x, chunk, comm)
    runs["slice N=16 bf16 chunk=1"] = (
        sched, state(16, SLICE_D, dev).to(bf16), 1,
        make_decen(sched, "fused", device=dev, compute_dtype=bf16))
    reset_launch_counts()
    outs = {label: comm.run(x, sch.flags[:64])[0]
            for label, (sch, x, chunk, comm) in runs.items()}
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    chain = {}
    for label, (sch, x, chunk, comm) in runs.items():
        flags = torch.as_tensor(sch.flags[:64], dtype=f32, device=dev)
        stack = build_mixing_stack(sch.laplacians(), sch.alpha, flags,
                                   x.dtype)
        ref = fused_gossip_plain(x, compose_mixing_stack(stack, chunk))
        bar = fused_bar(ref, x, stack)
        err = max_err(outs[label], ref)
        chain[f"{label} vs plain max_abs_err"] = err
        chain[f"{label} vs plain bar"] = bar
        if not err <= bar:
            raise AssertionError(f"{label} chain: {err} > {bar} against the "
                                 f"plain version")
        if label == f"N=256 {f32} chunk=64":
            err = max_err(outs[label], outs[f"N=256 {f32} chunk=1"])
            bar = fused_bar(outs[f"N=256 {f32} chunk=1"], x, stack)
            chain[f"{f32} chunk=64 vs step max_abs_err"] = err
            chain[f"{f32} chunk=64 vs step bar"] = bar
            if not err <= bar:
                raise AssertionError(f"f32 chain: chunk=64 vs stepped {err} "
                                     f"> {bar}")
        if label == f"N=256 {bf16} chunk=64":
            chain[f"{bf16} chunk=64 vs step max_abs_err"] = max_err(
                outs[label], outs[f"N=256 {bf16} chunk=1"])
        del stack, ref
    del outs
    want = {"fused_gossip": 5, "fused_gossip/tensor_core": 2,
            "fused_gossip/fma": 2, "fused_gossip/tc_regs": 1}
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"the five chains launched {launches}, "
                             f"expected {want}")
    for label, (sch, x, chunk, comm) in runs.items():
        if label.startswith("N=256"):
            chain[f"{label} ms"] = time_ms(
                lambda: comm.run(x, sch.flags[:64]), flush,
                5 if x.dtype == f32 and chunk == 1 else 20)
    del runs
    emit({"phase": "fused_chain", "N": 256, "D": SLICE_D, "T": 64,
          "launches": launches, **chain})
    return launches


def phase_fused_slice(dev):
    """The fused backend's training path at full width: every step mixes
    with the dense product; each epoch's comm-split timer runs its chains
    through the fused kernel."""
    epochs = 2
    cfg = dataclasses.replace(slice_config(epochs), gossip_backend="fused")
    reset_launch_counts()
    result = train(cfg, device=dev)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    hist = result.history
    bpe = 2048 // 16 // 32
    expected = epochs * timer_chains(bpe)
    for h in hist:
        for key in ("loss", "disagreement", "test_loss_mean"):
            if not math.isfinite(h[key]):
                raise AssertionError(f"fused epoch {h['epoch']}: {key} = "
                                     f"{h[key]}")
    if (launches["fused_gossip"] != expected or launches["perm_gossip_dbuf"]
            or launches["fused_gossip/fma_regs"] != expected):
        raise AssertionError(f"fused slice launches {launches}, expected "
                             f"fused_gossip = fused_gossip/fma_regs = "
                             f"{expected} (timer chains)")
    emit({"phase": "fused_slice", "model": "resnet20", "workers": 16,
          "graphid": 4, "budget": 0.5, "batch": 32, "backend": "fused",
          "steps_per_epoch": bpe, "launches": launches,
          "expected_launches": expected,
          "ms_per_step": [h["epoch_time"] / bpe * 1e3 for h in hist],
          "comm_ms_per_step": [h["comm_time"] / bpe * 1e3 for h in hist],
          "loss": [h["loss"] for h in hist],
          "disagreement": [h["disagreement"] for h in hist]})
    return launches


LARGE_D = 4099  # an odd width near 4,099: the plain version at large N


def random_stack(n: int, t_steps: int, dtype, dev):
    """``[T, n, n]``, ``W_t = 0.5·I + U(0, 0.5/n)``: rows summing near one,
    no ``W_t`` symmetric, nothing a graph's decomposition has to make at
    N = 4095."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    eye = torch.eye(n, device=dev)
    return (0.5 * eye + torch.rand(t_steps, n, n, generator=g, device=dev)
            * (0.5 / n)).to(dtype)


def phase_fused_large(dev):
    """K3 above the shared-memory paths' old caps (843 workers on the FMA
    path, 1,424 on the tensor cores) at D = 4,099: f32 and bf16 stacks at
    N = 1024 (T = 8, hypercube) and N = 4095 (T = 1) against the plain
    version (the fused bars; an f32 stack bitwise); the per-step paths
    bitwise against the on-chip ones at an N both take (FMA at 256, tensor
    cores at 1024), and at ragged N and D (fma_step at 200 against the
    chain and 257 against the plain version, tc_step at 1025 and 1040
    against tensor_core, tensor_core against tc_step at N = 17, 64, 256,
    1000 and 1024; D = 1,031 and 4,098; both state dtypes); then
    ``make_decen(..., "fused").run`` at N = 1024 (f32 and bf16) and 2048
    (bf16), the launches counted by path."""
    f32, bf16 = torch.float32, torch.bfloat16
    worst = {"fma_step": 0.0, "tc_step": 0.0, "tensor_core": 0.0}
    rows = []
    cube = {n: hypercube_tables(dev, n)[0] for n in (256, 1024, 2048)}
    cases = []
    for state_dtype, stack_dtype in ((f32, f32), (f32, bf16), (bf16, bf16)):
        cases.append((1024, 8, state_dtype, stack_dtype,
                      lambda s=stack_dtype: mixing_stack(cube[1024], 8, s,
                                                         dev)))
        cases.append((4095, 1, state_dtype, stack_dtype,
                      lambda s=stack_dtype: random_stack(4095, 1, s, dev)))
    for n, t_steps, state_dtype, stack_dtype, make_stack in cases:
        x = state(n, LARGE_D, dev).to(state_dtype)
        stack = make_stack()
        out = fused_gossip_run(x, stack)
        ref = fused_gossip_plain(x, stack)
        torch.cuda.synchronize()
        path, err, bar = fused_path(x, stack), max_err(out, ref), \
            fused_bar(ref, x, stack)
        worst[path] = max(worst[path], err)
        rows.append({"N": n, "T": t_steps, "state": str(state_dtype),
                     "stack": str(stack_dtype), "path": path,
                     "max_abs_err": err, "bar": bar,
                     "bitwise_vs_plain": same_bits(out, ref)})
        if not err <= bar:
            raise AssertionError(f"fused N={n} {stack_dtype}: max |Δ| {err} "
                                 f"> {bar}")
        # the FMA chain per element is the plain version's product here
        if stack_dtype == f32 and not rows[-1]["bitwise_vs_plain"]:
            raise AssertionError(f"fma_step N={n}: not bitwise equal to the "
                                 f"plain version")
        del x, stack, out, ref
    # the per-step paths against the on-chip ones, bitwise
    same = {}
    for n, path, other, dtype in ((256, fg.FMA_STEP, fg.FMA, f32),
                                  (1024, fg.TC_STEP, fg.TENSOR_CORE, bf16)):
        for state_dtype in (f32, dtype):
            x = state(n, LARGE_D, dev).to(state_dtype)
            stack = compose_mixing_stack(mixing_stack(cube[n], 16, f32, dev),
                                         2).to(dtype)
            a, b = forced_run(x, stack, path), forced_run(x, stack, other)
            key = (f"{fg.PATH_NAMES[path]} vs {fg.PATH_NAMES[other]} N={n} "
                   f"state={state_dtype}")
            same[key] = same_bits(a, b)
            if not same[key]:
                raise AssertionError(f"{key}: not bitwise equal")
    # ragged N and rows of every alignment: D = 1,031 (odd: no pair
    # aligned) and 4,098 (f32 rows only 8-byte aligned); fma_step forced
    # at N = 200 against the chain and at N = 257 (the chain takes no N
    # above 256) against the plain version, tc_step at N = 1025 and 1040
    # (padded to 1040 rows) against tensor_core, and tensor_core (wgmma fed
    # by TMA) against tc_step (wgmma, the parent mainloop's bits) across
    # its range, N = 17, 64, 256, 1000 and 1024; both state dtypes, T = 3
    tc_pairs = tuple((n, fg.TENSOR_CORE, fg.TC_STEP)
                     for n in (17, 64, 256, 1000, 1024))
    for d in (1031, 4098):
        for state_dtype in (f32, bf16):
            for n, path, other in ((200, fg.FMA_STEP, fg.FMA),
                                   (257, fg.FMA_STEP, None),
                                   (1025, fg.TC_STEP, fg.TENSOR_CORE),
                                   (1040, fg.TC_STEP, fg.TENSOR_CORE),
                                   *tc_pairs):
                x = state(n, d, dev).to(state_dtype)
                stack = random_stack(n, 3, f32 if path == fg.FMA_STEP
                                     else bf16, dev)
                a = forced_run(x, stack, path)
                b = (fused_gossip_plain(x, stack) if other is None
                     else forced_run(x, stack, other))
                key = (f"{fg.PATH_NAMES[path]} vs "
                       f"{fg.PATH_NAMES.get(other, 'plain')} N={n} D={d} "
                       f"state={state_dtype}")
                same[key] = same_bits(a, b)
                if not same[key]:
                    raise AssertionError(f"{key}: not bitwise equal")
                del x, stack, a, b
    # the entry point: make_decen's fused chains
    runs = {"f32 N=1024": (cube[1024], f32), "bf16 N=1024": (cube[1024], bf16),
            "bf16 N=2048": (cube[2048], bf16)}
    inputs = {label: state(sch.num_workers, LARGE_D, dev).to(dtype)
              for label, (sch, dtype) in runs.items()}
    comms = {label: make_decen(sch, "fused", device=dev, compute_dtype=dtype)
             for label, (sch, dtype) in runs.items()}
    reset_launch_counts()
    outs = {label: comms[label].run(inputs[label], sch.flags[:8])[0]
            for label, (sch, dtype) in runs.items()}
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    want = {"fused_gossip": 3, "fused_gossip/fma_step": 1,
            "fused_gossip/tensor_core": 1, "fused_gossip/tc_step": 1}
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"the fused chains at N = 1024 and 2048 "
                             f"launched {launches}, expected {want}")
    chains = {}
    for label, (sch, dtype) in runs.items():
        x = inputs[label]
        stack = mixing_stack(sch, 8, dtype, dev)
        ref = fused_gossip_plain(x, stack)
        err, bar = max_err(outs[label], ref), fused_bar(ref, x, stack)
        chains[label] = {"path": fused_path(x, stack), "max_abs_err": err,
                         "bar": bar}
        if not err <= bar:
            raise AssertionError(f"make_decen fused {label}: {err} > {bar}")
    del inputs, outs, comms
    emit({"phase": "fused_large", "D": LARGE_D, "cases": rows,
          "per_step_vs_on_chip": same, "make_decen_run": chains,
          "launches": launches})
    return {"worst": worst, "launches": launches}


# the per-step paths' kernels: the step kernel, and what runs before the
# first step (the transposed f32 stack; the state cast to bf16, or a bf16
# state widened to f32)
STEP_KERNELS = {"fma_step": ("fma_step_kernel", "transpose_stack",
                             "cast_rows"),
                "tc_step": ("tc_step_kernel", "cast_rows")}
# the tensor cores' shared-memory mainloop (tensor_core and K4's split
# schedule), every instantiation; its spill stores fail the build phase too
MAINLOOP_KERNEL = "tc_gossip_kernel"
# the perm kernel's band path, every instantiation; likewise
BAND_KERNEL = "perm_band_kernel"


def step_spills(ptxas: dict, reports: dict) -> dict:
    """Bytes of spill stores of each per-step path's kernels, of the
    shared-memory mainloop and of the perm band kernel (the most over their
    instantiations), from the build's ptxas lines (a cached build printed
    none)."""
    out = {}
    if not reports["fused_gossip"]["cached"]:
        kernels = {**STEP_KERNELS, "tensor_core": (MAINLOOP_KERNEL,)}
        out.update({path: max(r.get("spill_stores", 0)
                              for r in ptxas["fused_gossip"]
                              if any(k in r["kernel"] for k in names))
                    for path, names in kernels.items()})
    if not reports["perm_gossip"]["cached"]:
        out["band"] = max(r.get("spill_stores", 0)
                          for r in ptxas["perm_gossip"]
                          if BAND_KERNEL in r["kernel"])
    return out


def phase_fused_sweep(dev, spills):
    """K3 with an f32 stack across N at full width (hypercubes; N = 17 a
    ring): T = 64 up to 256 workers (the FMA chain), T = 8 above (one
    launch per step); then N = 4095, T = 1, in f32 and bf16.  Kernel,
    plain version and library call (T ``torch.matmul`` calls) by CUDA
    events, the L2 flushed before each; 5 runs, 3 where a call takes tens
    of milliseconds or more.  The per-step rows also carry the profiler's
    device time of one launch of the step kernel and of a call (T step
    launches and the kernels that run once before them), and the step
    kernels' spill stores (``spills``, from ptxas)."""
    flush = L2Flush(dev)
    f32, bf16 = torch.float32, torch.bfloat16
    shapes = []
    for n in (17, 32, 64, 128, 256, 512, 1024):
        t_steps = 64 if n <= 256 else 8
        sch = (fixed_schedule(decompose(ring_graph(n), n, seed=SEED), n, 64,
                              budget=0.5, mode="bernoulli", seed=SEED)
               if n == 17 else hypercube_tables(dev, n)[0])
        shapes.append((f"sweep N={n} T={t_steps} f32", n, t_steps, f32,
                       lambda s=sch, t=t_steps: mixing_stack(s, t, f32, dev)))
    for dtype in (f32, bf16):
        shapes.append((f"N=4095 T=1 {'f32' if dtype == f32 else 'bf16'}",
                       4095, 1, dtype,
                       lambda d=dtype: random_stack(4095, 1, d, dev)))
    rows = []
    for label, n, t_steps, dtype, make_stack in shapes:
        x = state(n, SLICE_D, dev)
        stack = make_stack()
        runs = 3 if n >= 128 else 5

        def library(x=x, stack=stack):
            out = x.to(stack.dtype)
            for t in range(stack.shape[0]):
                out = torch.matmul(stack[t], out)
            return out

        row = {"shape": label, "N": n, "D": SLICE_D, "T": t_steps,
               "dtype": str(dtype), "path": fused_path(x, stack),
               "ms": time_ms(lambda: fused_gossip_run(x, stack), flush, runs),
               "plain_ms": time_ms(lambda: fused_gossip_plain(x, stack),
                                   flush, runs),
               "library_ms": time_ms(library, flush, runs), "runs": runs}
        row["bound_ms"], row["bound_by"] = fused_bound(x, stack)
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        if row["path"] in STEP_KERNELS:
            def kernel(x=x, stack=stack):
                return fused_gossip_run(x, stack)

            # per launch of each of the path's kernels (a mean over the
            # launches the trace recorded, so a dropped record does not
            # count as time saved): T step launches and one of each kernel
            # that runs before the first step
            step, *first = STEP_KERNELS[row["path"]]
            per_launch = device_ms(kernel, step, flush, runs)
            once = [device_ms(kernel, name, flush, runs) for name in first]
            row["device_ms_per_launch"] = per_launch
            row["device_ms"] = (None if per_launch is None else
                                t_steps * per_launch + sum(
                                    m for m in once if m is not None))
            row["spill_stores"] = spills.get(row["path"])
        rows.append(row)
        emit({"phase": "fused_sweep", **row})
        del x, stack
        torch.cuda.empty_cache()
    return rows


def er_tables(dev, n: int = 4096, degree: float = 30.0):
    """A connected Erdős–Rényi graph of mean degree ``degree`` on ``n``
    workers, coloured (Misra–Gries: more matchings than the slab kernel's
    tables hold at 4096 workers), each matching active with probability
    0.5."""
    edges = erdos_renyi_graph(n, degree / (n - 1), seed=SEED)
    return _tables(fixed_schedule(decompose(edges, n, seed=SEED), n, 64,
                                  budget=0.5, mode="bernoulli", seed=SEED),
                   dev)


def phase_perm_large(dev, hypercube=None, waited=None):
    """K1's band path, where no slab fits a CTA, on the 16,384-worker
    hypercube and a 4096-worker ER graph of mean degree 30 (more matchings
    than the slab tables hold).  First the times, before the bitwise
    checks' temporaries fill the card's memory: T = 1 and 4, the ER
    graph at full width and the hypercube at D = 32,768, by CUDA events and
    the profiler's device time per call (3 runs), with the plain version
    and the library call (one run each: seconds a call) and the bound; the
    hypercube at full width,
    T = 4, the kernel's time and its peak device memory, and its first
    32,768 and last 1031 columns bitwise against the plain version on those
    columns (the plain version does not fit the whole width).  Then, at D = 32,768: T = 1, 2, 3, 4 and 8, an f32
    state on both wires, a bf16 state, an alive mask and a state holding
    inf and NaN, both instantiations, bitwise against the plain version;
    the 8193-worker ring at D = 1031 (T = 1, 2, 3 and 8, both state dtypes
    and wires), bitwise; then ``make_decen(..., "perm").run`` on both
    graphs (T = 4), launches counted by path."""
    flush = L2Flush(dev)
    graphs = {"hypercube N=16384": hypercube_tables(dev, 16384, hypercube),
              "ER N=4096": er_tables(dev)}
    torch.cuda.empty_cache()
    rows = []
    for label, d in (("ER N=4096", SLICE_D), ("hypercube N=16384", 32768)):
        sch, p, part = graphs[label]
        x = state(sch.num_workers, d, dev)
        for t_steps in (1, 4):
            w = torch.as_tensor(sch.alpha * sch.flags[:t_steps],
                                dtype=torch.float32, device=dev)
            run = lambda: perm_gossip_run(x, w, p, part)  # noqa: E731
            row = {"shape": f"{label} D={d} T={t_steps}",
                   "N": sch.num_workers, "D": d, "T": t_steps,
                   "M": int(p.shape[0]), "ms": time_ms(run, flush, 3),
                   "device_ms": device_ms(run, "perm_band_kernel", flush, 3),
                   "plain_ms": time_ms(lambda: perm_gossip_plain(
                       x, w, p, part), flush, 1),
                   "library_ms": time_ms(perm_yardstick(w, p, part, x),
                                         flush, 1)}
            row["bound_ms"], row["bound_by"] = bound(x, w, p, part)
            rows.append(row)
            emit({"phase": "perm_large_timing", **row})
        del x
        torch.cuda.empty_cache()
    # the full width: x, out and two band buffers
    sch, p, part = graphs["hypercube N=16384"]
    x = state(sch.num_workers, SLICE_D, dev)
    w = torch.as_tensor(sch.alpha * sch.flags[:4], dtype=torch.float32,
                        device=dev)
    run = lambda: perm_gossip_run(x, w, p, part)  # noqa: E731
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    out = run()
    torch.cuda.synchronize()
    full = {"shape": f"hypercube N=16384 D={SLICE_D} T=4",
            "N": sch.num_workers, "D": SLICE_D, "T": 4,
            "M": int(p.shape[0]),
            "peak_bytes": torch.cuda.max_memory_allocated(dev),
            "state_bytes": x.numel() * x.element_size(),
            "finite": bool(torch.isfinite(out).all())}
    if not full["finite"]:
        raise AssertionError("perm full-width N=16384: non-finite output")
    # bands are independent by column: the first 32,768 columns (128 bands)
    # and the last 1031 (the ragged last band and the three before it)
    # against the plain version on the same columns of x
    for cols in (slice(0, 32768), slice(SLICE_D - 1031, SLICE_D)):
        ref = perm_gossip_plain(x[:, cols].contiguous(), w, p, part)
        if not same_bits(out[:, cols], ref):
            raise AssertionError(f"perm full-width N=16384 columns "
                                 f"{cols.start}:{cols.stop}: not bitwise "
                                 f"equal to the plain version")
        del ref
    full["bitwise_columns"] = [[0, 32768], [SLICE_D - 1031, SLICE_D]]
    del out
    full["ms"] = time_ms(run, flush, 3)
    full["device_ms"] = device_ms(run, "perm_band_kernel", flush, 3)
    full["bound_ms"], full["bound_by"] = bound(x, w, p, part)
    rows.append(full)
    emit({"phase": "perm_large_timing", **full})
    del x
    torch.cuda.empty_cache()
    cases = 0
    for label, (sch, p, part) in graphs.items():
        n = sch.num_workers
        x = state(n, 32768, dev)
        wild = x.clone()
        wild[3, 100], wild[n - 1, -1] = float("nan"), float("inf")
        alive = torch.ones(n, device=dev)
        alive[::5] = 0.0
        variants = (("f32", x, None, None), ("f32 bf16 wire", x, "bf16", None),
                    ("bf16 state", x.to(torch.bfloat16), None, None),
                    ("alive", x, None, alive), ("inf/NaN", wild, None, None))
        for t_steps in (1, 2, 3, 4, 8):
            w = torch.as_tensor(sch.alpha * sch.flags[:t_steps],
                                dtype=torch.float32, device=dev)
            for name, xv, wire, mask in variants:
                ref = perm_gossip_plain(xv, w, p, part, alive=mask,
                                        wire_dtype=wire)
                for dbuf in (True, False):
                    out = perm_gossip_run(xv, w, p, part, alive=mask,
                                          wire_dtype=wire, dbuf=dbuf)
                    torch.cuda.synchronize()
                    if not same_bits(out, ref):
                        raise AssertionError(f"perm {label} T={t_steps} "
                                             f"{name} dbuf={dbuf}: not "
                                             f"bitwise equal to the plain "
                                             f"version")
                    cases += 1
                del ref, out
        del x, wild, variants
    # a ragged N and an odd D: the 8193-worker ring (three matchings),
    # D = 1031 (every band's last lane short, rows off 16 bytes)
    ring = fixed_schedule(decompose(ring_graph(8193), 8193, seed=SEED), 8193,
                          8, budget=0.5, mode="bernoulli", seed=SEED)
    _, p, part = _tables(ring, dev)
    x = state(8193, 1031, dev)
    for t_steps in (1, 2, 3, 8):
        w = torch.as_tensor(ring.alpha * ring.flags[:t_steps],
                            dtype=torch.float32, device=dev)
        for xv in (x, x.to(torch.bfloat16)):
            for wire in (None, "bf16"):
                ref = perm_gossip_plain(xv, w, p, part, wire_dtype=wire)
                out = perm_gossip_run(xv, w, p, part, wire_dtype=wire)
                torch.cuda.synchronize()
                if not same_bits(out, ref):
                    raise AssertionError(f"perm ring N=8193 D=1031 "
                                         f"T={t_steps} {xv.dtype} "
                                         f"wire={wire}: not bitwise equal "
                                         f"to the plain version")
                cases += 1
    del x, ref, out
    reset_launch_counts()
    outs = {}
    for label, (sch, p, part) in graphs.items():
        x = state(sch.num_workers, 32768, dev)
        outs[label] = (x, make_decen(sch, "perm", device=dev).run(
            x, sch.flags[:4])[0])
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    if launches["perm_gossip/band"] != 2 or launches["perm_gossip_dbuf"] != 2:
        raise AssertionError(f"make_decen perm runs launched {launches}, "
                             f"expected perm_gossip/band = 2")
    for label, (sch, p, part) in graphs.items():
        x, out = outs[label]
        w = torch.as_tensor(sch.alpha * sch.flags[:4], dtype=torch.float32,
                            device=dev)
        if not same_bits(out, perm_gossip_plain(x, w, p, part)):
            raise AssertionError(f"make_decen perm {label}: not bitwise")
    del outs
    emit({"phase": "perm_large", "D": 32768, "cases": cases,
          "hypercube_schedule_wait_s": waited,
          "bitwise": True, "M": {k: int(v[1].shape[0])
                                 for k, v in graphs.items()},
          "launches": launches})
    return {"launches": launches, "timing": rows}


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


def slice_stepper(dev, iterations: int, **step_kw):
    """The slice's model, optimizer and perm communicator on the card, its
    step function (``make_train_step`` with ``step_kw``) and one seeded
    batch standing in for the loader: ``(state, step, xb, yb)``."""
    cfg = slice_config(1)
    sched = build_schedule(cfg, iterations)
    comm = make_decen(sched, "perm", device=dev)
    opt = make_optimizer(make_lr_schedule(cfg.lr, 4))
    model = select_model("resnet20", "synthetic_image", num_workers=16)
    state, flattener = init_train_state(model, 16, opt, comm, seed=SEED,
                                        device=dev)
    step = make_train_step(opt, comm, flattener, sched.flags, **step_kw)
    g = torch.Generator(device=dev).manual_seed(SEED)
    xb = torch.randn(16, 32, 32, 32, 3, generator=g, device=dev)
    yb = torch.randint(0, 10, (16, 32), generator=g, device=dev)
    return state, step, xb, yb


def phase_profile(dev, steps: int = 20, profiled: int = 5):
    """The slice's training step in steady state, outside ``train()``'s
    epoch bookkeeping: ``steps`` steps on the host clock after 3 warm-up
    steps, then ``profiled`` steps under ``torch.profiler``, whose kernels
    are summed by part of the step.  One seeded batch on the card stands in
    for the loader.  The card's idle share is 1 − (union of the kernels'
    intervals) / wall time of the profiled steps."""
    from torch.profiler import ProfilerActivity, profile

    state, step, xb, yb = slice_stepper(dev, 3 + steps + profiled)
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


def slice_state(dev, seed: int):
    """A fresh train state of the slice's model and optimizer on ``dev``
    (no step taken): the template a checkpoint is restored into."""
    cfg = slice_config(1)
    comm = make_decen(build_schedule(cfg, 5), "perm", device=dev)
    opt = make_optimizer(make_lr_schedule(cfg.lr, 4), cfg.momentum,
                         cfg.weight_decay, cfg.nesterov)
    model = select_model("resnet20", "synthetic_image", num_workers=16)
    return init_train_state(model, 16, opt, comm, seed=seed, device=dev)[0]


def state_tensors(state) -> dict:
    """Every parameter, batch-norm buffer and momentum buffer, by name."""
    out = {f"param {k}": v for k, v in state.model.named_parameters()}
    out.update({f"buffer {k}": v for k, v in state.model.named_buffers()})
    for k, p in state.model.named_parameters():
        out[f"momentum {k}"] = state.optimizer.state[p]["momentum_buffer"]
    return out


def csv_rows(folder: str) -> dict:
    """Rows of each Recorder CSV in ``folder``."""
    rows = {}
    for name in sorted(os.listdir(folder)):
        if name.endswith(".log"):
            with open(os.path.join(folder, name)) as f:
                rows[name] = len(f.read().splitlines())
    return rows


def check_csvs(folder: str, epochs: int) -> None:
    rows = csv_rows(folder)
    if len(rows) != 16 * len(SERIES) or set(rows.values()) != {epochs}:
        raise AssertionError(f"{folder}: {len(rows)} CSVs, rows "
                             f"{sorted(set(rows.values()))}; expected "
                             f"{16 * len(SERIES)} of {epochs} rows")


def phase_epoch_end(dev):
    """The end of the epoch at the slice's configuration (slice_config),
    in a temporary savePath: a 2-epoch run with ``save`` and a checkpoint
    every epoch (K1's launches, 16 × 8 CSVs of 2 rows, every journal line
    valid); a ``save_checkpoint``/``restore_checkpoint`` round trip of
    its live state, bitwise; a run resumed from the epoch-0 checkpoint in
    the same folder, whose epoch 1 agrees with the uninterrupted run's to
    1e-4 relative, whose final state (parameters, batch-norm and momentum
    buffers) is bitwise the uninterrupted run's, and whose CSVs hold 2
    rows, not 3.  ``train()`` alone makes the runs reproducible: it
    selects cuDNN's deterministic algorithms.  Its default ones sum in
    another order from run to run, and two uninterrupted runs with them
    part by far more than 1e-4 at epoch 1, whose test loss is in the
    thousands at lr 0.8 (printed as ``default_cudnn_spread``).
    Prints the host seconds of each Recorder flush and each checkpoint
    save and restore, with the checkpoint's bytes."""
    bpe = 2048 // 16 // 32
    return _epoch_end(dev, bpe, cudnn_spread(dev))


def cudnn_spread(dev) -> dict:
    """The relative gap, per metric and epoch, between two uninterrupted
    2-epoch runs of the slice on cuDNN's default algorithms.  ``train()``
    selects the deterministic ones itself (``loop._reproducible_numerics``),
    so for these two runs that switch is replaced by one that sets the
    defaults (deterministic and benchmark mode off)."""
    from matcha_tpu_torch.train import loop

    reproducible = loop._reproducible_numerics

    def defaults():
        reproducible()
        torch.backends.cudnn.deterministic = False

    loop._reproducible_numerics = defaults
    try:
        a, b = (train(slice_config(2), device=dev).history for _ in range(2))
    finally:
        loop._reproducible_numerics = reproducible
        reproducible()
    return {key: [abs(x[key] - y[key]) / max(abs(y[key]), 1e-12)
                  for x, y in zip(a, b)]
            for key in ("loss", "disagreement", "test_loss_mean")}


def _epoch_end(dev, bpe: int, spread: dict):
    with tempfile.TemporaryDirectory() as root:
        cfg = dataclasses.replace(slice_config(2), save=True, savePath=root,
                                  checkpoint_every=1)
        reset_launch_counts()
        whole = train(cfg, device=dev)
        torch.cuda.synchronize()
        launches = LAUNCHES["perm_gossip_dbuf"]
        expected = 2 * bpe + 2 * timer_chains(bpe)
        if launches != expected:
            raise AssertionError(f"perm_gossip_dbuf launched {launches} "
                                 f"times, expected {expected}")
        folder = whole.recorder.folder
        check_csvs(folder, 2)
        events = read_journal(os.path.join(folder, "events.jsonl"))
        problems = [p for e in events for p in validate_event(e)]
        kinds = [e["kind"] for e in events]
        # the explicit backend's decision record follows run_start; the
        # cost ledger's programs (the step, the timer's chain, the
        # evaluation) at their first calls; each epoch journals its
        # telemetry and heartbeat (on by default), then the detectors'
        # anomalies, if any, then the checkpoint
        epoch_kinds = ["epoch", "telemetry", "heartbeat"]
        if problems or [k for k in kinds if k != "anomaly"] != [
                "run_start", "backend", "compile", "compile", "compile",
                *epoch_kinds, "checkpoint", *epoch_kinds, "checkpoint"] \
                or [e["label"] for e in events if e["kind"] == "compile"] \
                != ["epoch_scan", "gossip_chain", "evaluate"] \
                or any(kinds[i - 1] not in ("heartbeat", "anomaly")
                       for i, k in enumerate(kinds) if k == "anomaly") \
                or events[1]["chosen"] != "perm":
            raise AssertionError(f"journal {kinds}: {problems}")
        saves = [{"seconds": e["seconds"], "bytes": e["bytes"]}
                 for e in events if e["kind"] == "checkpoint"]

        trip = os.path.join(root, "round_trip")
        t0 = time.perf_counter()
        nbytes = save_checkpoint(trip, whole.state, 1)
        save_s = time.perf_counter() - t0
        template = slice_state(dev, SEED + 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored, _ = restore_checkpoint(trip, template)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        want, got = state_tensors(whole.state), state_tensors(restored)
        differ = [k for k in want if k not in got
                  or not same_bits(got[k], want[k])]
        if differ or set(got) != set(want) \
                or restored.step != whole.state.step:
            raise AssertionError(f"round trip not bitwise: {differ[:4]}, "
                                 f"step {restored.step} vs "
                                 f"{whole.state.step}")
        del template, restored

        ckpt = os.path.join(root, f"{cfg.name}_ckpt")
        epoch0 = os.path.join(root, "from_epoch0")
        shutil.copytree(os.path.join(ckpt, "0"), os.path.join(epoch0, "0"))
        for side in ("digest-0.json", "schedule-0.json"):
            shutil.copy(os.path.join(ckpt, side), epoch0)
        reset_launch_counts()
        resumed = train(cfg, resume_dir=epoch0, device=dev)
        torch.cuda.synchronize()
        resumed_launches = LAUNCHES["perm_gossip_dbuf"]
        if resumed_launches != bpe + timer_chains(bpe):
            raise AssertionError(f"the resumed run launched K1 "
                                 f"{resumed_launches} times, expected "
                                 f"{bpe + timer_chains(bpe)} (one epoch)")
        if [h["epoch"] for h in resumed.history] != [1]:
            raise AssertionError(f"resumed epochs "
                                 f"{[h['epoch'] for h in resumed.history]}")
        rel = {}
        for key in ("loss", "disagreement", "test_loss_mean"):
            a, b = resumed.history[0][key], whole.history[1][key]
            rel[key] = abs(a - b) / max(abs(b), 1e-12)
            if not rel[key] <= 1e-4:
                raise AssertionError(f"resumed epoch 1 {key}: {a} vs {b}")
        check_csvs(folder, 2)
        final = state_tensors(resumed.state)
        differ = [k for k, v in want.items() if not same_bits(final[k], v)]
        if differ:
            raise AssertionError(f"the resumed run's final state is not "
                                 f"bitwise the uninterrupted run's: "
                                 f"{differ[:4]}")
        emit({"phase": "epoch_end", "launches": launches,
              "expected_launches": expected,
              "csvs": len(csv_rows(folder)), "journal": kinds,
              "recorder_flush_seconds": whole.recorder.flush_seconds,
              "checkpoint_saves": saves,
              "round_trip": {"bytes": nbytes, "save_seconds": save_s,
                             "restore_seconds": restore_s,
                             "bitwise": True},
              "resumed": {"launches": resumed_launches,
                          "rel_err_epoch1": rel,
                          "final_state_bitwise": True,
                          "recorder_flush_seconds":
                              resumed.recorder.flush_seconds,
                          "journal": [e["kind"] for e in
                                      resumed.recorder.events]},
              "default_cudnn_spread": spread,
              "nvidia_smi": nvidia_smi()})
    return {"launches": launches}


def phase_communicators(dev):
    """One epoch each of the centralized and the ``none`` communicators and
    of decen on the skip backend, at the slice's width: finite, no kernel
    launched; the centralized run's rows checked bitwise identical after
    every step (the checks stay on the card and are read once)."""
    from matcha_tpu_torch.train import loop

    bpe = 2048 // 16 // 32
    select = loop.select_communicator
    rows = {}
    for label, over in (("centralized", {"communicator": "centralized"}),
                        ("none", {"communicator": "none"}),
                        ("skip", {"gossip_backend": "skip"})):
        checks = []

        def checked(*args, **kwargs):
            comm = select(*args, **kwargs)

            def step(flat, carry, flags_t, alive=None):
                out, carry = comm.step(flat, carry, flags_t, alive)
                checks.append((out == out[:1]).all())
                return out, carry

            return dataclasses.replace(comm, step=step)

        loop.select_communicator = checked if label == "centralized" \
            else select
        try:
            reset_launch_counts()
            t0 = time.perf_counter()
            result = train(dataclasses.replace(slice_config(1), **over),
                           device=dev)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            loop.select_communicator = select
        if any(LAUNCHES.values()):
            raise AssertionError(f"{label}: kernels launched {LAUNCHES}")
        hist = result.history[0]
        for key in ("loss", "disagreement", "test_loss_mean"):
            if not math.isfinite(hist[key]):
                raise AssertionError(f"{label}: {key} = {hist[key]}")
        row = {"loss": hist["loss"], "disagreement": hist["disagreement"],
               "ms_per_step": hist["epoch_time"] / bpe * 1e3,
               "comm_time": hist["comm_time"], "seconds": seconds}
        if label == "centralized":
            steps = len(checks)
            if steps < bpe or not bool(torch.stack(checks).all()):
                raise AssertionError(f"centralized rows differ after a "
                                     f"step ({steps} steps checked)")
            row["steps_checked"] = steps
        rows[label] = row
    emit({"phase": "communicators", **rows})
    return rows


def phase_determinism(dev, steps: int = 20, rounds: int = 3):
    """What ``train()``'s deterministic cuDNN costs: the slice's steady
    step (``slice_stepper``) on cuDNN's default algorithms and on its
    deterministic ones, benchmark mode off both ways, in turns (the default
    first in even rounds, the deterministic first in odd ones): ``rounds``
    rounds of ``steps`` steps each way, each run after 3 warm-up steps,
    host clock around a synchronize.  Leaves the deterministic choice
    set, as ``train()`` does."""
    state, step, xb, yb = slice_stepper(dev, 2 * rounds * (steps + 3) + 1)
    ms = {"default": [], "deterministic": []}
    order = [("default", False), ("deterministic", True)]
    torch.backends.cudnn.benchmark = False
    try:
        for r in range(rounds):
            for label, det in order if r % 2 == 0 else order[::-1]:
                torch.backends.cudnn.deterministic = det
                for _ in range(3):
                    state, _ = step(state, xb, yb)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(steps):
                    state, _ = step(state, xb, yb)
                torch.cuda.synchronize()
                ms[label].append((time.perf_counter() - t0) / steps * 1e3)
    finally:
        torch.backends.cudnn.deterministic = True
    median = {k: statistics.median(v) for k, v in ms.items()}
    emit({"phase": "determinism", "steps": steps, "rounds": rounds,
          "ms_per_step": ms, "median_ms_per_step": median,
          "deterministic_over_default":
              median["deterministic"] / median["default"],
          "nvidia_smi": nvidia_smi()})
    return median


def choco_config(epochs: int, **over) -> TrainConfig:
    """BASELINE.json config 4's shape: ResNet-20 on CIFAR-shaped synthetic
    images, 64 workers on a generated Erdős–Rényi graph, MATCHA budget
    0.5, batch 32, CHOCO with top-k at ratio 0.9; 4 steps an epoch."""
    kwargs = dict(model="resnet20", dataset="synthetic_image",
                  num_workers=64, graphid=None, topology="erdos_renyi",
                  matcha=True, budget=0.5, batch_size=32,
                  communicator="choco", compressor="top_k",
                  compress_ratio=0.9, epochs=epochs, seed=SEED,
                  dataset_kwargs={"num_train": 64 * 32 * 4,
                                  "num_test": 256})
    kwargs.update(over)
    return TrainConfig(**kwargs)


def carry_tensors(state) -> dict:
    """``state_tensors`` with the communicator's carry."""
    out = state_tensors(state)
    out.update({f"carry {k}": v for k, v in state.comm_carry.items()})
    return out


def distinct_rows(idx: torch.Tensor) -> bool:
    """Every row of ``idx`` holds distinct indices."""
    ordered = idx.sort(dim=1).values
    return bool((ordered[:, 1:] != ordered[:, :-1]).all())


# kernel-name fragments of each part of a CHOCO step, checked in order
CHOCO_PARTS = (("top-k", ("topk", "sort", "radix", "bitonic", "select")),
               ("scatter", ("scatter",)))


def phase_choco(dev):
    """CHOCO at config 4's shape through ``train()``: 2 epochs of 4 steps
    with ``save`` and a checkpoint every epoch in a temporary savePath
    (finite loss and disagreement, ``comm_encode_time > 0``); the run
    resumed from the epoch-0 checkpoint, bitwise the uninterrupted one
    (parameters, batch-norm and momentum buffers, the ``{x̂, s}`` carry,
    the cursor); a small run on the card against the same run on the CPU
    (ResNet-8, 8 workers, zoo graph 0: 1e-4 relative, as ``agreement``).
    Then one ``make_choco(...).step`` at ``[64, 273258]``: CUDA events
    (median of 20, L2 flushed), the profiler's split of 5 steps into
    top-k / scatter / rest (L2 not flushed), and the byte bound (x, x̂
    and s read and written once); one step each of ``random_k``,
    ``top_k_q8`` (finite, k distinct indices a row) and a bf16 wire."""
    from torch.profiler import ProfilerActivity, profile

    from matcha_tpu_torch.communicator import make_choco
    from matcha_tpu_torch.ops import select_compressor, top_k_ratio_size

    bpe = 4
    with tempfile.TemporaryDirectory() as root:
        cfg = choco_config(2, save=True, savePath=root, checkpoint_every=1)
        t0 = time.perf_counter()
        whole = train(cfg, device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        for h in whole.history:
            for key in ("loss", "disagreement", "test_loss_mean"):
                if not math.isfinite(h[key]):
                    raise AssertionError(f"choco epoch {h['epoch']}: {key} "
                                         f"= {h[key]}")
            if not h["comm_encode_time"] > 0:
                raise AssertionError(f"choco epoch {h['epoch']}: "
                                     f"comm_encode_time "
                                     f"{h['comm_encode_time']}")
        ckpt = os.path.join(root, f"{cfg.name}_ckpt")
        epoch0 = os.path.join(root, "from_epoch0")
        shutil.copytree(os.path.join(ckpt, "0"), os.path.join(epoch0, "0"))
        for side in ("digest-0.json", "schedule-0.json"):
            shutil.copy(os.path.join(ckpt, side), epoch0)
        resumed = train(cfg, resume_dir=epoch0, device=dev)
        torch.cuda.synchronize()
    if [h["epoch"] for h in resumed.history] != [1]:
        raise AssertionError(f"choco resumed epochs "
                             f"{[h['epoch'] for h in resumed.history]}")
    want, got = carry_tensors(whole.state), carry_tensors(resumed.state)
    differ = [k for k in want if k not in got
              or not same_bits(got[k], want[k])]
    if differ or set(got) != set(want) \
            or resumed.state.step != whole.state.step:
        raise AssertionError(f"choco resume not bitwise: {differ[:4]}, "
                             f"step {resumed.state.step} vs "
                             f"{whole.state.step}")
    for key in ("loss", "disagreement", "test_loss_mean"):
        if resumed.history[0][key] != whole.history[1][key]:
            raise AssertionError(f"choco resumed epoch 1 {key}")
    sched, hist = whole.schedule, whole.history
    del whole, resumed
    torch.cuda.empty_cache()

    small = choco_config(1, model="resnet8", num_workers=8, graphid=0,
                         topology="ring", batch_size=4,
                         dataset_kwargs={"num_train": 64, "num_test": 32})
    gpu = train(small, device=dev).history[0]
    cpu = train(small, device="cpu").history[0]
    agree = {}
    for key in ("loss", "disagreement", "test_loss_mean"):
        agree[key] = abs(gpu[key] - cpu[key]) / max(abs(cpu[key]), 1e-12)
        if agree[key] > 1e-4:
            raise AssertionError(f"choco card vs CPU {key}: {gpu[key]} vs "
                                 f"{cpu[key]}")

    n, d, ratio = sched.num_workers, SLICE_D, 0.9
    k = top_k_ratio_size(d, ratio)
    flush = L2Flush(dev)
    x = state(n, d, dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    carry = {"x_hat": x + 0.01 * torch.randn(n, d, generator=g, device=dev),
             "s": x.clone()}
    row = next(t for t in range(sched.iterations) if sched.flags[t].any())
    flags_t = torch.as_tensor(sched.flags[row], dtype=torch.float32,
                              device=dev)
    comm = make_choco(sched, ratio=ratio, device=dev)
    run = lambda: comm.step(x, carry, flags_t)  # noqa: E731
    step_ms = time_ms(run, flush)
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            run()
        torch.cuda.synchronize()
    parts = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        part = next((label for label, keys in CHOCO_PARTS
                     if any(k in e.name.lower() for k in keys)), "rest")
        parts[part] = parts.get(part, 0.0) \
            + e.time_range.elapsed_us() / 1e3 / 5
    bound_ms = 6 * n * d * 4 / HBM_BYTES_PER_S * 1e3
    topk_ms = time_ms(lambda: torch.topk(x.abs(), k, dim=-1, sorted=False),
                      flush)
    others = {}
    for label, kw in (("random_k", {"compressor": "random_k"}),
                      ("top_k_q8", {"compressor": "top_k_q8"}),
                      ("wire_bf16", {"wire_dtype": "bf16"})):
        other = make_choco(sched, ratio=ratio, seed=SEED, device=dev, **kw)
        c = dict(carry)
        if "key" in other.init(x):
            c["key"] = other.init(x)["key"]
        out, new = other.step(x, c, flags_t)
        if not all(bool(torch.isfinite(t).all())
                   for t in (out, new["x_hat"], new["s"])):
            raise AssertionError(f"choco {label}: a non-finite value")
        entry = {"ms": time_ms(lambda: other.step(x, c, flags_t), flush)}
        if label != "wire_bf16":
            gen = torch.Generator(device=dev).manual_seed(SEED)
            _, idx = select_compressor(label)(x - carry["x_hat"], ratio, gen)
            if tuple(idx.shape) != (n, k) or not distinct_rows(idx):
                raise AssertionError(f"choco {label}: indices "
                                     f"{tuple(idx.shape)} not k={k} "
                                     f"distinct a row")
            entry["distinct_k"] = k
        others[label] = entry
    result = {"phase": "choco", "workers": n, "D": d, "k": k,
              "matchings": int(sched.perms.shape[0]),
              "alpha": float(sched.alpha), "train_seconds": seconds,
              "ms_per_step": [h["epoch_time"] / bpe * 1e3 for h in hist],
              "comm_ms_per_step": [h["comm_time"] / bpe * 1e3
                                   for h in hist],
              "comm_encode_ms_per_step": [h["comm_encode_time"] / bpe * 1e3
                                          for h in hist],
              "loss": [h["loss"] for h in hist],
              "disagreement": [h["disagreement"] for h in hist],
              "resume_bitwise": True, "card_vs_cpu_rel_err": agree,
              "step_ms": step_ms, "step_parts_ms": parts,
              "topk_alone_ms": topk_ms, "bound_ms": bound_ms,
              "bound_by": "bytes", "others": others,
              "nvidia_smi": nvidia_smi()}
    emit(result)
    return result


def imagenet_npz(path: str, images: int, tests: int) -> str:
    """A seeded ImageNet-shaped ``.npz`` (224×224×3 uint8 pixels, labels in
    1,000 classes with class 999 present, so ``load_npz`` counts 1,000)."""
    rng = np.random.default_rng(SEED)
    y = rng.integers(0, 1000, images + tests).astype(np.int32)
    y[0] = 999
    np.savez(path, x_train=rng.integers(0, 256, (images, 224, 224, 3),
                                        dtype=np.uint8),
             y_train=y[:images],
             x_test=rng.integers(0, 256, (tests, 224, 224, 3),
                                 dtype=np.uint8),
             y_test=y[images:])
    return path


def model_cells(root: str) -> list:
    """(label, TrainConfig, classes, input shape) of the reference's other
    models at their full widths, one epoch of 2 steps on the perm backend:
    VGG-16 on 8 workers, zoo graph 0 (config 2); WRN-28-10 on 16 workers,
    zoo graph 4 (the paper's ER graph), 100 classes at the CIFAR shape
    (config 3); the ImageNet ResNet-50 at 224×224×3, 1,000 classes, on 4
    workers of a ring (config 5's model; its 256 workers do not fit one
    card), batch 8."""
    common = dict(matcha=True, budget=0.5, gossip_backend="perm", epochs=1,
                  seed=SEED)
    return [
        ("vgg16", TrainConfig(
            model="vgg16", dataset="synthetic_image", num_workers=8,
            graphid=0, batch_size=32,
            dataset_kwargs={"num_train": 8 * 32 * 2, "num_test": 32},
            **common), 10, (32, 32, 3)),
        ("wrn-28-10", TrainConfig(
            model="wrn", dataset="synthetic", num_workers=16, graphid=4,
            batch_size=32,
            dataset_kwargs={"num_train": 16 * 32 * 2, "num_test": 32,
                            "shape": (32, 32, 3), "num_classes": 100},
            **common), 100, (32, 32, 3)),
        ("resnet50-imagenet", TrainConfig(
            model="resnet50", dataset="imagenet",
            datasetRoot=imagenet_npz(os.path.join(root, "imagenet.npz"),
                                     4 * 8 * 2, 16),
            num_workers=4, graphid=None, topology="ring", batch_size=8,
            **common), 1000, (224, 224, 3)),
    ]


def model_step(dev, cfg, classes, shape, remat=False, grad_chunk=None,
               deterministic=True):
    """Two training steps of ``cfg``'s model on one seeded batch, through
    ``make_train_step`` with the perm communicator of its schedule: the
    second step's ms (host clock around a synchronize), the peak device
    memory over both, and ``(schedule, D)`` for K1's timing.
    ``deterministic`` off runs the steps on cuDNN's default algorithms
    (``train()`` takes the deterministic ones)."""
    torch.backends.cudnn.deterministic = deterministic
    try:
        return _model_step(dev, cfg, classes, shape, remat, grad_chunk)
    finally:
        torch.backends.cudnn.deterministic = True


def _model_step(dev, cfg, classes, shape, remat, grad_chunk):
    n, b = cfg.num_workers, cfg.batch_size
    sched = build_schedule(cfg, 3)
    comm = make_decen(sched, "perm", device=dev)
    model = select_model(cfg.model, cfg.dataset, num_classes=classes,
                         num_workers=n, input_shape=shape, remat=remat)
    opt = make_optimizer(make_lr_schedule(0.1, 2))
    st, flattener = init_train_state(model, n, opt, comm, seed=SEED,
                                     device=dev)
    step = make_train_step(opt, comm, flattener, sched.flags,
                           grad_chunk=grad_chunk)
    g = torch.Generator(device=dev).manual_seed(SEED)
    xb = torch.randn((n, b) + tuple(shape), generator=g, device=dev)
    yb = torch.randint(0, classes, (n, b), generator=g, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    st, _ = step(st, xb, yb)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, metrics = step(st, xb, yb)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    loss = float(metrics["loss"])
    if not math.isfinite(loss):
        raise AssertionError(f"{cfg.model}: loss {loss}")
    row = {"ms_second_step": ms,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "loss": loss}
    return row, sched, flattener.dim


def phase_models(dev):
    """The reference's other models through ``train()`` on the perm
    backend (``model_cells``): finite, and K1 launched once a step and
    twice for the comm-split timer, as in the slice phase.  Then each
    model's step (``model_step``: ms of the second step, peak memory),
    WRN-28-10 with ``remat`` off and on and with ``grad_chunk=4`` against
    none, and each also on cuDNN's default algorithms; and K1 at the
    model's D, T = 1 (the per-step mix): the profiler's device time (L2
    flushed) against its byte bound, with its plain version and the
    library call (``perm_yardstick``: one ``torch.matmul(W_t, x)``), 5
    runs each."""
    flush = L2Flush(dev)
    rows = {}
    with tempfile.TemporaryDirectory() as root:
        for label, cfg, classes, shape in model_cells(root):
            reset_launch_counts()
            t0 = time.perf_counter()
            result = train(cfg, device=dev)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            hist = result.history[0]
            launches = LAUNCHES["perm_gossip_dbuf"]
            expected = 2 + timer_chains(2)
            if launches != expected:
                raise AssertionError(f"{label}: K1 launched {launches} "
                                     f"times, expected {expected}")
            for key in ("loss", "disagreement", "test_loss_mean"):
                if not math.isfinite(hist[key]):
                    raise AssertionError(f"{label}: {key} = {hist[key]}")
            del result
            torch.cuda.empty_cache()
            variants = [("plain", {}),
                        ("plain, cuDNN default", {"deterministic": False})]
            if label == "wrn-28-10":
                variants += [("remat", {"remat": True}),
                             ("grad_chunk=4", {"grad_chunk": 4})]
            steps = {}
            for name, kw in variants:
                steps[name], sched, d = model_step(dev, cfg, classes, shape,
                                                   **kw)
                torch.cuda.empty_cache()
            sched, perms, partnered = _tables(sched, dev)
            x = state(cfg.num_workers, d, dev)
            w = torch.as_tensor(sched.alpha * sched.flags[:1],
                                dtype=torch.float32, device=dev)
            run = lambda: perm_gossip_run(x, w, perms, partnered)  # noqa
            k1_bound, bound_by = bound(x, w, perms, partnered)
            plain_ms = time_ms(lambda: perm_gossip_plain(x, w, perms,
                                                         partnered),
                               flush, runs=5)
            library_ms = time_ms(perm_yardstick(w, perms, partnered, x),
                                 flush, runs=5)
            rows[label] = {
                "workers": cfg.num_workers, "batch": cfg.batch_size,
                "D": d, "train_seconds": seconds, "launches": launches,
                "expected_launches": expected, "loss": hist["loss"],
                "disagreement": hist["disagreement"], "steps": steps,
                "k1_ms": time_ms(run, flush),
                "k1_device_ms": device_ms(run, "perm_gossip_kernel", flush),
                "k1_plain_ms": plain_ms, "k1_library_ms": library_ms,
                "k1_bound_ms": k1_bound, "k1_bound_by": bound_by}
            emit({"phase": "models", "model": label, **rows[label]})
            del x
            torch.cuda.empty_cache()
    emit({"phase": "models_done", "nvidia_smi": nvidia_smi()})
    return rows


PIPELINES = (("1step", {"overlap": "1step"}),
             ("staleness=2", {"overlap": "1step", "staleness": 2}),
             ("staleness=4", {"overlap": "1step", "staleness": 4}),
             ("staleness=2, local_steps=2",
              {"overlap": "1step", "staleness": 2, "local_steps": 2}))
TIMED_PIPELINES = (("eager", {}), ("1step", {"overlap": "1step"}),
                   ("staleness=2", {"overlap": "1step", "staleness": 2}),
                   ("local_steps=2", {"local_steps": 2}))


def flat_params(state) -> torch.Tensor:
    """The ``[N, D]`` parameter stack in the flattener's order (the order
    of the pending deltas' columns)."""
    params = state.params
    return WorkerFlattener(params).flatten(params)


class PendingWatch:
    """Wraps ``loop._drain_mix_pending`` and ``loop._reconcile_mix_pending``
    for the runs in its block and records, around each, the worker mean of
    the parameters and the column means of the in-flight deltas: a drain
    moves the worker mean by their sum, which is 0 up to f32 rounding.
    ``check(per_delta)`` raises where the mean after differs from the mean
    before plus those column means, or where they are not 0, by more than
    ``per_delta`` times the largest parameter per delta in flight, and
    returns the worst ratio."""

    def __init__(self):
        from matcha_tpu_torch.train import loop

        self.loop, self.records = loop, []

    def _wrap(self, name):
        inner = getattr(self.loop, name)

        def wrapped(state, *args, **kwargs):
            pend = state.mix_pending
            delta_mean = (None if not isinstance(pend, torch.Tensor) else
                          pend.reshape(pend.shape[0], -1, flat_params(state)
                                       .shape[1]).sum(1).mean(0))
            before = flat_params(state).mean(0)
            out = inner(state, *args, **kwargs)
            if delta_mean is not None:
                after = flat_params(out)
                self.records.append((name, before, delta_mean,
                                     after.mean(0),
                                     float(after.abs().max()),
                                     pend.shape[1] if pend.ndim == 3 else 1))
            return out

        return wrapped

    def __enter__(self):
        self.saved = {name: getattr(self.loop, name) for name in
                      ("_drain_mix_pending", "_reconcile_mix_pending")}
        for name in self.saved:
            setattr(self.loop, name, self._wrap(name))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.loop, name, fn)

    def check(self, per_delta: float = 1e-6) -> float:
        worst = 0.0
        for name, before, delta_mean, after, scale, k in self.records:
            bar = per_delta * k * scale
            drift = float((after - before - delta_mean).abs().max())
            pending = float(delta_mean.abs().max())
            if drift > bar or pending > bar:
                raise AssertionError(
                    f"{name}: the worker mean after differs by {drift} from "
                    f"the mean before plus the deltas' column means "
                    f"({pending}), bar {bar}")
            worst = max(worst, drift / scale, pending / scale)
        return worst


def pipeline_run(dev, label: str, over: dict, **kw):
    """``train()`` of the slice, 2 epochs, with the pipeline ``over`` and
    the other fields ``kw``: finite, K1 launched once per issued
    (unthinned) step plus the timer's chains, returned drained.  Returns
    ``(result, row)``."""
    bpe = 2048 // 16 // 32
    cfg = dataclasses.replace(slice_config(2), **over, **kw)
    reset_launch_counts()
    t0 = time.perf_counter()
    result = train(cfg, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    first = cfg.epochs - len(result.history)
    issued = sum(1 for t in range(first * bpe, cfg.epochs * bpe)
                 if t % cfg.local_steps == 0)
    expected = issued + len(result.history) * timer_chains(bpe)
    launches = LAUNCHES["perm_gossip_dbuf"]
    if launches != expected:
        raise AssertionError(f"{label}: K1 launched {launches} times, "
                             f"expected {expected} (issued steps + timer "
                             f"chains)")
    for h in result.history:
        for key in ("loss", "disagreement", "test_loss_mean"):
            if not math.isfinite(h[key]):
                raise AssertionError(f"{label}: epoch {h['epoch']} {key} = "
                                     f"{h[key]}")
    if not bool(torch.isfinite(flat_params(result.state)).all()):
        raise AssertionError(f"{label}: final parameters not finite")
    pend = result.state.mix_pending
    if isinstance(pend, torch.Tensor) and bool(pend.any()):
        raise AssertionError(f"{label}: train() returned an undrained "
                             f"pipeline")
    return result, {"launches": launches, "expected_launches": expected,
                    "issued_steps": issued, "seconds": seconds,
                    "ms_per_step": [h["epoch_time"] / bpe * 1e3
                                    for h in result.history],
                    "loss": [h["loss"] for h in result.history],
                    "disagreement": [h["disagreement"]
                                     for h in result.history]}


# the fault plan of the resilience phase: every event kind; the
# straggler's window lies in epoch 1 only, so that alive_workers is exact
# in epochs 0 and 2
RESILIENCE_PLAN = (
    {"kind": "dead", "worker": 3, "start": 0, "stop": 4},
    {"kind": "nan", "worker": 5, "start": 5},
    {"kind": "straggler", "worker": 9, "start": 4, "stop": 8, "period": 2},
    {"kind": "link_down", "matching": 0, "start": 8, "stop": 10},
    {"kind": "flaky_link", "start": 0, "drop_prob": 0.2, "seed": 7},
)
# the pool shrinks from 16 to 12 at epoch 1 and grows back at epoch 2
SHRINK_TRACE = {"events": (
    [{"kind": "leave", "epoch": 1, "worker": f"w{w}"} for w in range(12, 16)]
    + [{"kind": "rejoin", "epoch": 2, "worker": f"w{w}"}
       for w in range(12, 16)])}


def state_digest(state) -> str:
    """sha256 of every tensor of a train state (parameters, buffers,
    momentum, carry, pending deltas) and its cursor."""
    h = hashlib.sha256()
    for t in all_state_tensors(state):
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    h.update(str(int(state.step)).encode())
    return h.hexdigest()


class LoopWatch:
    """Wraps functions of ``train/loop.py`` (``name -> wrapper(inner)``)
    for the runs in its block."""

    def __init__(self, **wrappers):
        from matcha_tpu_torch.train import loop

        self.loop, self.wrappers = loop, wrappers

    def __enter__(self):
        self.saved = {name: getattr(self.loop, name) for name in self.wrappers}
        for name, wrap in self.wrappers.items():
            setattr(self.loop, name, wrap(self.saved[name]))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.loop, name, fn)


def k1_expected(result, bpe: int, rollbacks: int = 0) -> int:
    """K1's launches of a perm ``train()`` whose every step mixes: one per
    step run (a rolled-back epoch runs twice) and the timer's chains of
    each completed epoch."""
    steps = (len(result.history) + rollbacks) * bpe
    return steps + len(result.history) * timer_chains(bpe)


def resilience_run(dev, label: str, root: str, rollbacks: int = 0, **kw):
    """``train()`` of the slice for 3 epochs with ``kw``, K1 counted;
    returns ``(result, row)``."""
    bpe = 2048 // 16 // 32
    cfg = dataclasses.replace(slice_config(3), savePath=root,
                              name=label.replace(" ", "_"), **kw)
    reset_launch_counts()
    t0 = time.perf_counter()
    result = train(cfg, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = LAUNCHES["perm_gossip_dbuf"]
    expected = k1_expected(result, bpe, rollbacks)
    if launches != expected:
        raise AssertionError(f"{label}: K1 launched {launches} times, "
                             f"expected {expected}")
    for h in result.history:
        if not math.isfinite(h["loss"]):
            raise AssertionError(f"{label}: epoch {h['epoch']} loss "
                                 f"{h['loss']}")
    return result, {"launches": launches, "seconds": seconds,
                    "ms_per_step": [h["epoch_time"] / bpe * 1e3
                                    for h in result.history],
                    "loss": [h["loss"] for h in result.history],
                    "disagreement": [h["disagreement"]
                                     for h in result.history],
                    "alive_workers": [h.get("alive_workers")
                                      for h in result.history]}


def phase_resilience(dev, rounds: int = 3):
    """Resilience and elastic membership at the slice's width
    (``slice_config``: ResNet-20, 16 workers, graph 4, perm backend, 3
    epochs of 4 steps):

    1. Chaos: ``RESILIENCE_PLAN`` (every event kind).  The run finishes;
       ``alive_workers`` is 15 in epoch 0 and 16 in epoch 2; the ``plan``
       and ``healed`` events are in ``faults.json``; worker 3's evaluation
       is a NaN gap in epoch 0; the detector's rows at each epoch boundary
       are finite on every worker outside the quarantine.  K1 launched
       once per step (with that step's survivor mask) plus the timer's
       chains.
    2. K1 on the sealed, masked state: the inputs of the launches at step
       1 (worker 3 dead) and step 5 (worker 5's NaN healed, the straggler
       worker 9 out) are captured and each launch held bitwise against
       ``perm_gossip_plain`` on them.  Then step 5's input poisoned where
       the step's mask is 0 (worker 9's row NaN) goes through
       ``gossip_quarantined`` with the step's
       weights and mask: K1 on the sealed state, bitwise its plain
       version; no survivor row of the output is non-finite, and the
       poisoned row comes back as it went in.
    3. Rollback: a NaN on all 16 workers at step 5 with
       ``max_recoveries=1``: a ``rollback`` at epoch 1 with ``lr_scale``
       0.5; the state the retry starts from has the digest of the state
       snapshotted before epoch 1; the final loss finite.  The snapshot's
       bytes and the time of its clone.
    4. Membership: ``SHRINK_TRACE`` (16 → 12 at epoch 1, back at epoch 2,
       ``bootstrap="mean"``, hysteresis 0), eager and at ``staleness=2``:
       the vacant rows bitwise unchanged across epoch 1; the joined rows
       bitwise the donors' mean (``masked_mean_rows`` of the continuing
       rows); α of each ``membership`` event ``refold_for``'s; a run
       resumed from the checkpoint written at the end of epoch 1 bitwise
       the uninterrupted one (the ring of the epoch-2 checkpoint too).
    5. ms per step of epoch 2 with and without the fault plan, ``rounds``
       rounds, the order reversed every other round; the steady step
       outside ``train()`` (20 steps a round, ``slice_stepper``) with and
       without the plan, alternated; and the heal alone
       (``heal_and_mask`` on the slice's ``[16, 273258]`` with a NaN row
       and a dead worker) against one copy of the state, by CUDA events
       with the L2 flushed (``time_ms``).
    """
    from matcha_tpu_torch.communicator import decen
    from matcha_tpu_torch.parallel import masked_mean_rows
    from matcha_tpu_torch.resilience import FaultEvent, FaultPlan

    bpe = 2048 // 16 // 32
    t_phase = time.perf_counter()
    plan = FaultPlan(tuple(FaultEvent(**e) for e in RESILIENCE_PLAN),
                     name="chip_smoke")
    out = {"launches": {}}
    with tempfile.TemporaryDirectory() as root:
        # 1 and 2: chaos, with the detector's rows and K1's inputs watched
        rows, captured = [], {}
        inner_run = decen.perm_gossip_run
        masked_calls = [0]

        def capture_k1(x, weights, perms, partnered, **kw):
            y = inner_run(x, weights, perms, partnered, **kw)
            if kw.get("alive") is not None:
                step = masked_calls[0]
                masked_calls[0] += 1
                if step in (1, 5):
                    captured[step] = (x.clone(), weights.clone(), perms,
                                      partnered, kw["alive"].clone(),
                                      y.clone(), kw)
            return y

        def watch_rows(inner):
            def detector(state, n):
                got = inner(state, n)
                rows.append((int(state.step), got.cpu().numpy()))
                return got
            return detector

        decen.perm_gossip_run = capture_k1
        try:
            with LoopWatch(state_finite_rows=watch_rows):
                chaos, row = resilience_run(dev, "chaos", root,
                                            fault_plan=plan, save=True)
        finally:
            decen.perm_gossip_run = inner_run
        alive = row["alive_workers"]
        if alive[0] != 15.0 or alive[2] != 16.0:
            raise AssertionError(f"chaos: alive_workers {alive}")
        faults = plan.compile(chaos.schedule.iterations, 16,
                              chaos.schedule.num_matchings)
        for cursor, finite in rows:
            survivors = faults.dead_alive[cursor - 1] > 0
            if not finite[survivors].all():
                raise AssertionError(f"chaos: a survivor row is not finite "
                                     f"at step {cursor}: {finite}")
        folder = chaos.recorder.folder
        with open(os.path.join(folder, "faults.json")) as f:
            kinds = [e["kind"] for e in json.load(f)["events"]]
        if "plan" not in kinds or "healed" not in kinds:
            raise AssertionError(f"chaos: faults.json holds {kinds}")
        tacc = np.asarray(chaos.recorder.data["tacc"][0])
        if not np.isnan(tacc[3]) or not np.isfinite(np.delete(tacc, 3)).all():
            raise AssertionError(f"chaos: epoch 0 evaluation {tacc}")
        out["chaos"] = {**row, "fault_kinds": kinds,
                        "detector_rows": [[c, f.tolist()] for c, f in rows],
                        "healed": [h["healed"] for h in chaos.history]}
        del chaos
        seals = {}
        for step, (x, w, perms, partnered, av, y, kw) in captured.items():
            extra = {k: v for k, v in kw.items() if k != "alive"}
            plain = perm_gossip_plain(x, w, perms, partnered, alive=av,
                                      **extra)
            seals[step] = {
                "bitwise": same_bits(y, plain), "alive": av.tolist(),
                "survivors_finite": bool(torch.isfinite(y[av > 0]).all())}
            if not seals[step]["bitwise"] \
                    or not seals[step]["survivors_finite"]:
                raise AssertionError(f"K1 at step {step}: {seals[step]}")
        if sorted(seals) != [1, 5] or seals[1]["alive"][3] != 0.0 \
                or seals[5]["alive"][9] != 0.0:
            raise AssertionError(f"K1's masked inputs: {seals}")
        # step 5's input, poisoned where its mask is 0, through the seal
        x, w, perms, partnered, av, _, kw = captured[5]
        extra = {k: v for k, v in kw.items() if k != "alive"}
        poisoned = x.clone()
        poisoned[9] = float("nan")

        def sealed_step(run):
            def step_fn(flat, carry, flags_t, ok):
                return run(flat, w, perms, partnered, alive=ok,
                           **extra), carry
            return step_fn

        gate = finite_rows(poisoned)
        got, _ = gossip_quarantined(sealed_step(perm_gossip_run), poisoned,
                                    (), None, av, gate=gate)
        want, _ = gossip_quarantined(sealed_step(perm_gossip_plain),
                                     poisoned, (), None, av, gate=gate)
        seals["poisoned"] = {
            "bitwise": same_bits(got, want),
            "survivors_finite": bool(torch.isfinite(got[av > 0]).all()),
            "poisoned_row_kept": bool(torch.isnan(got[9]).all())}
        if not all(seals["poisoned"].values()):
            raise AssertionError(f"K1 on the sealed state: {seals}")
        out["k1_sealed"] = seals
        del captured, poisoned, got, want

        # 3. rollback, from the snapshot bitwise
        digests, clone = {}, []

        def watch_snapshot(inner):
            def snap(state):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                s = inner(state)
                torch.cuda.synchronize()
                clone.append((time.perf_counter() - t0, sum(
                    x.numel() * x.element_size()
                    for value in s.values() for x in tensors_in(value))))
                digests.setdefault(("snapshot", int(state.step)),
                                   state_digest(state))
                return s
            return snap

        def watch_restore(inner):
            def restore(state, snapshot):
                s = inner(state, snapshot)
                digests[("restored", int(s.step))] = state_digest(s)
                return s
            return restore

        all_nan = FaultPlan(tuple(FaultEvent("nan", 5, worker=w)
                                  for w in range(16)))
        with LoopWatch(_snapshot_state=watch_snapshot,
                       _restore_snapshot=watch_restore):
            rolled, row = resilience_run(dev, "rollback", root, rollbacks=1,
                                         fault_plan=all_nan,
                                         max_recoveries=1)
        events = {e["kind"]: e for e in rolled.recorder.faults}
        back = events.get("rollback", {})
        if back.get("epoch") != 1 or back.get("lr_scale") != 0.5:
            raise AssertionError(f"rollback: {rolled.recorder.faults}")
        if digests.get(("restored", bpe)) != digests.get(("snapshot", bpe)):
            raise AssertionError(f"rollback: the retry does not start from "
                                 f"the snapshot: {digests}")
        out["rollback"] = {**row, "rollback": back,
                           "retry_from_snapshot_bitwise": True,
                           "snapshot_bytes": [c[1] for c in clone],
                           "snapshot_clone_ms": [c[0] * 1e3 for c in clone]}
        del rolled

        # 4. membership, eager and staleness 2
        joined = torch.zeros(16, device=dev)
        joined[12:] = 1.0
        donors = 1.0 - joined
        member = {}
        for label, over in (("eager", {}),
                            ("staleness=2", {"overlap": "1step",
                                             "staleness": 2})):
            seen = {}

            def watch_step(inner):
                def make(*args, **kwargs):
                    step = inner(*args, **kwargs)

                    def watched(state, xb, yb):
                        if state.step == bpe:
                            seen["vacant_before"] = flat_params(
                                state)[12:].clone()
                        if state.step == 2 * bpe:
                            seen["joined"] = flat_params(state)[12:].clone()
                        state, metrics = step(state, xb, yb)
                        if state.step == 2 * bpe:
                            f = flat_params(state)
                            seen["vacant_after"] = f[12:].clone()
                            seen["donor_mean"] = masked_mean_rows(f, donors)
                        return state, metrics
                    return watched
                return make

            name = f"member {label}"
            kw = dict(over, membership_trace=SHRINK_TRACE,
                      checkpoint_every=1)
            with LoopWatch(make_train_step=watch_step):
                whole, row = resilience_run(dev, name, root, **kw)
            frozen = same_bits(seen["vacant_before"], seen["vacant_after"])
            mean_rows = all(same_bits(r, seen["donor_mean"])
                            for r in seen["joined"])
            alphas = [(e["alpha"], whole.schedule.refold_for(
                np.asarray(e["new_alive"], np.float32))[0])
                for e in whole.recorder.events if e["kind"] == "membership"]
            if not frozen or not mean_rows or len(alphas) != 2 \
                    or any(a != b for a, b in alphas):
                raise AssertionError(f"{name}: vacant rows frozen {frozen}, "
                                     f"joined rows the donor mean "
                                     f"{mean_rows}, alphas {alphas}")
            if row["alive_workers"] != [16.0, 12.0, 16.0]:
                raise AssertionError(f"{name}: alive {row['alive_workers']}")
            want = state_tensors(whole.state)
            ckpt = os.path.join(root, f"member_{label}_ckpt")
            at_shrink = os.path.join(root, f"at_shrink_{label}")
            shutil.copytree(os.path.join(ckpt, "1"),
                            os.path.join(at_shrink, "1"))
            for side in ("digest-1.json", "schedule-1.json",
                         "membership-1.json"):
                shutil.copy(os.path.join(ckpt, side), at_shrink)
            resumed, rrow = resilience_run(dev, f"resumed {label}", root,
                                           **dict(kw, resume=at_shrink))
            if [h["epoch"] for h in resumed.history] != [2]:
                raise AssertionError(f"resumed {label}: {resumed.history}")
            got = state_tensors(resumed.state)
            differ = [k for k, v in want.items() if not same_bits(got[k], v)]
            ring_equal = None
            if over:
                rings = [torch.load(os.path.join(root, d, "2", "state.pt"),
                                    map_location="cpu",
                                    weights_only=True)["mix_pending"]
                         for d in (f"member_{label}_ckpt",
                                   f"resumed_{label}_ckpt")]
                ring_equal = same_bits(*rings) and bool(rings[0].any())
            if differ or ring_equal is False:
                raise AssertionError(f"resumed {label}: differs in "
                                     f"{differ[:4]}, ring {ring_equal}")
            member[label] = {**row, "vacant_frozen_bitwise": True,
                             "joined_equal_donor_mean": True,
                             "alphas": [a for a, _ in alphas],
                             "resumed_bitwise": True,
                             "ring_bitwise": ring_equal,
                             "resumed_launches": rrow["launches"]}
            del whole, resumed
        out["membership"] = member

        # 5. ms per step of epoch 2, with and without the plan
        ms = {"no plan": [], "fault plan": []}
        cases = (("no plan", {}), ("fault plan", {"fault_plan": plan}))
        for r in range(rounds):
            for label, kw in (cases if r % 2 == 0 else cases[::-1]):
                _, row = resilience_run(dev, f"timed {label}", root, **kw)
                ms[label].append(row["ms_per_step"][2])
                out["launches"][f"timed {label}"] = out["launches"].get(
                    f"timed {label}", 0) + row["launches"]
        # the steady step outside train(): 20 steps after 3 warm-up steps,
        # with and without the plan, alternated
        steady = {"no plan": [], "fault plan": []}
        iterations = 2 * rounds * 23 + 1
        steppers = {"no plan": slice_stepper(dev, iterations),
                    "fault plan": slice_stepper(dev, iterations,
                                                faults=plan.compile(
                                                    iterations, 16,
                                                    build_schedule(
                                                        slice_config(1),
                                                        iterations)
                                                    .num_matchings))}
        for r in range(rounds):
            order = list(steppers) if r % 2 == 0 else list(steppers)[::-1]
            for label in order:
                st, step, xb, yb = steppers[label]
                for _ in range(3):
                    st, _ = step(st, xb, yb)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(20):
                    st, _ = step(st, xb, yb)
                torch.cuda.synchronize()
                steady[label].append((time.perf_counter() - t0) / 20 * 1e3)
        del steppers
        x = state(16, SLICE_D, dev)
        x[5] = float("nan")
        alive_t = torch.ones(16, device=dev)
        alive_t[3] = 0.0
        revive_t = torch.zeros(16, device=dev)
        flush = L2Flush(dev)
        heal_ms = time_ms(lambda: heal_and_mask(x, alive_t, revive_t), flush)
        copy_ms = time_ms(lambda: x.clone(), flush)
        del x, flush
        out["timing"] = {"heal_and_mask_ms": heal_ms,
                         "state_copy_ms": copy_ms,
                         "heal_in_state_copies": heal_ms / copy_ms,
                         "steady_ms_per_step": steady,
                         "median_steady_ms_per_step": {
                             k: statistics.median(v)
                             for k, v in steady.items()},
                         "ms_per_step_epoch2": ms,
                         "median_ms_per_step": {k: statistics.median(v)
                                                for k, v in ms.items()},
                         "rounds": rounds}
    out["launches"].update({
        "train() fault plan (chaos)": out["chaos"]["launches"],
        "train() rollback": out["rollback"]["launches"],
        **{f"train() membership {k}": v["launches"] + v["resumed_launches"]
           for k, v in member.items()}})
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "resilience", **out, "nvidia_smi": nvidia_smi()})
    return out


def phase_pipeline(dev, tables, rounds: int = 3):
    """The pipelined schedule at the slice's width (``slice_config``: 2
    epochs of 4 steps, perm backend, f32 wire):

    1. ``train()`` with ``overlap="1step"``, ``staleness`` 2 and 4, and
       ``staleness=2, local_steps=2`` (``pipeline_run``: finite, K1 launched
       once per issued step plus the timer's chains, returned drained);
       the final drain moves the worker mean by the column means of the
       in-flight deltas, and those are 0 up to f32 rounding
       (``PendingWatch``: 1e-6 of the largest parameter per delta).
    2. The consensus laws through K1 at ``[16, 273258]``, 16 steps of the
       slice's schedule: ``run_pipelined(staleness=1)`` bitwise
       ``run_overlapped``, ``run_elided(flags, 2)`` bitwise ``run`` on the
       compacted stream (8 one-step launches against one launch of 8
       steps), and the drained ``run_overlapped`` within T·2⁻²³·max|ref|
       of ``run`` (about an ulp a step); K1's launches of each chain.
    3. Resume: the ``staleness=2`` run checkpoints every epoch; a run
       resumed from its epoch-0 checkpoint ends bitwise equal to it (every
       parameter, batch-norm and momentum buffer), and its epoch-1
       checkpoint holds the same ring, bit for bit.  The same checkpoint
       resumed with ``staleness=4`` and with ``overlap="off"``: finite,
       and the reconcile's drain keeps the worker mean (as in 1).
    4. ms per step of the second epoch for eager, ``1step``,
       ``staleness=2`` and ``local_steps=2``, ``rounds`` rounds, the order
       reversed every other round, with K1's launches per step.
    """
    bpe = 2048 // 16 // 32
    t_phase = time.perf_counter()
    out = {"runs": {}, "launches": {}}
    with tempfile.TemporaryDirectory() as root:
        ckpt = os.path.join(root, "pipe_ckpt")
        with PendingWatch() as watch:
            for label, over in PIPELINES:
                kw = ({"checkpoint_every": 1, "savePath": root,
                       "name": "pipe"} if label == "staleness=2" else {})
                result, row = pipeline_run(dev, label, over, **kw)
                if label == "staleness=2":
                    whole = state_tensors(result.state)
                    ring1 = torch.load(os.path.join(ckpt, "1", "state.pt"),
                                       map_location="cpu",
                                       weights_only=True)["mix_pending"]
                out["runs"][label] = row
                del result
        out["drain_worst_rel"] = watch.check()
        out["launches"]["train() pipelined"] = sum(
            r["launches"] for r in out["runs"].values())

        # 3. resume
        epoch0 = os.path.join(root, "from_epoch0")
        shutil.copytree(os.path.join(ckpt, "0"), os.path.join(epoch0, "0"))
        for side in ("digest-0.json", "schedule-0.json"):
            shutil.copy(os.path.join(ckpt, side), epoch0)
        resumed = {}
        with PendingWatch() as watch:
            for label, over in (
                    ("staleness=2", {"overlap": "1step", "staleness": 2}),
                    ("staleness=4", {"overlap": "1step", "staleness": 4}),
                    ("off", {})):
                kw = {"resume": epoch0, "savePath": root,
                      "name": f"resumed-{label}",
                      "checkpoint_every": 1 if label == "staleness=2" else 0}
                result, row = pipeline_run(dev, f"resumed {label}", over,
                                           **kw)
                if [h["epoch"] for h in result.history] != [1]:
                    raise AssertionError(f"resumed {label}: epochs "
                                         f"{result.history}")
                if label == "staleness=2":
                    got = state_tensors(result.state)
                    differ = [k for k, v in whole.items()
                              if not same_bits(got[k], v)]
                    ring = torch.load(os.path.join(
                        root, "resumed-staleness=2_ckpt", "1", "state.pt"),
                        map_location="cpu", weights_only=True)["mix_pending"]
                    if differ or not same_bits(ring, ring1) \
                            or not bool(ring1.any()):
                        raise AssertionError(
                            f"the resumed staleness=2 run is not bitwise "
                            f"the uninterrupted one: {differ[:4]}, ring "
                            f"equal {same_bits(ring, ring1)}")
                    row["final_state_bitwise"] = row["ring_bitwise"] = True
                resumed[label] = row
                del result
        # each resume reconciles the saved ring (a drain into the
        # parameters at the depth change and at the eager resume)
        if sum(r[0] == "_reconcile_mix_pending" for r in watch.records) != 3:
            raise AssertionError(f"reconcile drains recorded: "
                                 f"{[r[0] for r in watch.records]}")
        out["resumed"] = resumed
        out["resume_drain_worst_rel"] = watch.check()
        out["launches"]["train() pipelined, resumed"] = sum(
            r["launches"] for r in resumed.values())

    # 2. the consensus laws through K1
    sched, _, _ = tables
    comm = make_decen(sched, "perm", device=dev)
    x = state(16, SLICE_D, dev)
    flags = sched.flags[:16]
    chains = {}

    def counted(label, fn):
        reset_launch_counts()
        result = fn()
        torch.cuda.synchronize()
        chains[label] = LAUNCHES["perm_gossip_dbuf"]
        return result[0]

    over = counted("run_overlapped", lambda: comm.run_overlapped(x, flags))
    piped = counted("run_pipelined(staleness=1)",
                    lambda: comm.run_pipelined(x, flags, staleness=1))
    elided = counted("run_elided(L=2)", lambda: comm.run_elided(x, flags, 2))
    compact = counted("run(flags[::2])", lambda: comm.run(x, flags[::2]))
    eager = counted("run", lambda: comm.run(x, flags))
    if chains != {"run_overlapped": 16, "run_pipelined(staleness=1)": 16,
                  "run_elided(L=2)": 8, "run(flags[::2])": 1, "run": 1}:
        raise AssertionError(f"chain launches {chains}")
    if not same_bits(piped, over):
        raise AssertionError("run_pipelined(staleness=1) is not bitwise "
                             "run_overlapped")
    if not same_bits(elided, compact):
        raise AssertionError("run_elided(flags, 2) is not bitwise run on "
                             "the compacted stream")
    drain_err = float((over - eager).abs().max())
    drain_bar = 16 * 2.0 ** -23 * float(eager.abs().max())
    if not drain_err <= drain_bar:
        raise AssertionError(f"drained run_overlapped vs run: {drain_err} "
                             f"> {drain_bar}")
    out["laws"] = {"shape": [16, SLICE_D], "T": 16, "launches": chains,
                   "k1_bitwise": True, "elided_bitwise": True,
                   "drained_vs_run_max_abs_err": drain_err,
                   "drained_vs_run_bar": drain_bar}
    out["launches"]["Communicator.run_overlapped / run_pipelined / "
                    "run_elided"] = (chains["run_overlapped"]
                                     + chains["run_pipelined(staleness=1)"]
                                     + chains["run_elided(L=2)"])
    del x, over, piped, elided, compact, eager

    # 4. time, in alternated rounds
    ms = {label: [] for label, _ in TIMED_PIPELINES}
    per_step = {}
    for r in range(rounds):
        order = TIMED_PIPELINES if r % 2 == 0 else TIMED_PIPELINES[::-1]
        for label, over in order:
            _, row = pipeline_run(dev, f"timed {label}", over)
            ms[label].append(row["ms_per_step"][1])
            # K1 per step of the training loop (the timer's chains apart)
            per_step[label] = row["issued_steps"] / (2 * bpe)
    out["timing"] = {"ms_per_step_epoch1": ms,
                     "median_ms_per_step": {k: statistics.median(v)
                                            for k, v in ms.items()},
                     "k1_launches_per_step": per_step, "rounds": rounds}
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "pipeline", **out, "nvidia_smi": nvidia_smi()})
    return out


# the planner phase's sweep: zoo graph 4 (the slice's graph) at three
# budgets, with a small Monte-Carlo check beside each bound
PLANNER_BUDGETS = (0.25, 0.5, 0.75)


def planner_run(dev, label: str, root: str, plan: str, **kw):
    """``train()`` of the slice under the plan artifact, 2 epochs, saved
    under ``root``, launches counted: ``(result, row, backend event)``."""
    bpe = 2048 // 16 // 32
    cfg = dataclasses.replace(slice_config(2), plan=plan, save=True,
                              savePath=root, name=label, **kw)
    reset_launch_counts()
    t0 = time.perf_counter()
    result = train(cfg, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    for h in result.history:
        for key in ("loss", "disagreement", "test_loss_mean"):
            if not math.isfinite(h[key]):
                raise AssertionError(f"{label}: epoch {h['epoch']} {key} = "
                                     f"{h[key]}")
    events = read_journal(os.path.join(result.recorder.folder,
                                       "events.jsonl"))
    problems = [p for e in events for p in validate_event(e)]
    backend = [e for e in events if e["kind"] == "backend"]
    if problems or [e["kind"] for e in events[:2]] != ["run_start",
                                                       "backend"] \
            or len(backend) != 1:
        raise AssertionError(f"{label}: journal "
                             f"{[e['kind'] for e in events]}: {problems}")
    row = {"label": label, "seconds": seconds,
           "k1_launches": launches["perm_gossip_dbuf"],
           "fused_launches": launches["fused_gossip"],
           "ms_per_step": [h["epoch_time"] / bpe * 1e3
                           for h in result.history],
           "loss": [h["loss"] for h in result.history],
           "disagreement": [h["disagreement"] for h in result.history]}
    return result, row, backend[0]


def phase_planner(dev, fused_rows, huge_tables):
    """The offline planner and ``gossip_backend="auto"`` on the card:

    1. ``sweep`` over zoo graph 4 at budgets 0.25 / 0.5 / 0.75 (a 2-trial,
       40-step Monte-Carlo check each), written to a temporary directory
       and passed through the port's planlint; its host seconds.
    2. r, K3's ``bound_ms / ms`` at chain (b) (bf16, N = 256, T = 64) from
       this run's fused_timing, written as a roofline report; the slice
       trained under the artifact with ``auto`` and that report as
       ``gossip_measured_source``: the journaled ``backend`` event equals
       ``choose_gossip_backend`` on r, and the run launches what it chose.
    3. The same run with ``gossip_measured_vs_ceiling=0.9``: ``perm``, K1
       launched 8 + 4 times (8 steps, 2 timer chains an epoch), and the
       third step's launch bitwise its plain version on the same input.
    4. ``make_decen(<4096-worker hypercube>, "auto")``: ``perm`` with no
       measurement, its ``Communicator.run`` at ``[4096, 273258]`` f32,
       T = 1 (K1's band path) bitwise the plain version.
    5. ``verify_plan_run`` on run 3's Recorder CSVs.
    Each decision record's ``chosen`` and ``reason`` is printed on a line
    of its own.  Any failure raises."""
    from matcha_tpu_torch.analysis import lint_plan_file, render_plan_text
    from matcha_tpu_torch.communicator import decen
    from matcha_tpu_torch.plan import save_plan, sweep, verify_plan_run
    from matcha_tpu_torch.plan.cost import choose_gossip_backend

    t_phase = time.perf_counter()
    bpe = 2048 // 16 // 32
    out = {"launches": {}}
    with tempfile.TemporaryDirectory() as root:
        # 1. the sweep, self-checked through planlint
        plan = os.path.join(root, "plan.json")
        t0 = time.perf_counter()
        artifact = sweep([{"graphid": 4}], PLANNER_BUDGETS, seed=SEED,
                         mc_trials=2, mc_steps=40)
        sweep_s = time.perf_counter() - t0
        save_plan(artifact, plan)
        violations, is_plan = lint_plan_file(plan)
        if violations or not is_plan:
            raise AssertionError(render_plan_text(violations, [plan]))
        chosen = artifact.chosen
        out["sweep"] = {
            "graphid": 4, "workers": 16, "budgets": list(PLANNER_BUDGETS),
            "host_seconds": sweep_s, "chosen_budget": chosen["budget"],
            "rho": chosen["rho"], "alpha": chosen["alpha"],
            "ranking": [{"budget": c["budget"], "rho": c["rho"],
                         "mc_empirical_rate": c["mc_empirical_rate"],
                         "steps_to_target": c["steps_to_target"]}
                        for c in artifact.candidates]}

        # 2. the gate on the card's own ratio, read from a report file
        chain_b = next(t for t in fused_rows
                       if t["shape"] == "hypercube N=256 T=64 bf16")
        ratio = chain_b["bound_ms"] / chain_b["ms"]
        report = os.path.join(root, "roofline.json")
        with open(report, "w") as f:
            json.dump({"measured_vs_ceiling": ratio,
                       "measured_vs_ceiling_backend": "fused"}, f)
        auto, row, event = planner_run(dev, "planner_auto", root, plan,
                                       gossip_backend="auto",
                                       gossip_measured_source=report)
        sched = auto.schedule
        want = choose_gossip_backend(
            sched.num_workers, sched.num_matchings, wire_dtype="f32",
            budget=float(np.mean(np.asarray(sched.probs))),
            topology=sched.name, measured_vs_ceiling=ratio)
        differ = sorted(k for k in want if event.get(k) != want[k])
        if differ or event["measured_source"]["path"] != report \
                or sched.num_workers != 16 \
                or float(sched.alpha) != chosen["alpha"]:
            raise AssertionError(f"planner auto: backend event {event} is "
                                 f"not choose_gossip_backend on r = {ratio} "
                                 f"({differ})")
        expect_k1 = 2 * bpe + 2 * timer_chains(bpe) \
            if want["chosen"] == "perm" else 0
        if row["k1_launches"] != expect_k1 or row["fused_launches"]:
            raise AssertionError(f"planner auto ({want['chosen']}): "
                                 f"launches {row}")
        print(json.dumps({"decision": "train() auto, measured r",
                          "chosen": event["chosen"],
                          "reason": event["reason"]}), flush=True)
        out["auto"] = {**row, "r": ratio, "chain_b": {
            "ms": chain_b["ms"], "bound_ms": chain_b["bound_ms"]},
            "chosen": event["chosen"], "reason": event["reason"],
            "budget": chosen["budget"]}
        if want["chosen"] == "perm":
            out["launches"]["train() planner, auto on r"] = row["k1_launches"]
        del auto

        # 3. the gate forced to perm; K1's third per-step launch captured
        inner_run = decen.perm_gossip_run
        captured, calls = {}, [0]

        def capture_k1(x, weights, perms, partnered, **kw):
            y = inner_run(x, weights, perms, partnered, **kw)
            if weights.shape[0] == 1:
                calls[0] += 1
                if calls[0] == 3:
                    captured["step"] = (x.clone(), weights.clone(), perms,
                                        partnered, y.clone(), kw)
            return y

        decen.perm_gossip_run = capture_k1
        try:
            gated, row, event = planner_run(
                dev, "planner_gated", root, plan, gossip_backend="auto",
                gossip_measured_vs_ceiling=0.9)
        finally:
            decen.perm_gossip_run = inner_run
        expected = 2 * bpe + 2 * timer_chains(bpe)
        if event["chosen"] != "perm" or row["k1_launches"] != expected \
                or calls[0] != 2 * bpe:
            raise AssertionError(f"planner gated: {event['chosen']}, K1 "
                                 f"launched {row['k1_launches']} times "
                                 f"({calls[0]} steps), expected {expected}")
        x, w, perms, partnered, y, kw = captured["step"]
        if not same_bits(y, perm_gossip_plain(x, w, perms, partnered, **kw)):
            raise AssertionError("planner gated: K1's step 3 is not bitwise "
                                 "its plain version")
        print(json.dumps({"decision": "train() auto, ratio 0.9",
                          "chosen": event["chosen"],
                          "reason": event["reason"]}), flush=True)
        out["gated"] = {**row, "chosen": event["chosen"],
                        "reason": event["reason"], "k1_step_bitwise": True}
        out["launches"]["train() planner, auto gated to perm"] = \
            row["k1_launches"]
        del captured, x, w, y

        # 5. verify run 3 against the plan
        verdict = verify_plan_run(artifact, gated.recorder.folder, bpe)
        out["verify"] = {k: verdict[k] for k in (
            "rho", "predicted_epoch_factor", "measured_epoch_factors",
            "floor", "checked_epochs", "violations", "consistent")}
        del gated

    # 4. the forced rule: 4096 workers, no measurement
    sch, p, part = huge_tables
    comm_decision = decen.resolve_gossip_backend(sch, wire_dtype=None)
    if comm_decision["chosen"] != "perm":
        raise AssertionError(f"auto at N = 4096: {comm_decision}")
    print(json.dumps({"decision": "make_decen auto, N = 4096",
                      "chosen": comm_decision["chosen"],
                      "reason": comm_decision["reason"]}), flush=True)
    x = state(sch.num_workers, SLICE_D, dev)
    comm = make_decen(sch, "auto", device=dev)
    reset_launch_counts()
    got = comm.run(x, sch.flags[:1])[0]
    torch.cuda.synchronize()
    band = LAUNCHES["perm_gossip/band"]
    if band != 1 or LAUNCHES["perm_gossip_dbuf"] != 1:
        raise AssertionError(f"make_decen auto at N = 4096 launched "
                             f"{dict(LAUNCHES)}, expected one band launch")
    w = torch.as_tensor(sch.alpha * sch.flags[:1], dtype=torch.float32,
                        device=dev)
    if not same_bits(got, perm_gossip_plain(x, w, p, part)):
        raise AssertionError("make_decen auto at N = 4096: not bitwise "
                             "the plain version")
    out["forced"] = {"shape": [sch.num_workers, SLICE_D], "T": 1,
                     "matchings": sch.num_matchings,
                     "chosen": comm_decision["chosen"], "band_launches": band,
                     "bitwise": True}
    del x, got, w, comm
    torch.cuda.empty_cache()
    out["band_launches"] = band
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "planner", **out, "nvidia_smi": nvidia_smi()})
    return out


def obs_run(dev, label: str, root: str, epochs: int = 3, **kw):
    """``train()`` of the slice with ``save`` (telemetry and health on, the
    defaults) and ``kw``, K1 counted: ``(result, journal, row)``."""
    bpe = 2048 // 16 // 32
    cfg = dataclasses.replace(slice_config(epochs), save=True, savePath=root,
                              name=label, **kw)
    reset_launch_counts()
    t0 = time.perf_counter()
    result = train(cfg, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = LAUNCHES["perm_gossip_dbuf"]
    if launches != k1_expected(result, bpe):
        raise AssertionError(f"{label}: K1 launched {launches} times, "
                             f"expected {k1_expected(result, bpe)}")
    events = read_journal(os.path.join(result.recorder.folder,
                                       "events.jsonl"))
    problems = [p for e in events for p in validate_event(e)]
    bad = [h["epoch"] for h in result.history
           if not (math.isfinite(h["loss"])
                   and math.isfinite(h["disagreement"]))]
    if problems or bad:
        raise AssertionError(f"{label}: journal {problems}, non-finite "
                             f"epochs {bad}")
    kinds = {}
    for e in events:
        kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
    return result, events, {
        "launches": launches, "seconds": seconds, "event_kinds": kinds,
        "ms_per_step": [h["epoch_time"] / bpe * 1e3 for h in result.history],
        "disagreement": [h["disagreement"] for h in result.history]}


def of_kind(events, kind):
    return [e for e in events if e["kind"] == kind]


# gossip alone: no SGD moves the parameters, from an unsynced init
PURE_GOSSIP = dict(lr=0.0, warmup=False, momentum=0.0, weight_decay=0.0,
                   sync_init=False)


def obs_stepper(dev, iterations: int, telemetry: bool):
    """``slice_stepper`` with the telemetry accumulator on or off."""
    from matcha_tpu_torch.obs.telemetry import Telemetry, make_telemetry_spec

    spec = None
    if telemetry:
        sched = build_schedule(slice_config(1), iterations)
        spec = make_telemetry_spec(sched.decomposed, SLICE_D)
    state, step, xb, yb = slice_stepper(dev, iterations, telemetry=spec)
    if telemetry:
        state.telemetry = Telemetry.zeros(16, device=dev)
    return state, step, xb, yb


def sync_warnings(fn) -> dict:
    """Synchronizing CUDA calls made by ``fn()``, counted by PyTorch's sync
    debug mode (each one a warning), by the ``file:line`` that made them."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    where = {}
    for w in caught:
        if "synchronizing" in str(w.message):
            key = f"{os.path.relpath(w.filename)}:{w.lineno}"
            where[key] = where.get(key, 0) + 1
    return where


def phase_observability(dev, rounds: int = 3, steps: int = 20,
                        profiled: int = 5):
    """The training run's observability plane on the card (cell (l)):
    slice (a) at full width, 3 epochs of 4 steps, ``save`` on and the
    defaults ``telemetry=True``, ``health=True``.

    1. The plain run: one ``telemetry`` event an epoch with 4 steps, its
       ``matchings_mean`` and ``wire_bytes`` exactly the host's sums of the
       schedule's flag rows (times ``matching_wire_bytes``); three
       heartbeats under ``{run}/health/`` and in the journal;
       ``run_start.predicted`` equal to ``compose_predicted_rho``
       recomputed on the host.
    2. Gossip alone (``lr=0``, no sync of the init), twice: no ``drift``
       event at the solved α; a ``drift`` event with ``alpha_override`` at
       0.05·α.
    3. ``membership_live`` on a heartbeat directory whose newest beat of
       w3 is an hour old: one ``leave`` at epoch 0, every step's K1 launch
       under the survivor mask, the second one bitwise its plain version
       on the captured sealed inputs, the heartbeats without w3.
    4. Synchronizing calls counted by the sync debug mode: 8 steps of the
       slice's step with and without the accumulator, and a one-epoch
       ``train()`` with ``telemetry`` on and off; equal.
    5. ms a step (median of ``steps`` steps on the host clock, ``rounds``
       alternated rounds) and launches a step (``torch.profiler``,
       ``profiled`` steps) with the accumulator on and off.
    Any failure raises."""
    from matcha_tpu_torch.communicator import decen
    from matcha_tpu_torch.obs.drift import compose_predicted_rho
    from matcha_tpu_torch.parallel.gossip import matching_wire_bytes
    from torch.profiler import ProfilerActivity, profile

    t_phase = time.perf_counter()
    bpe = 2048 // 16 // 32
    out = {"launches": {}}
    with tempfile.TemporaryDirectory() as root:
        # 1. the plain run
        plain, events, row = obs_run(dev, "obs_plain", root)
        sched = plain.schedule
        flags = np.asarray(sched.flags, np.float64)
        bytes_vec = matching_wire_bytes(sched.decomposed, SLICE_D, "f32")
        tel = of_kind(events, "telemetry")
        if [e["epoch"] for e in tel] != [0, 1, 2] \
                or any(e["steps"] != bpe for e in tel):
            raise AssertionError(f"obs plain: telemetry {tel}")
        for e in tel:
            rows = flags[e["epoch"] * bpe:(e["epoch"] + 1) * bpe]
            if e["matchings_mean"] != rows.sum() / bpe \
                    or e["wire_bytes"] != float(rows.sum(0) @ bytes_vec):
                raise AssertionError(f"obs plain: epoch {e['epoch']} counts "
                                     f"{e['matchings_mean']}, "
                                     f"{e['wire_bytes']}")
        beats = [json.loads(line) for line in open(os.path.join(
            plain.recorder.folder, "health", "host0.jsonl"))]
        mirrored = of_kind(events, "heartbeat")
        if [b["epoch"] for b in beats] != [0, 1, 2] \
                or [b["epoch"] for b in mirrored] != [0, 1, 2] \
                or any(len(b["workers"]) != 16 or not b["peak_bytes"]
                       for b in beats):
            raise AssertionError(f"obs plain: heartbeats {beats}")
        want = compose_predicted_rho(sched.laplacians(), sched.probs,
                                     float(sched.alpha), wire_dtype="f32")
        want.update(steps_per_epoch=bpe, tolerance=0.25, patience=2,
                    plan_alpha=float(sched.alpha), stale_alpha_scale=1.0,
                    executed_alpha=float(sched.alpha))
        predicted = of_kind(events, "run_start")[0]["predicted"]
        if predicted != want:
            raise AssertionError(f"obs plain: predicted {predicted} != "
                                 f"{want}")
        alpha = float(sched.alpha)
        out["plain"] = {**row, "predicted": predicted,
                        "telemetry": [{k: e[k] for k in (
                            "epoch", "steps", "matchings_mean", "wire_bytes",
                            "disagreement_mean", "alive_min")} for e in tel],
                        "peak_bytes": [b["peak_bytes"] for b in beats],
                        "anomalies": [(a["subject"], a["cause"]) for a in
                                      of_kind(events, "anomaly")]}
        out["launches"]["train() observability, plain"] = row["launches"]
        del plain

        # 2. gossip alone, at the solved α and misplanned
        drift_rows = {}
        for label, over in (("obs_gossip", {}),
                            ("obs_misplan", {"alpha_override":
                                             0.05 * alpha})):
            result, events, row = obs_run(dev, label, root, **PURE_GOSSIP,
                                          **over)
            drift = of_kind(events, "drift")
            if bool(drift) != bool(over):
                raise AssertionError(f"{label}: drift events {drift}")
            drift_rows[label] = {**row, "drift": [
                {k: e[k] for k in ("epoch", "predicted_factor",
                                   "measured_factor")} for e in drift]}
            out["launches"][f"train() observability, {label}"] = \
                row["launches"]
            del result
        out["drift"] = drift_rows

        # 3. the live membership source
        hdir = os.path.join(root, "fleet_health")
        os.makedirs(hdir)
        now = time.time()
        with open(os.path.join(hdir, "host0.jsonl"), "w") as f:
            for t, members, epoch in (
                    (now - 3600.0, range(16), 0),
                    (now, [i for i in range(16) if i != 3], 1)):
                f.write(json.dumps({
                    "v": 3, "kind": "heartbeat", "t": t, "host": "host0",
                    "epoch": epoch, "step": 4 * (epoch + 1),
                    "step_time": 0.1, "step_time_ewma": 0.1,
                    "comp_time": 0.3, "comm_time": 0.1, "peak_bytes": None,
                    "workers": {f"w{i}": {"slot": i, "participation": 1.0,
                                          "disagreement": 0.0}
                                for i in members}}) + "\n")
        inner_run = decen.perm_gossip_run
        captured, masked = {}, [0]

        def capture_k1(x, weights, perms, partnered, **kw):
            y = inner_run(x, weights, perms, partnered, **kw)
            if kw.get("alive") is not None:
                masked[0] += 1
                if masked[0] == 2:
                    captured["step"] = (x.clone(), weights.clone(), perms,
                                        partnered, kw["alive"].clone(),
                                        y.clone(), kw)
            return y

        decen.perm_gossip_run = capture_k1
        try:
            live, events, row = obs_run(dev, "obs_live", root,
                                        membership_live=hdir,
                                        membership_deadline=60.0)
        finally:
            decen.perm_gossip_run = inner_run
        members = of_kind(events, "membership")
        if len(members) != 1 or members[0]["epoch"] != 0 \
                or [(t["kind"], t["worker"]) for t in members[0]["trigger"]] \
                != [("leave", "w3")] \
                or [h["alive_workers"] for h in live.history] != [15.0] * 3:
            raise AssertionError(f"obs live: membership {members}")
        if masked[0] != 3 * bpe or any(
                "w3" in b["workers"] or len(b["workers"]) != 15
                for b in of_kind(events, "heartbeat")):
            raise AssertionError(f"obs live: {masked[0]} masked K1 launches,"
                                 f" heartbeats {of_kind(events, 'heartbeat')}")
        x, w, perms, partnered, av, y, kw = captured["step"]
        extra = {k: v for k, v in kw.items() if k != "alive"}
        sealed = same_bits(y, perm_gossip_plain(x, w, perms, partnered,
                                                alive=av, **extra))
        if not sealed or av[3] != 0 or int(av.sum()) != 15:
            raise AssertionError(f"obs live: K1's step 2 under the mask "
                                 f"{av.tolist()}, bitwise {sealed}")
        out["live"] = {**row, "membership": {k: members[0][k] for k in (
            "epoch", "trigger", "alpha", "rho", "replanned")},
            "predicted_rho": members[0]["predicted"].get("rho"),
            "masked_k1_launches": masked[0], "k1_step_bitwise": sealed}
        out["launches"]["train() observability, membership_live"] = \
            row["launches"]
        del live, captured, x, w, y

        # 4. synchronizing calls, telemetry on and off.  The first counted
        # call of a process records one synchronizing call of PyTorch's own
        # (from torch/cuda/__init__.py, with or without the accumulator),
        # so each count follows a discarded one
        counts, primes = {}, {}
        for on in (True, False):
            state, step, xb, yb = obs_stepper(dev, 20, on)
            for _ in range(2):
                state, _ = step(state, xb, yb)
            torch.cuda.synchronize()

            def eight(state=state, step=step, xb=xb, yb=yb):
                for _ in range(8):
                    step(state, xb, yb)

            primes[f"step x8, telemetry {'on' if on else 'off'}"] = \
                sync_warnings(eight)
            counts[f"step x8, telemetry {'on' if on else 'off'}"] = \
                sync_warnings(eight)
            del state, step
            label = f"obs_sync_{'on' if on else 'off'}"
            holder = {}

            def one_epoch(label=label, on=on):
                holder["result"] = obs_run(dev, label, root, epochs=1,
                                           telemetry=on)

            counts[f"train() 1 epoch, telemetry {'on' if on else 'off'}"] = \
                sync_warnings(one_epoch)
            out["launches"][f"train() observability, {label}"] = \
                holder["result"][2]["launches"]
            del holder
        totals = {k: sum(v.values()) for k, v in counts.items()}
        if totals["step x8, telemetry on"] != totals["step x8, telemetry off"] \
                or totals["train() 1 epoch, telemetry on"] \
                != totals["train() 1 epoch, telemetry off"]:
            raise AssertionError(f"obs: synchronizing calls {counts}")
        out["sync_warnings"] = totals
        out["sync_warnings_where"] = counts
        out["sync_warnings_discarded"] = primes
    torch.cuda.empty_cache()

    # 5. the step with the accumulator on and off, alternated
    steppers = {on: obs_stepper(dev, 3 + rounds * steps + profiled + 1, on)
                for on in (True, False)}
    for on, (state, step, xb, yb) in steppers.items():
        for _ in range(3):
            state, _ = step(state, xb, yb)
    ms = {True: [], False: []}
    for r in range(rounds):
        for on in ((True, False) if r % 2 == 0 else (False, True)):
            state, step, xb, yb = steppers[on]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                state, _ = step(state, xb, yb)
            torch.cuda.synchronize()
            ms[on].append((time.perf_counter() - t0) / steps * 1e3)
    launches = {}
    for on, (state, step, xb, yb) in steppers.items():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(profiled):
                state, _ = step(state, xb, yb)
            torch.cuda.synchronize()
        launches[on] = sum(e.device_type == torch.autograd.DeviceType.CUDA
                           for e in prof.events()) / profiled
    del steppers
    torch.cuda.empty_cache()
    out["step"] = {
        "ms_per_step_on": ms[True], "ms_per_step_off": ms[False],
        "median_ms_on": statistics.median(ms[True]),
        "median_ms_off": statistics.median(ms[False]),
        "launches_per_step_on": launches[True],
        "launches_per_step_off": launches[False],
        "launches_added": launches[True] - launches[False]}
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "observability", **out, "nvidia_smi": nvidia_smi()})
    return out


# the CLI's commands on a run the card wrote, run with JAX blocked
OBS_CLI = """
import importlib.abc, json, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                  "matcha_tpu", "ml_dtypes"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import obs_torch
codes = [obs_torch.main(argv) for argv in json.loads(sys.argv[1])]
leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "matcha_tpu")]
print(json.dumps({"codes": codes, "leaked": leaked}))
"""


def _null_span(name):
    return contextlib.nullcontext()


def window_split(events: list, phased: list, steps: int) -> dict:
    """From a trace's events and its ``(device row, phase)`` pairs: device
    time by ``STEP_PARTS`` part (ms a step), K1's and the convolutions'
    rows by phase (and K1's rows whose launch row is in the trace), the
    device-busy share of the window, and the host's ms a step inside each
    of the step's spans (their ``user_annotation`` ranges: launching the
    phase's kernels, and its host work)."""
    parts, k1, conv, host = {}, {}, {}, {}
    launched = {(e.get("args") or {}).get("correlation") for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")}
    k1_launch_rows = 0
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            name = e.get("name", "")
            if name.startswith(("matcha/", "comm/")):
                host[name] = host.get(name, 0.0) \
                    + float(e.get("dur", 0.0)) / 1e3 / steps
    busy, reach = 0.0, float("-inf")
    lo = min(float(e["ts"]) for e, _ in phased)
    hi = max(float(e["ts"]) + float(e["dur"]) for e, _ in phased)
    for e, phase in sorted(phased, key=lambda ep: float(ep[0]["ts"])):
        name, start = e.get("name", "").lower(), float(e["ts"])
        end = start + float(e["dur"])
        if end > reach:
            busy += end - max(start, reach)
            reach = end
        part = next((label for label, keys in STEP_PARTS
                     if any(k in name for k in keys)), "other")
        parts[part] = parts.get(part, 0.0) + float(e["dur"]) / 1e3 / steps
        if "perm_gossip_kernel" in name:
            k1[phase] = k1.get(phase, 0) + 1
            # a ctypes launch outside the dispatcher: its runtime call is
            # what puts it in a phase
            k1_launch_rows += (e.get("args") or {}).get("correlation") \
                in launched
        elif part == "convolution":
            conv[phase] = conv.get(phase, 0) + 1
    return {"kernel_ms_per_step_by_part": parts, "k1_rows_by_phase": k1,
            "conv_rows_by_phase": conv, "k1_rows_with_launch_row":
            k1_launch_rows, "device_rows": len(phased),
            "device_busy_share": busy / max(hi - lo, 1e-9),
            "device_window_ms_per_step": (hi - lo) / 1e3 / steps,
            "host_ms_per_step_by_span": host}


def phase_perf_obs(dev, fused_rows, planner, big_tables, rounds: int = 3,
                   steps: int = 8):
    """Performance observability on the card (cell (m)): slice (a) at
    full width, 3 epochs of 4 steps, ``save``, telemetry and health on,
    ``trace_dir`` set with ``trace_epoch=1``.

    1. The run (K1 launched once a step plus the timer's chains): one
       trace under ``trace_dir``; ``profile_report`` finds device rows;
       every K1 row of the traced epoch is in ``comm``, 4 of them (the
       timer's chains run after the window closes), and every convolution
       row is in ``comp``.  Printed: the phases' seconds, the overlap
       fraction, the device-busy share of the window, the
       ``STEP_PARTS`` split of the same steps and the host's ms a step
       inside each span.
    2. The cost ledger: one ``compile`` event per distinct program, each
       ``peak_bytes`` in (0, 80 GB], each heartbeat's ``peak_bytes`` the
       largest of the programs journaled before it.
    3. The spans outside a window: every ``device_span`` the slice's step
       enters on the card outside a profiler is a ``nullcontext``, and
       inside a profiler window a ``record_function``; ms a step with the
       spans and with ``device_span`` patched to a ``nullcontext``, in
       ``rounds`` alternated rounds (printed).
    4. The roofline on the card's row at chain (b) (``[256, 273258]``,
       bf16, fused, T = 64, the 256-worker hypercube), priced by one K3
       launch, with the rate of this run's ``fused_timing``:
       ``measured_vs_ceiling`` in (0, 1.05] and within 1 % of the planner
       phase's r; the report written and read back by
       ``load_measured_vs_ceiling``.
    5. ``obs_torch.py`` on the run with JAX blocked: summary, tail, drift,
       profile, roofline, capacity, watch --once, attribute and timeline,
       each with its documented exit code (drift, watch and attribute 0
       or 1; an artifact ``attribute`` writes passes planlint; the
       timeline validates).
    Any failure raises."""
    from matcha_tpu_torch.analysis import lint_plan_file
    from matcha_tpu_torch.obs import costs, xprof
    from matcha_tpu_torch.obs.health import fleet_verdict
    from matcha_tpu_torch.obs.timeline import validate_trace
    from matcha_tpu_torch.plan import load_measured_vs_ceiling
    from matcha_tpu_torch.train import state as train_state
    from torch.profiler import ProfilerActivity, profile

    t_phase = time.perf_counter()
    bpe = 2048 // 16 // 32
    out = {"launches": {}}
    with tempfile.TemporaryDirectory() as root:
        # 1. the traced run and its attribution
        trace_dir = os.path.join(root, "trace")
        result, events, row = obs_run(dev, "perf_obs", root,
                                      trace_dir=trace_dir, trace_epoch=1)
        out["run"] = row
        out["launches"]["train() perf_obs, traced epoch 1"] = \
            row["launches"]
        files = [f for _, _, fs in os.walk(trace_dir) for f in fs]
        trace_file = xprof.find_trace_file(trace_dir)
        t0 = time.perf_counter()
        report = xprof.profile_report(trace_dir)
        trace_events = xprof.load_trace_events(trace_file)
        phased = xprof.kernel_phases(trace_events)
        parse_s = time.perf_counter() - t0
        split = window_split(trace_events, phased, bpe)
        del trace_events
        out["trace"] = {
            "files": len(files), "bytes": os.path.getsize(trace_file),
            "parse_seconds": parse_s, "rows": report["rows"],
            **{k: report[k] for k in ("comm_seconds", "comp_seconds",
                                      "other_seconds", "compute_seconds",
                                      "overlap_seconds",
                                      "overlap_fraction")},
            **split}
        emit({"phase": "perf_obs", "trace": out["trace"]})
        if len(files) != 1 or split["k1_rows_by_phase"] != {"comm": bpe} \
                or not split["conv_rows_by_phase"] \
                or set(split["conv_rows_by_phase"]) != {"comp"}:
            raise AssertionError(f"perf_obs: {len(files)} trace files, K1 "
                                 f"rows {split['k1_rows_by_phase']}, "
                                 f"convolutions "
                                 f"{split['conv_rows_by_phase']}")

        # 2. the ledger
        compiles = of_kind(events, "compile")
        keys = [(e["label"], e["fingerprint"]) for e in compiles]
        peaks = [e["peak_bytes"] for e in compiles]
        bad_beats = [e["epoch"] for i, e in enumerate(events)
                     if e["kind"] == "heartbeat"
                     and e["peak_bytes"] != max(
                         (c["peak_bytes"] for c in of_kind(events[:i],
                                                           "compile")),
                         default=None)]
        out["ledger"] = [{k: e[k] for k in (
            "label", "fingerprint", "compile_seconds", "flops", "hbm_bytes",
            "peak_bytes", "temp_bytes")} for e in compiles]
        if len(keys) != len(set(keys)) \
                or {k[0] for k in keys} != {"epoch_scan", "gossip_chain",
                                            "evaluate"} \
                or not all(0 < p <= costs.H100.hbm_gb * 1e9 for p in peaks) \
                or bad_beats:
            raise AssertionError(f"perf_obs: ledger {out['ledger']}, "
                                 f"heartbeats off the ledger {bad_beats}")

        # 3. the spans outside a window, on and patched off, alternated
        state, step, xb, yb = slice_stepper(dev, 3 + 2 * rounds * steps + 3)
        for _ in range(3):
            state, _ = step(state, xb, yb)
        real_span = train_state.device_span
        ms = {"spans": [], "nullcontext": []}
        entered = {"outside": [], "inside": []}
        try:
            for where in ("outside", "inside"):
                def spy(name, seen=entered[where]):
                    ctx = real_span(name)
                    seen.append((name, type(ctx).__name__))
                    return ctx
                train_state.device_span = spy
                with (profile(activities=[ProfilerActivity.CUDA])
                      if where == "inside" else contextlib.nullcontext()):
                    state, _ = step(state, xb, yb)
                    torch.cuda.synchronize()
            train_state.device_span = real_span
            for r in range(rounds):
                for mode in (("spans", "nullcontext") if r % 2 == 0
                             else ("nullcontext", "spans")):
                    train_state.device_span = (real_span if mode == "spans"
                                               else _null_span)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(steps):
                        state, _ = step(state, xb, yb)
                    torch.cuda.synchronize()
                    ms[mode].append((time.perf_counter() - t0) / steps * 1e3)
        finally:
            train_state.device_span = real_span
        del state, step, xb, yb
        torch.cuda.empty_cache()
        kinds = {w: sorted(set(v)) for w, v in entered.items()}
        out["spans"] = {"ms_per_step": ms,
                        "median_ms": {k: statistics.median(v)
                                      for k, v in ms.items()},
                        "entered": kinds}
        names = {n for n, _ in entered["outside"]}
        if not {"matcha/fwd_bwd", "matcha/sgd", "comm/step"} <= names \
                or {n for n, _ in entered["inside"]} != names \
                or {k for _, k in entered["outside"]} != {"nullcontext"} \
                or {k for _, k in entered["inside"]} != {"record_function"}:
            raise AssertionError(f"perf_obs: the step's spans {kinds}")

        # 4. the roofline at chain (b), one K3 launch on the card
        chain_b = next(t for t in fused_rows
                       if t["shape"] == "hypercube N=256 T=64 bf16")
        rate = 64 / (chain_b["ms"] / 1e3)
        sched = big_tables[0]
        reset_launch_counts()
        rep = costs.roofline_report(
            sched.num_workers, SLICE_D, sched.decomposed, wire_dtype="bf16",
            backend="fused", t_steps=64, measured_steps_per_sec=rate,
            device=dev)
        torch.cuda.synchronize()
        out["roofline_launches"] = dict(LAUNCHES)
        path = os.path.join(root, "roofline.json")
        with open(path, "w") as f:
            json.dump(rep, f)
        read_back, _ = load_measured_vs_ceiling(path)
        r_planner = planner["auto"]["r"]
        out["roofline"] = {
            k: rep[k] for k in (
                "chip", "peak_tflops", "peak_dtype", "peak_gbps",
                "flops_per_step", "hbm_bytes_per_step", "model_flops",
                "flops_vs_model", "hbm_vs_model", "peak_bytes",
                "compile_seconds", "compute_bound_steps_per_sec",
                "hbm_bound_steps_per_sec", "ceiling_steps_per_sec", "bound",
                "measured_steps_per_sec", "measured_vs_ceiling")}
        out["roofline"]["planner_r"] = r_planner
        out["roofline"]["read_back"] = read_back
        if not 0 < rep["measured_vs_ceiling"] <= 1.05 \
                or abs(rep["measured_vs_ceiling"] / r_planner - 1) > 0.01 \
                or read_back != rep["measured_vs_ceiling"] \
                or LAUNCHES["fused_gossip/tensor_core"] != 1 \
                or rep["chip"] != "h100":
            raise AssertionError(f"perf_obs: roofline {out['roofline']}, "
                                 f"launches {dict(LAUNCHES)}")

        # 5. the CLI with JAX blocked
        run_dir = result.recorder.folder
        art = os.path.join(root, "lc.json")
        commands = [
            ["summary", run_dir], ["tail", run_dir, "-n", "5"],
            ["drift", run_dir], ["profile", trace_dir],
            ["roofline", "--backend", "fused", "--workers", "256",
             "--topology", "hypercube", "--dim", str(SLICE_D),
             "--t-steps", "64", "--measured", str(rate)],
            ["capacity", "--dim", str(SLICE_D), "--workers", "256,16"],
            ["watch", run_dir, "--once", "--deadline", "3600"],
            ["attribute", run_dir, "--out", art],
            ["timeline", run_dir, "--out", os.path.join(root, "t.json")]]
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", OBS_CLI,
                               json.dumps(commands)], capture_output=True,
                              text=True, timeout=300)
        cli_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"perf_obs: obs_torch.py failed:\n"
                                 f"{proc.stderr[-3000:]}")
        cli = json.loads(proc.stdout.strip().splitlines()[-1])
        codes = dict(zip([c[0] for c in commands], cli["codes"]))
        watch_rc, _ = fleet_verdict(run_dir, deadline=3600.0)
        with open(os.path.join(root, "t.json")) as f:
            timeline_ok = validate_trace(json.load(f)) == []
        art_ok = (not os.path.exists(art)
                  or lint_plan_file(art)[0] == [])
        out["cli"] = {"codes": codes, "seconds": cli_s,
                      "artifact_written": os.path.exists(art),
                      "timeline_valid": timeline_ok}
        expected_zero = ("summary", "tail", "profile", "roofline",
                         "capacity", "timeline")
        if cli["leaked"] or any(codes[c] != 0 for c in expected_zero) \
                or codes["drift"] not in (0, 1) \
                or codes["watch"] != watch_rc \
                or codes["attribute"] not in (0, 1) \
                or codes["attribute"] == 0 and not art_ok \
                or not timeline_ok:
            raise AssertionError(f"perf_obs: CLI {out['cli']}, leaked "
                                 f"{cli['leaked']}:\n{proc.stderr[-3000:]}")
        del result
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "perf_obs", **{k: v for k, v in out.items()
                                  if k != "trace"},
          "nvidia_smi": nvidia_smi()})
    return out


# the serve phase: the run controller at the slice's width (cell (n))
SERVE_BUDGET = 0.25  # the swap's budget (the slice's is 0.5)


def serve_config(epochs: int, name: str, root: str) -> TrainConfig:
    """Slice (a) with ``save`` and a checkpoint every epoch, in ``root``."""
    return dataclasses.replace(slice_config(epochs), save=True,
                               savePath=root, name=name, checkpoint_every=1)


def k1_by_epoch(launches: list) -> list:
    """K1's launches in each epoch from the count read at each boundary
    and at the end (an epoch's timer chains run before the next
    boundary)."""
    return [b - a for a, b in zip(launches, launches[1:])]


class CountingHook:
    """A boundary hook that reads K1's launch count at each boundary,
    then calls ``inner`` (a ``TrainerHarness.on_boundary``, or ``None``)."""

    def __init__(self, inner=None, before=None):
        self.inner, self.before, self.launches = inner, before, []

    def __call__(self, seam):
        self.launches.append(LAUNCHES["perm_gossip_dbuf"])
        if self.before is not None:
            self.before(seam)
        if self.inner is not None:
            self.inner(seam)


@contextlib.contextmanager
def output_to(path: str):
    """This process's standard output and error (and so its children's)
    go to ``path`` within the block."""
    sys.stdout.flush()
    sys.stderr.flush()
    saved = os.dup(1), os.dup(2)
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    os.close(fd)
    try:
        yield
    finally:
        sys.stdout.flush()
        sys.stderr.flush()
        os.dup2(saved[0], 1)
        os.dup2(saved[1], 2)
        os.close(saved[0])
        os.close(saved[1])


class TimedLifetime:
    """A trainer subprocess with its launch time (wall clock) and, once
    ``wait`` returns, its seconds; everything else is the ``Popen``'s."""

    def __init__(self, proc, rows: list):
        self.proc, self.rows = proc, rows
        self.t_wall, self.t0 = time.time(), time.perf_counter()

    def wait(self, timeout=None):
        rc = self.proc.wait(timeout)
        self.rows.append({"launched": self.t_wall, "exit": rc,
                          "seconds": time.perf_counter() - self.t0})
        return rc

    def __getattr__(self, name):
        return getattr(self.proc, name)


def http_get(port: int, path: str):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def stub_cuda_home(root: str):
    """``(CUDA_HOME, marker)``: a toolkit whose ``nvcc`` touches ``marker``
    and fails, for trainer subprocesses that must not build a kernel."""
    stub = os.path.join(root, "stub_cuda")
    os.makedirs(os.path.join(stub, "bin"))
    marker = os.path.join(root, "nvcc_called")
    with open(os.path.join(stub, "bin", "nvcc"), "w") as f:
        f.write(f"#!/bin/sh\ntouch {marker}\nexit 1\n")
    os.chmod(os.path.join(stub, "bin", "nvcc"), 0o755)
    return stub, marker


def built_kernels() -> dict:
    """The built kernel libraries and their modification times."""
    return {p.name: p.stat().st_mtime_ns
            for p in _kernels.BUILD_DIR.glob("*.so")}


def serve_controller(root: str, name: str, stub_home: str, lifetimes: list):
    """A ``Controller`` over the slice for 3 epochs with a promotion every
    epoch, its trainer on the card; the trainer's ``CUDA_HOME`` is a stub
    whose ``nvcc`` fails, so a lifetime that tried to build a kernel
    would crash.  Its launches are timed into ``lifetimes``."""
    from matcha_tpu_torch.serve import Controller, ServeConfig

    cfg = serve_config(3, name, root)
    ctl = Controller(ServeConfig(
        config=dataclasses.asdict(cfg), promote_every=1, restart_budget=2,
        backoff=0.1, jitter_seed=0, env={"CUDA_HOME": stub_home}))
    launch = ctl._launch
    ctl._launch = lambda: TimedLifetime(launch(), lifetimes)
    return ctl


def final_epoch_row(ctl):
    epochs = [e for e in read_journal(ctl.journal_path)
              if e["kind"] == "epoch"]
    last = max(epochs, key=lambda e: e["epoch"])
    return (last["epoch"], last["train_loss"], last["train_acc"],
            last["test_acc_mean"], last["disagreement"])


def first_beats(run_dir: str, lifetimes: list) -> list:
    """Seconds from each lifetime's launch to its first heartbeat (the
    trainer's start-up and its first epoch); ``None`` for a lifetime that
    wrote none before it ended."""
    path = os.path.join(run_dir, "health", "host0.jsonl")
    beats = []
    if os.path.exists(path):
        with open(path) as f:
            beats = [json.loads(line)["t"] for line in f]
    out = []
    for life in lifetimes:
        end = life["launched"] + life["seconds"]
        after = [t for t in beats if life["launched"] < t <= end]
        out.append(min(after) - life["launched"] if after else None)
    return out


def phase_serve(dev, rounds: int = 3, steps: int = 20):
    """The run controller on the card (cell (n)): slice (a) with ``save``
    and a checkpoint every epoch.

    1. Identity knobs: ``train()`` for 3 epochs with a ``TrainerHarness``
       that has no control file and no serving dir, and without a hook:
       final parameters bitwise, per-epoch loss and disagreement equal, K1
       launched ``epochs·bpe + epochs·timer_chains(bpe)`` times in each,
       and the same synchronizing calls (the sync debug mode) in each run
       and in 8 steps of the step with identity knobs and without.
    2. Swaps: 4 epochs, ``{"version": 1, "budget": 0.25}`` published
       before epoch 1's boundary and ``{"version": 2, "local_steps": 2}``
       before epoch 2's: two ``apply`` events, the budget's numbers equal
       ``resolve_budget_swap`` on the host, each with a re-based
       ``predicted``; K1 launched 4, 4, 2, 2 times plus the timer's
       chains; finite; a K1 launch of epoch 1 got exactly the weights
       built from the journaled scales, and K1 on those weights at T = 4
       is bitwise ``perm_gossip_plain`` on the run's final state.
    3. The daemon: ``Controller`` in a thread behind a ``ServeEndpoint``,
       3 epochs, a promotion every epoch; run A uninterrupted and, beside
       it on the card, run B SIGKILLed once its first checkpoint lands: B
       1 restart, 2 lifetimes, one supervisor ``restart`` event, B's last
       epoch row and promoted arrays equal A's; ``/status`` and
       ``/promoted`` 200, ``/healthz`` 200 or 503 as the ``fleet_verdict``
       it serves says (the detectors flag w4 on this slice: 503);
       ``serve_torch.py verify`` 0, then 1 after a byte of
       ``MANIFEST.json`` is edited; no lifetime ran ``nvcc`` (a stub that
       fails) nor changed ``_build/``.  The children's output goes to a
       file.
    4. ms a step with identity knobs and without, alternated rounds.
    Any failure raises."""
    import signal

    from matcha_tpu_torch.communicator import decen
    from matcha_tpu_torch.obs import fleet_verdict
    from matcha_tpu_torch.plan import resolve_budget_swap
    from matcha_tpu_torch.serve import (
        TrainerHarness,
        control_arrays,
        verify_promoted,
        write_control,
    )

    t_phase = time.perf_counter()
    bpe = 2048 // 16 // 32
    chains = timer_chains(bpe)
    out = {"launches": {}}
    with tempfile.TemporaryDirectory() as root:
        # 1. identity knobs against no hook
        sync_warnings(lambda: torch.zeros(1, device=dev).sum().item())
        runs, syncs = {}, {}
        for label, hook in (("plain", None),
                            ("identity", CountingHook(
                                TrainerHarness({}).on_boundary))):
            cfg = serve_config(3, f"serve_{label}", root)
            reset_launch_counts()
            holder = {}
            syncs[label] = sync_warnings(lambda cfg=cfg, hook=hook: holder.
                                         update(r=train(cfg, device=dev,
                                                        boundary_hook=hook)))
            torch.cuda.synchronize()
            runs[label] = (holder["r"], LAUNCHES["perm_gossip_dbuf"])
        (plain, n_plain), (ident, n_ident) = runs["plain"], runs["identity"]
        want = 3 * bpe + 3 * chains
        if n_plain != want or n_ident != want:
            raise AssertionError(f"serve identity: K1 {n_plain} and "
                                 f"{n_ident} launches, expected {want}")
        if not same_bits(flat_params(plain.state), flat_params(ident.state)):
            raise AssertionError("serve identity: final parameters differ")
        rows = {k: [(h["loss"], h["disagreement"]) for h in r.history]
                for k, (r, _) in runs.items()}
        if rows["plain"] != rows["identity"]:
            raise AssertionError(f"serve identity: epochs {rows}")
        steppers = {}
        matchings = build_schedule(slice_config(1), 5).num_matchings
        for on in (True, False):
            state, step, xb, yb = slice_stepper(dev, 40, control=on)
            if on:
                state.control = control_arrays(
                    np.ones(matchings, np.float32), 1.0, 1, dev)
            for _ in range(2):
                state, _ = step(state, xb, yb)
            torch.cuda.synchronize()
            steppers[on] = (state, step, xb, yb)

            def eight(state=state, step=step, xb=xb, yb=yb):
                for _ in range(8):
                    step(state, xb, yb)

            syncs[f"step x8, knobs {'on' if on else 'off'}"] = \
                sync_warnings(eight)
        totals = {k: sum(v.values()) for k, v in syncs.items()}
        if totals["plain"] != totals["identity"] \
                or totals["step x8, knobs on"] != totals["step x8, knobs off"]:
            raise AssertionError(f"serve identity: synchronizing calls "
                                 f"{syncs}")
        out["identity"] = {
            "launches": {"plain": n_plain, "identity": n_ident,
                         "expected": want},
            "bitwise": True, "loss": [r[0] for r in rows["plain"]],
            "disagreement": [r[1] for r in rows["plain"]],
            "sync_calls": totals, "sync_calls_where": syncs,
            "ms_per_step_plain": [h["epoch_time"] / bpe * 1e3
                                  for h in plain.history],
            "ms_per_step_identity": [h["epoch_time"] / bpe * 1e3
                                     for h in ident.history]}
        out["launches"]["train() serve, unsupervised"] = n_plain
        out["launches"]["train() serve, identity knobs"] = n_ident
        del plain, ident, runs

        # 2. the swaps
        control = os.path.join(root, "control.json")

        def publish(seam):
            if seam.epoch == 1:
                write_control(control, {"version": 1,
                                        "budget": SERVE_BUDGET})
            elif seam.epoch == 2:
                write_control(control, {"version": 2, "local_steps": 2})

        hook = CountingHook(TrainerHarness({"control_path": control})
                            .on_boundary, before=publish)
        inner_run = decen.perm_gossip_run
        seen = []

        def capture_k1(x, weights, perms, partnered, **kw):
            if len(hook.launches) == 2 and not seen:  # epoch 1's first
                seen.append(weights.clone())
            return inner_run(x, weights, perms, partnered, **kw)

        cfg = serve_config(4, "serve_swap", root)
        reset_launch_counts()
        decen.perm_gossip_run = capture_k1
        try:
            swapped = train(cfg, device=dev, boundary_hook=hook)
        finally:
            decen.perm_gossip_run = inner_run
        torch.cuda.synchronize()
        per_epoch = k1_by_epoch(hook.launches + [LAUNCHES["perm_gossip_dbuf"]])
        if per_epoch != [bpe + chains, bpe + chains, bpe // 2 + chains,
                         bpe // 2 + chains]:
            raise AssertionError(f"serve swap: K1 by epoch {per_epoch}")
        bad = [h["epoch"] for h in swapped.history
               if not (math.isfinite(h["loss"])
                       and math.isfinite(h["disagreement"]))]
        events = read_journal(os.path.join(swapped.recorder.folder,
                                           "events.jsonl"))
        applied = of_kind(events, "control")
        sched = swapped.schedule
        swap = resolve_budget_swap(sched, SERVE_BUDGET)
        if bad or [(e["action"], e["applied"], e["epoch"]) for e in applied] \
                != [("apply", True, 1), ("apply", True, 2)] \
                or any(validate_event(e) for e in events):
            raise AssertionError(f"serve swap: non-finite {bad}, control "
                                 f"{applied}")
        got = applied[0]["fields"]["budget"]
        if [got["alpha"], got["rho"], got["alpha_scale"], got["row_scale"]] \
                != [swap["alpha"], swap["rho"], swap["alpha_scale"],
                    [float(v) for v in swap["row_scale"]]] \
                or applied[1]["fields"] != {"local_steps": 2} \
                or any(not e.get("predicted", {}).get("rho")
                       for e in applied) \
                or applied[0]["predicted"]["plan_alpha"] != swap["alpha"]:
            raise AssertionError(f"serve swap: journaled {applied}, host "
                                 f"{swap}")
        # K1 on weights built from the journaled scales: α·((f·r)·s) in
        # f32, the step's order
        rs = torch.tensor(got["row_scale"], dtype=torch.float32, device=dev)
        scale = float(np.float32(got["alpha_scale"]))
        alpha = float(sched.alpha)
        flags = torch.as_tensor(np.asarray(sched.flags[bpe:bpe + 4],
                                           np.float32), device=dev)
        weights = alpha * ((flags * rs) * scale)
        if not seen or not same_bits(seen[0][0], weights[0]):
            raise AssertionError(f"serve swap: K1's epoch-1 weights "
                                 f"{seen[0].tolist() if seen else None} vs "
                                 f"{weights[0].tolist()}")
        _, perms, partnered = _tables(sched, dev)
        x = flat_params(swapped.state)
        kernel = perm_gossip_run(x, weights, perms, partnered)
        plain_out = perm_gossip_plain(x, weights, perms, partnered)
        if not same_bits(kernel, plain_out):
            raise AssertionError("serve swap: K1 on the scaled weights is "
                                 "not bitwise its plain version")
        out["swap"] = {
            "k1_by_epoch": per_epoch, "launches": sum(per_epoch),
            "budget": SERVE_BUDGET, "alpha": got["alpha"], "rho": got["rho"],
            "alpha_scale": got["alpha_scale"], "row_scale": got["row_scale"],
            "unreachable": got["unreachable"],
            "predicted_rho": [e["predicted"]["rho"] for e in applied],
            "loss": [h["loss"] for h in swapped.history],
            "disagreement": [h["disagreement"] for h in swapped.history],
            "k1_scaled_weights_bitwise": True,
            "max_abs_err": float((kernel - plain_out).abs().max())}
        out["launches"]["train() serve, budget and local_steps swaps"] = \
            sum(per_epoch)
        del swapped, x, kernel, plain_out, seen
        torch.cuda.empty_cache()

        # 3. the daemon, A uninterrupted and B killed
        from matcha_tpu_torch.serve import ServeEndpoint

        stub, marker = stub_cuda_home(root)
        built = built_kernels()
        log = os.path.join(root, "children.log")
        lives = {"A": [], "B": []}
        ctls = {k: serve_controller(os.path.join(root, k), f"serve{k}", stub,
                                    lives[k]) for k in lives}
        endpoint = ServeEndpoint(ctls).start()
        codes = {"healthz": [], "status": [], "promoted": []}
        verdicts, flagged = [], set()
        alive_seen = {"A": False, "B": False}
        rcs = {}
        try:
            with output_to(log):
                # A and B run side by side on the card, each its own
                # daemon thread and trainer process
                threads = {name: threading.Thread(
                    target=lambda c=ctl, n=name: rcs.update({n: c.run()}),
                    daemon=True) for name, ctl in ctls.items()}
                for thread in threads.values():
                    thread.start()
                killed = False
                deadline = time.time() + 400
                while any(t.is_alive() for t in threads.values()) \
                        and time.time() < deadline:
                    for name, ctl in ctls.items():
                        if not threads[name].is_alive():
                            continue
                        code, body = http_get(endpoint.port,
                                              f"/status?run={name}")
                        codes["status"].append(code)
                        alive_seen[name] |= bool(body.get("trainer_alive"))
                        if os.path.exists(os.path.join(
                                ctl.run_dir, "health", "host0.jsonl")):
                            # /healthz bracketed by the verdict it serves
                            before = fleet_verdict(ctl.run_dir)[0]
                            code, health = http_get(endpoint.port,
                                                    f"/healthz?run={name}")
                            if fleet_verdict(ctl.run_dir)[0] == before:
                                codes["healthz"].append(code)
                                verdicts.append((before, code))
                                flagged.update(
                                    f"{a['subject']} {a['cause']}"
                                    for a in health.get("anomalies", []))
                        proc = ctl._proc
                        if name == "B" and not killed and proc is not None \
                                and latest_step(ctl.ckpt_dir) is not None:
                            proc.send_signal(signal.SIGKILL)
                            killed = True
                    time.sleep(0.02)
                for name, thread in threads.items():
                    thread.join(timeout=30)
                    if thread.is_alive():
                        for ctl in ctls.values():
                            ctl.shutdown()
                        raise AssertionError(f"serve daemon {name}: still "
                                             f"running after 400 s")
                    codes["promoted"].append(http_get(
                        endpoint.port, f"/promoted?run={name}")[0])
        except BaseException:
            with open(log, "rb") as f:
                f.seek(max(os.path.getsize(log) - 4096, 0))
                sys.stderr.write(f.read().decode(errors="replace"))
            raise
        finally:
            endpoint.stop()
        a, b = ctls["A"], ctls["B"]
        restarts = [e for e in read_journal(b.journal_path)
                    if e["kind"] == "control" and e["action"] == "restart"]
        if rcs != {"A": 0, "B": 0} or (a.restarts_used, a.lifetimes) != (0, 1) \
                or (b.restarts_used, b.lifetimes) != (1, 2) \
                or len(restarts) != 1 or restarts[0]["epoch"] != -1:
            raise AssertionError(f"serve daemon: exits {rcs}, A "
                                 f"{a.status()}, B {b.status()}, restart "
                                 f"events {restarts}")
        if final_epoch_row(a) != final_epoch_row(b):
            raise AssertionError(f"serve daemon: last rows "
                                 f"{final_epoch_row(a)} vs "
                                 f"{final_epoch_row(b)}")
        promoted = {}
        for name, ctl in ctls.items():
            manifest = verify_promoted(ctl.serving_dir)
            with np.load(os.path.join(ctl.serving_dir,
                                      manifest["params_file"])) as npz:
                promoted[name] = (manifest["epoch"],
                                  {k: npz[k] for k in npz.files})
        same = (promoted["A"][0] == promoted["B"][0]
                and sorted(promoted["A"][1]) == sorted(promoted["B"][1])
                and all(np.array_equal(v, promoted["B"][1][k])
                        for k, v in promoted["A"][1].items()))
        if not same:
            raise AssertionError("serve daemon: promoted arrays differ")
        # /healthz is 200 on a healthy fleet and 503 on a flagged one (the
        # detectors flag the slice's w4 as a disagreement outlier, PR 15)
        wrong = [(v, c) for v, c in verdicts
                 if c != (200 if v == 0 else 503)]
        if wrong or not any(v in (0, 1) for v, _ in verdicts) \
                or set(codes["status"]) != {200} \
                or codes["promoted"] != [200, 200] \
                or not all(alive_seen.values()):
            raise AssertionError(
                f"serve endpoint: codes {codes}, trainer alive "
                f"{alive_seen}, fleet verdicts now "
                f"{[fleet_verdict(c.run_dir) for c in ctls.values()]}")
        verify = [sys.executable, "serve_torch.py", "verify", b.serving_dir]
        here = os.path.dirname(os.path.abspath(__file__))
        rc_ok = subprocess.run(verify, cwd=here, capture_output=True,
                               timeout=120).returncode
        pointer = os.path.join(b.serving_dir, "MANIFEST.json")
        blob = bytearray(open(pointer, "rb").read())
        at = blob.index(b'"epoch": ') + len(b'"epoch": ')
        blob[at] = ord("7") if blob[at] != ord("7") else ord("8")
        open(pointer, "wb").write(bytes(blob))
        rc_bad = subprocess.run(verify, cwd=here, capture_output=True,
                                timeout=120).returncode
        if (rc_ok, rc_bad) != (0, 1):
            raise AssertionError(f"serve_torch.py verify: {rc_ok} then "
                                 f"{rc_bad}, expected 0 then 1")
        rebuilt = built_kernels()
        if os.path.exists(marker) or rebuilt != built:
            raise AssertionError(f"serve daemon: a lifetime ran nvcc "
                                 f"({os.path.exists(marker)}) or changed "
                                 f"the build ({built} vs {rebuilt})")
        out["daemon"] = {
            "restarts_used": {k: c.restarts_used for k, c in ctls.items()},
            "lifetimes": {k: c.lifetimes for k, c in ctls.items()},
            "lifetime_seconds": [life["seconds"] for k in ("A", "B")
                                 for life in lives[k]],
            "lifetime_exits": [life["exit"] for k in ("A", "B")
                               for life in lives[k]],
            "first_heartbeat_seconds": [
                s for k in ("A", "B")
                for s in first_beats(ctls[k].run_dir, lives[k])],
            "final_row": list(final_epoch_row(a)),
            "promoted_epoch": promoted["A"][0],
            "promoted_arrays_equal": True,
            "endpoint_codes": {k: sorted(set(v)) for k, v in codes.items()},
            "healthz_verdicts": sorted({f"{v}->{c}" for v, c in verdicts}),
            "flagged": sorted(flagged),
            "verify_exits": [rc_ok, rc_bad], "nvcc_called": False,
            "children_log_bytes": os.path.getsize(log)}
    torch.cuda.empty_cache()

    # 4. ms a step with identity knobs and without, alternated
    for on, (state, step, xb, yb) in steppers.items():
        for _ in range(3):
            state, _ = step(state, xb, yb)
    ms = {True: [], False: []}
    for r in range(rounds):
        for on in ((True, False) if r % 2 == 0 else (False, True)):
            state, step, xb, yb = steppers[on]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                state, _ = step(state, xb, yb)
            torch.cuda.synchronize()
            ms[on].append((time.perf_counter() - t0) / steps * 1e3)
    del steppers
    torch.cuda.empty_cache()
    out["step"] = {"ms_per_step_knobs": ms[True],
                   "ms_per_step_plain": ms[False],
                   "median_ms_knobs": statistics.median(ms[True]),
                   "median_ms_plain": statistics.median(ms[False])}
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "serve", **out, "nvidia_smi": nvidia_smi()})
    return out

#: one seed of each family the chaos phase runs, by ``schedule_for_seed``:
#: the four kill families (6 and 8 by SIGKILL, 7 and 9 by SIGTERM; 6 at
#: the second epoch boundary), ``ckpt_bitflip`` (0) and ``io_enospc`` (10:
#: the third and fourth heartbeat writes fail)
CHAOS_SEEDS = (6, 7, 8, 9, 0, 10)
#: ``run_trial``'s control document for ``kill_mid_control``, which its
#: twin trains under too
CHAOS_CONTROL_DOC = {"version": 1, "drift_tolerance": 5.0}


def chaos_trial_config(save_path: str, epochs: int) -> dict:
    """Slice (a) with ``save`` and a checkpoint every epoch, in the place
    of the campaign's MLP ring (``campaign._trial_config``)."""
    return dataclasses.asdict(serve_config(epochs, "chaos", save_path))


def chaos_armed_taps(dev, root: str, bpe: int, env_lock) -> dict:
    """Slice (a)'s ``train()`` (2 epochs, ``save``, a checkpoint an epoch)
    with the taps unarmed, then armed at ``epoch_boundary`` with a marker
    that already exists (so the tap cannot fire in this process): final
    parameters bitwise, K1's launches equal (the wrapper's count and the
    profiler's kernel rows), synchronizing calls equal.

    The tap reads ``MATCHA_CHAOS_KILL`` once, at its first call: the
    variable is set under ``env_lock``, parsed there by a call at another
    barrier (which returns at once), and removed again, so a trainer
    subprocess launched under the same lock meanwhile never inherits
    it."""
    from unittest import mock

    from torch.profiler import ProfilerActivity, profile

    from matcha_tpu_torch.chaos import taps

    marker = os.path.join(root, "already_fired")
    open(marker, "w").close()
    armed_spec = json.dumps({"barrier": "epoch_boundary", "count": 1,
                             "signal": "KILL", "marker": marker})
    sync_warnings(lambda: torch.zeros(1, device=dev).sum().item())
    runs = {}
    for label, env in (("unarmed", {}), ("armed", {taps.ENV_KILL:
                                                     armed_spec})):
        cfg = serve_config(2, f"chaos_{label}", root)
        holder = {}

        def run(cfg=cfg, holder=holder):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                holder["r"] = train(cfg, device=dev)
                torch.cuda.synchronize()
            holder["rows"] = sum(
                e.device_type == torch.autograd.DeviceType.CUDA
                and "perm_gossip" in e.name for e in prof.events())

        with env_lock, mock.patch.dict(os.environ, env):
            if label == "unarmed":
                os.environ.pop(taps.ENV_KILL, None)
            taps.reset()
            taps.maybe_kill("mid_save")  # parses the spec; not its barrier
        reset_launch_counts()
        syncs = sync_warnings(run)
        spec = taps._spec
        taps.reset()
        runs[label] = {"result": holder["r"], "spec": spec,
                       "launches": LAUNCHES["perm_gossip_dbuf"],
                       "profiler_rows": holder["rows"], "sync": syncs}
    unarmed, armed = runs["unarmed"], runs["armed"]
    want = 2 * bpe + 2 * timer_chains(bpe)
    if unarmed["spec"] is not None or armed["spec"] is None \
            or armed["spec"]["barrier"] != "epoch_boundary" \
            or os.path.getsize(marker) != 0:
        raise AssertionError(f"chaos armed taps: specs {unarmed['spec']}, "
                             f"{armed['spec']}")
    if not same_bits(flat_params(unarmed["result"].state),
                     flat_params(armed["result"].state)):
        raise AssertionError("chaos armed taps: final parameters differ")
    counts = [(r["launches"], r["profiler_rows"]) for r in runs.values()]
    if counts != [(want, want)] * 2:
        raise AssertionError(f"chaos armed taps: K1 launches and profiler "
                             f"rows {counts}, expected {want} each")
    if sum(unarmed["sync"].values()) != sum(armed["sync"].values()):
        raise AssertionError(f"chaos armed taps: synchronizing calls "
                             f"{unarmed['sync']} vs {armed['sync']}")
    return {"launches": want, "profiler_rows": want, "bitwise": True,
            "sync_calls": {k: sum(r["sync"].values())
                           for k, r in runs.items()},
            "loss": [h["loss"] for h in armed["result"].history],
            "ms_per_step": {k: [h["epoch_time"] / bpe * 1e3
                                for h in r["result"].history]
                            for k, r in runs.items()}}


def phase_chaos(dev, workers: int = 3):
    """The chaos harness on the card (cell (o)): the port's own campaign
    machinery (``matcha_tpu_torch.chaos.campaign``) with slice (a) in the
    place of its MLP ring (``_trial_config`` patched here, the module
    unchanged), 4 epochs of 4 steps, ``save``, a checkpoint every epoch,
    K1 at T = 1 every step.

    1. Armed taps that cannot fire cost nothing (``chaos_armed_taps``, in
       this process while the trials run).
    2. One trial per seed of ``CHAOS_SEEDS`` through ``run_trial(...,
       device="cuda")``, up to ``workers`` at once on the card, after the
       three uninterrupted twins the kill families read (run first, side
       by side).  Each trial ``ok`` (no violation of the invariant
       suite); each kill family's marker fired, 1 restart, its killed
       lifetime's exit the spec's signal, its final epoch row
       float-equal to its twin's (the resume bitwise through K1); each
       lifetime that ran to its end journaled a ``backend`` event saying
       ``perm`` (a killed lifetime's journal dies unflushed with it);
       each lifetime's seconds and seconds to its first heartbeat; no
       lifetime ran ``nvcc`` (a stub that fails) or changed ``_build/``.
       The children's output goes to a file.
    Any failure raises."""
    import concurrent.futures
    import signal
    from unittest import mock

    from matcha_tpu_torch.chaos import campaign
    from matcha_tpu_torch.chaos.invariants import final_epoch_row as row_of
    from matcha_tpu_torch.serve import Controller

    t_phase = time.perf_counter()
    bpe = 2048 // 16 // 32
    out = {"launches": {}}
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        work = os.path.join(root, "campaign")
        stub, marker = stub_cuda_home(root)
        built = built_kernels()
        log = os.path.join(root, "children.log")
        lives, logs = {}, []
        launch = Controller._launch
        env_lock = threading.Lock()  # a launch copies os.environ

        def timed_launch(ctl):
            with env_lock:
                proc = launch(ctl)
            return TimedLifetime(proc, lives.setdefault(
                os.path.abspath(ctl.run_dir), []))

        specs = [campaign.schedule_for_seed(s) for s in CHAOS_SEEDS]
        twin_of = {s.seed: (s.family == "kill_mid_promote",
                            s.family == "kill_mid_control")
                   for s in specs if s.family.startswith("kill_")}
        t_trials = time.perf_counter()
        try:
            with mock.patch.object(campaign, "_trial_config",
                                   chaos_trial_config), \
                    mock.patch.object(Controller, "_launch", timed_launch), \
                    mock.patch.dict(os.environ, {"CUDA_HOME": stub}), \
                    output_to(log), \
                    concurrent.futures.ThreadPoolExecutor(workers) as pool:
                twins = {key: pool.submit(
                    campaign._twin_row, work, 4, key[0],
                    CHAOS_CONTROL_DOC if key[1] else None, logs.append,
                    "cuda") for key in sorted(set(twin_of.values()))}

                def trial(spec):
                    if spec.seed in twin_of:  # cached before the trial
                        twins[twin_of[spec.seed]].result()
                    return campaign.run_trial(spec, work, log=logs.append,
                                              device="cuda")

                jobs = {s.seed: pool.submit(trial, s) for s in specs}
                armed = chaos_armed_taps(dev, root, bpe, env_lock)
                trials = {seed: job.result() for seed, job in jobs.items()}
                for job in twins.values():
                    job.result()
        except BaseException:
            with open(log, "rb") as f:
                f.seek(max(os.path.getsize(log) - 4096, 0))
                sys.stderr.write(f.read().decode(errors="replace"))
            sys.stderr.write("\n".join(logs[-20:]) + "\n")
            raise
        trials_seconds = time.perf_counter() - t_trials
        out["armed_taps"] = armed
        out["launches"]["train() chaos, taps unarmed"] = armed["launches"]
        out["launches"]["train() chaos, taps armed (not firing)"] = \
            armed["launches"]
        if sum("running uninterrupted twin" in m for m in logs) != \
                len(twins):
            raise AssertionError(f"chaos: twins recomputed: {logs}")
        rows, problems = [], []
        for spec in specs:
            t = trials[spec.seed]
            run_dir = os.path.dirname(os.path.abspath(t["journal_path"]))
            life = lives.get(run_dir, [])
            events = read_journal(t["journal_path"])
            backends = [e.get("chosen") for e in events
                        if e["kind"] == "backend"]
            clean = [x for x in life if x["exit"] == 0]
            bad = list(t["violations"])
            if not t["ok"] or backends != ["perm"] * len(clean) \
                    or any(validate_event(e) for e in events):
                bad.append(f"backends {backends} for {len(clean)} clean "
                           f"lifetimes")
            if spec.family.startswith("kill_"):
                killed = [x["exit"] for x in life if x["exit"] != 0]
                sig = -getattr(signal, f"SIG{spec.signal}")
                if not t["evidence"].get("fired") or t["restarts_used"] != 1 \
                        or killed != [sig] \
                        or tuple(t["twin_row"]) != row_of(events):
                    bad.append(f"fired {t['evidence'].get('fired')}, "
                               f"restarts {t['restarts_used']}, exits "
                               f"{[x['exit'] for x in life]}, twin "
                               f"{t.get('twin_row')} vs {row_of(events)}")
            elif t["restarts_used"] != 0:
                bad.append(f"restarts {t['restarts_used']}")
            if bad:
                problems.append(f"seed {spec.seed} [{spec.family}]: {bad}")
            rows.append({
                "seed": spec.seed, "family": spec.family,
                "signal": spec.signal if spec.family.startswith("kill_")
                else None, "spec": spec.to_json(), "ok": t["ok"],
                "rc": t["rc"], "restarts_used": t["restarts_used"],
                "lifetimes": len(life),
                "lifetime_exits": [x["exit"] for x in life],
                "lifetime_seconds": [x["seconds"] for x in life],
                "first_heartbeat_seconds": first_beats(run_dir, life),
                "backend_events": backends,
                "evidence": {k: v for k, v in t["evidence"].items()
                             if k != "env"},
                "final_row": list(row_of(events)),
                "twin_row": (list(t["twin_row"]) if "twin_row" in t
                             else None)})
        out["twins"] = {}
        for run_dir, life in lives.items():
            key = os.path.basename(os.path.dirname(run_dir))
            if os.path.basename(os.path.dirname(os.path.dirname(
                    run_dir))) != "twins":
                continue
            events = read_journal(os.path.join(run_dir, "events.jsonl"))
            backends = [e.get("chosen") for e in events
                        if e["kind"] == "backend"]
            if [x["exit"] for x in life] != [0] or backends != ["perm"]:
                problems.append(f"twin {key}: exits "
                                f"{[x['exit'] for x in life]}, backends "
                                f"{backends}")
            out["twins"][key] = {
                "row": list(row_of(events)),
                "lifetime_seconds": [x["seconds"] for x in life],
                "first_heartbeat_seconds": first_beats(run_dir, life)}
        if len(out["twins"]) != len(twins):
            problems.append(f"twins run: {sorted(out['twins'])}")
        rebuilt = built_kernels()
        if os.path.exists(marker) or rebuilt != built:
            problems.append(f"a lifetime ran nvcc ({os.path.exists(marker)})"
                            f" or changed the build ({built} vs {rebuilt})")
        if problems:
            raise AssertionError(f"chaos: {problems}")
        out["trials"] = rows
        out["trials_seconds"] = trials_seconds
        out["workers"] = workers
        out["nvcc_called"] = False
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "chaos", **out, "nvidia_smi": nvidia_smi()})
    return out


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


def subnormal_share(x: torch.Tensor) -> dict:
    """Shares of zeros and of subnormals (nonzero, below 2⁻¹²⁶, bf16 and
    f32 alike) in ``x``."""
    a = x.float().abs()
    return {"zero_share": float((a == 0).float().mean()),
            "subnormal_share": float(((a > 0) & (a < 2.0 ** -126))
                                     .float().mean())}


# launches of the probe's main(): its two equality runs, then one warm-up
# and --reps timed runs of each schedule
def probe_launches(reps: int) -> int:
    return 2 + 2 * (1 + reps)


def reversed_plain(x, stack):
    """The plain version with the workers in reverse order: the same
    products, each output's sum over k taken in another order."""
    return fused_gossip_plain(x.flip(0), stack.flip(1).flip(2)).flip(0)


def phase_split_probe(dev):
    """K4 on the probe's full-width inputs: split against unsplit bitwise
    at T = 1, 8, 16, 32 and 64, where the state is normal; both against the
    plain version, to one bf16 ulp up to T = 8 and deeper also next to the
    chain's own spread (the plain version against itself with each sum
    taken in another order); every step of the T = 64 chain to one ulp
    (the chain equals its 64 one-step launches bitwise); one step in f32
    against a float64 product; then the T = 2000 output's magnitude and
    the probe's own record (its launches counted)."""
    from matcha_tpu_torch.probes import split_probe as sp

    gen = torch.Generator(device=dev).manual_seed(SEED)
    x, stack = sp.make_inputs(256, SLICE_D, 64, gen)
    reset_launch_counts()
    made, rows, worst = 0, [], 0.0
    for t_steps in (1, 8, 16, 32, 64):
        s = stack[:t_steps]
        w_window = min(t_steps, sp.W_WINDOW)
        base = sp.split_gossip_run(x, s, split=False, w_window=w_window)
        split = sp.split_gossip_run(x, s, split=True, w_window=w_window)
        made += 2
        torch.cuda.synchronize()
        ref = sp.split_gossip_plain(x, s)
        spread = max_err(reversed_plain(x, s), ref)
        # one bf16 ulp at the output's largest magnitude up to T = 8;
        # deeper, one ulp or twice the chain's own spread, whichever is
        # larger: the probe's random W_t do not contract rounding
        # differences the way a gossip chain does.  The stepped check below
        # holds every step of the T = 64 chain to one ulp.
        bar = fused_bar(ref, x, s)
        if t_steps > 8:
            bar = max(bar, 2.0 * spread)
        row = {"T": t_steps, "bitwise": same_bits(split, base),
               "max_abs_out": float(base.float().abs().max()),
               **subnormal_share(base), "bar": bar,
               "one_ulp_bar": fused_bar(ref, x, s),
               "plain_vs_reordered_plain_max_abs_err": spread,
               "kernel_vs_plain_differ_share": float(
                   (base != ref).float().mean())}
        if not row["bitwise"]:
            raise AssertionError(f"split_gossip T={t_steps}: split and "
                                 f"unsplit schedules differ")
        for name, out in (("unsplit", base), ("split", split)):
            err = max_err(out, ref)
            worst = max(worst, err)
            row[f"{name}_vs_plain_max_abs_err"] = err
            if not err <= bar:
                raise AssertionError(f"split_gossip {name} T={t_steps}: "
                                     f"max |Δ| {err} > {bar}")
        rows.append(row)
        del base, split, ref
    # each step of the T = 64 chain to one bf16 ulp: the chain equals 64
    # one-step launches bitwise (the state is bf16 between steps either
    # way), and each launch is held to the plain step on the same input
    chain = sp.split_gossip_run(x, stack, split=False)
    cur, step_worst = x, 0.0
    for t in range(stack.shape[0]):
        w_t = stack[t:t + 1]
        nxt = sp.split_gossip_run(cur, w_t, split=False, w_window=1)
        ref = sp.split_gossip_plain(cur, w_t)
        err, bar = max_err(nxt, ref), fused_bar(ref, cur, w_t)
        if not err <= bar:
            raise AssertionError(f"split_gossip step {t} of 64: max |Δ| "
                                 f"{err} > one bf16 ulp {bar}")
        step_worst = max(step_worst, err / bar)
        cur = nxt
    made += 1 + stack.shape[0]
    if not same_bits(cur, chain):
        raise AssertionError("split_gossip: the T = 64 chain differs from "
                             "its 64 one-step launches")
    stepped = {"steps": stack.shape[0], "chain_equals_steps": True,
               "worst_step_err_over_one_ulp_bar": step_worst}
    del chain, cur, nxt, ref
    # one step on an f32 state: the tensor cores' f32 sum and cuBLAS's
    # against a float64 product of the same bf16 operands
    xf = x.float()
    exact = torch.matmul(stack[0].double(), xf.double())
    scale = float(exact.abs().max())
    one = sp.split_gossip_run(xf, stack[:1], split=False, w_window=1)
    made += 1
    one_step = {"kernel_vs_f64_max_abs_err": max_err(one, exact),
                "plain_vs_f64_max_abs_err": max_err(
                    sp.split_gossip_plain(xf, stack[:1]), exact),
                "max_abs_ref": scale}
    del xf, exact, one
    if LAUNCHES["split_gossip"] != made:
        raise AssertionError(f"split_gossip launched {LAUNCHES} for {made} "
                             f"calls")
    emit({"phase": "split_probe", "N": 256, "D": SLICE_D, "cases": rows,
          "one_step_f32": one_step, "stepped_T64": stepped,
          "split_vs_unsplit": "bitwise",
          "launches": made})
    del x, stack

    # the probe's own inputs (seed 0, as main's default): how much of the
    # state is left after its 2000 steps
    gen = torch.Generator(device=dev).manual_seed(0)
    x, stack = sp.make_inputs(sp.N, sp.D, sp.T, gen)
    out = sp.split_gossip_run(x, stack, split=False)
    emit({"phase": "split_probe", "T": sp.T,
          "max_abs_out": float(out.float().abs().max()),
          **subnormal_share(out)})
    del x, stack, out
    reps = 3
    reset_launch_counts()
    rec = sp.main(["--reps", str(reps)])
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    if launches["split_gossip"] != probe_launches(reps):
        raise AssertionError(f"the probe launched {launches}, expected "
                             f"split_gossip = {probe_launches(reps)}")
    return {"launches": launches, "record": rec, "max_abs_err": worst}


def phase_split_timing(dev):
    """Both schedules of K4, the plain version (T = 64 only: at T = 2000 it
    repeats the arithmetic step by step for seconds), the library call (T
    bf16 ``torch.matmul`` calls) and the bound, at T = 64 and 2000.  Where
    the profiler's trace of ``runs`` calls holds no record of the kernel,
    ``single_call_device_ms`` profiles one call a session and prints what
    the traces held."""
    from matcha_tpu_torch.probes import split_probe as sp

    flush = L2Flush(dev)
    rows = []
    for t_steps, runs in ((64, 20), (sp.T, 3)):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        x, stack = sp.make_inputs(256, SLICE_D, t_steps, gen)

        def library(x=x, stack=stack):
            out = x
            for t in range(stack.shape[0]):
                out = torch.matmul(stack[t], out)
            return out

        row = {"shape": f"probe [256, {SLICE_D}] bf16 T={t_steps}",
               "N": 256, "D": SLICE_D, "T": t_steps}
        for name, split in (("unsplit", False), ("split", True)):
            fn = lambda split=split: sp.split_gossip_run(  # noqa: E731
                x, stack, split=split)
            row[f"{name}_ms"] = time_ms(fn, flush, runs)
            row[f"{name}_device_ms"] = device_ms(fn, MAINLOOP_KERNEL, flush,
                                                 runs)
            if row[f"{name}_device_ms"] is None:
                row[f"{name}_device_ms"], row[f"{name}_trace"] = \
                    single_call_device_ms(fn, MAINLOOP_KERNEL, flush, runs)
        row["ratio_split_over_unsplit_time"] = row["split_ms"] / row[
            "unsplit_ms"]
        row["plain_ms"] = (time_ms(lambda: sp.split_gossip_plain(x, stack),
                                   flush, runs) if t_steps == 64 else None)
        row["library_ms"] = time_ms(library, flush, runs)
        row["bound_ms"], row["bound_by"] = fused_bound(x, stack)
        rows.append(row)
        emit({"phase": "split_timing", **row})
        del x, stack
    return rows


def ptxas_kernels(text: str) -> list:
    """Registers and spills of each kernel in ``nvcc -Xptxas -v`` output."""
    rows = []
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            rows.append({"kernel": m.group(1)})
            continue
        if not rows:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            rows[-1]["spill_stores"] = int(m.group(1))
            rows[-1]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rows[-1]["registers"] = int(m.group(1))
    return rows


def kernels_line(r) -> list:
    """The kernels summary from the phases' results ``r``."""
    main_shape = {"perm_gossip_dbuf": r["timing"][0],    # T=1, the mix
                  "perm_gossip_stream": r["timing"][1]}  # T=64, the chain
    kernels = []
    # K1's slab path on train()'s per-step mix: the slice, then the
    # reference's other models at their widths
    by_path = {"perm_gossip_dbuf": {"train() slice": r["slice"][
        "perm_gossip_dbuf"], **{f"train() {label}": row["launches"]
                                for label, row in r["models"].items()},
        **r["resilience"]["launches"], **r["pipeline"]["launches"],
        **r["planner"]["launches"], **r["observability"]["launches"],
        **r["perf_obs"]["launches"], **r["serve"]["launches"],
        **r["chaos"]["launches"]},
               "perm_gossip_stream": {"stream chain": r["stream_chain"][
                   "perm_gossip_stream"]}}
    for name, spec in KERNELS.items():
        row = main_shape[name]
        launches = sum(by_path[name].values())
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": spec["replaces"], "launches": launches,
            "launches_by_path": by_path[name],
            "bitwise": True, "max_abs_err": r["parity"][name],
            "shape": row["shape"], "ms": row[f"{name}_ms"],
            "kernel_ms": row[f"{name}_ms"],
            "device_ms": row[f"{name}_device_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "timings": [{"shape": t["shape"], "path": t["path"],
                         "ms": t[f"{name}_ms"],
                         "device_ms": t[f"{name}_device_ms"],
                         "plain_ms": t["plain_ms"],
                         "library_ms": t["library_ms"],
                         "bound_ms": t["bound_ms"],
                         "bound_by": t["bound_by"]} for t in r["timing"]]
            + ([{"shape": f"{label} [{row['workers']}, {row['D']}] T=1",
                 "path": "slab", "ms": row["k1_ms"],
                 "device_ms": row["k1_device_ms"],
                 "plain_ms": row["k1_plain_ms"],
                 "library_ms": row["k1_library_ms"],
                 "bound_ms": row["k1_bound_ms"],
                 "bound_by": row["k1_bound_by"]}
                for label, row in r["models"].items()]
               if name == "perm_gossip_dbuf" else []),
        })
    fused_rows = r["fused_timing"]
    keys = ("shape", "ms", "device_ms", "plain_ms", "library_ms",
            "library_device_ms", "bound_ms", "bound_by")
    # each path of K3 on the entry point that runs it, and its time at that
    # entry point's shape: the register FMA path in the fused slice's timer
    # chains (an f32 stack, T = 4 at the slice's state), the shared-memory
    # FMA path and tensor cores in chain (b) (f32 and bf16, N = 256), the
    # tensor cores chained in registers in the slice-width bf16 chain
    chain_runs = "Communicator.run chain (b), stepped and chunk=64"
    for path, main_label, by_path in (
            ("fma_regs", "slice T=4 f32",
             {"train() fused, timer chains": r["fused_slice"]}),
            ("fma", "hypercube N=256 T=64 f32", {chain_runs: r["fused_chain"]}),
            ("tc_regs", "slice T=64 bf16",
             {"Communicator.run, slice-width bf16 chain": r["fused_chain"]}),
            ("tensor_core", "hypercube N=256 T=64 bf16",
             {chain_runs: r["fused_chain"],
              "obs.costs.roofline_report at chain (b), on the card":
              r["perf_obs"]["roofline_launches"]})):
        counter = f"fused_gossip/{path}"
        launches = sum(run[counter] for run in by_path.values())
        if launches < 1:
            raise AssertionError(f"fused_gossip {path}: no launch on its "
                                 f"main path")
        main = next(t for t in fused_rows if t["shape"] == main_label)
        kernels.append({
            "name": "fused_gossip", "path": path, "route": "cuda",
            "source": FUSED_SOURCE, "replaces": FUSED_REPLACES,
            "launches": launches,
            "launches_by_path": {k: run[counter]
                                 for k, run in by_path.items()},
            "bitwise": False, "max_abs_err": r["fused_parity"][path],
            "spill_stores": r["spills"].get(path),
            **{k: main[k] for k in keys},
            "timings": [{k: t[k] for k in keys} for t in fused_rows
                        if t["path"] == path],
        })
    # the per-step paths on their entry points: make_decen's fused chains
    # at N = 1024 (f32) and 2048 (bf16), times from the sweep
    large = r["fused_large"]
    sweep = r["fused_sweep"]
    for path, main_label, entry in (
            ("fma_step", "sweep N=1024 T=8 f32",
             "Communicator.run, fused f32 chain at N = 1024"),
            ("tc_step", "N=4095 T=1 bf16",
             "Communicator.run, fused bf16 chain at N = 2048")):
        counter = f"fused_gossip/{path}"
        launches = large["launches"][counter]
        if launches < 1:
            raise AssertionError(f"fused_gossip {path}: no launch on its "
                                 f"main path")
        main = next(t for t in sweep if t["shape"] == main_label)
        kernels.append({
            "name": "fused_gossip", "path": path, "route": "cuda",
            "source": FUSED_SOURCE, "replaces": FUSED_REPLACES,
            "launches": launches, "launches_by_path": {entry: launches},
            "bitwise": False,
            "max_abs_err": max(r["fused_parity"].get(path, 0.0),
                               large["worst"].get(path, 0.0)),
            "shape": main["shape"], "ms": main["ms"],
            "device_ms": main["device_ms"],
            "device_ms_per_launch": main["device_ms_per_launch"],
            "spill_stores": main["spill_stores"],
            "plain_ms": main["plain_ms"], "library_ms": main["library_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "timings": [{k: t[k] for k in ("shape", "ms", "device_ms",
                                            "device_ms_per_launch",
                                            "plain_ms", "library_ms",
                                            "bound_ms", "bound_by")}
                        for t in sweep if t["path"] == path]})
    # the perm kernel's band path: make_decen's perm chains past the slab
    # kernel's reach; its main shape the 4096-worker ER graph, one step
    perm = r["perm_large"]
    main = perm["timing"][0]
    kernels.append({
        "name": "perm_gossip_dbuf", "path": "band", "route": "cuda",
        "source": SOURCE, "replaces": KERNELS["perm_gossip_dbuf"]["replaces"],
        "launches": perm["launches"]["perm_gossip/band"]
        + r["planner"]["band_launches"],
        "launches_by_path": {"Communicator.run, perm chains at N = 16384 "
                             "and 4096 (M >= 25)":
                             perm["launches"]["perm_gossip/band"],
                             "Communicator.run, auto at N = 4096 (T = 1)":
                             r["planner"]["band_launches"]},
        "bitwise": True, "max_abs_err": 0.0, "shape": main["shape"],
        "ms": main["ms"], "device_ms": main["device_ms"],
        "plain_ms": main["plain_ms"], "library_ms": main["library_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "spill_stores": r["spills"].get("band"),
        "timings": perm["timing"]})
    split_rows = r["split_timing"]
    main = split_rows[0]  # T=64, where the plain version is timed too
    kernels.append({
        "name": "split_gossip", "path": "tensor_core, split schedule",
        "route": "cuda", "source": FUSED_SOURCE, "replaces": SPLIT_REPLACES,
        "launches": r["split_probe"]["launches"]["split_gossip"],
        "launches_by_path": {"python -m matcha_tpu_torch.probes.split_probe "
                             "(main, --reps 3)":
                             r["split_probe"]["launches"]["split_gossip"]},
        "bitwise": False, "split_vs_unsplit": "bitwise",
        "max_abs_err": r["split_probe"]["max_abs_err"],
        "shape": main["shape"], "ms": main["split_ms"],
        "unsplit_ms": main["unsplit_ms"], "device_ms": main["split_device_ms"],
        "unsplit_device_ms": main["unsplit_device_ms"],
        "spill_stores": r["spills"].get("tensor_core"),
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "probe_record": r["split_probe"]["record"],
        "timings": [{k: t[k] for k in ("shape", "split_ms", "unsplit_ms",
                                       "split_device_ms", "unsplit_device_ms",
                                       "plain_ms", "library_ms", "bound_ms",
                                       "bound_by")} for t in split_rows],
    })
    return kernels


#: the phases in the order a full run takes them, and the phases whose
#: results each one reads (run first when it is asked for alone)
PHASES = ("parity", "timing", "slice", "profile", "agreement",
          "stream_chain", "fused_parity", "fused_timing", "fused_chain",
          "fused_slice", "fused_large", "fused_sweep", "split_probe",
          "split_timing", "epoch_end", "communicators", "perm_large",
          "determinism", "choco", "models", "resilience", "pipeline",
          "planner", "observability", "perf_obs", "serve", "chaos")
NEEDS = {"planner": ("fused_timing",), "perf_obs": ("fused_timing",
                                                    "planner")}


def waited_result(future):
    """``(result, seconds waited for it)``, ``(None, None)`` without a
    future."""
    if future is None:
        return None, None
    t0 = time.perf_counter()
    return future.result(), time.perf_counter() - t0


def run_phases(dev, names, spills, early=None) -> dict:
    """Run ``names`` (and what they read) in ``PHASES`` order, printing
    each one's wall seconds; returns their results by name.  ``early``:
    host work started before the build, by what it is for (``perm_large``:
    a future of the 16,384-worker hypercube's schedule)."""
    early = early or {}
    wanted, todo = set(), list(names)
    while todo:
        name = todo.pop()
        if name not in PHASES:
            raise SystemExit(f"chip_smoke.py: unknown phase {name!r}; have "
                             f"{', '.join(PHASES)}")
        if name not in wanted:
            wanted.add(name)
            todo.extend(NEEDS.get(name, ()))
    tables = {}

    def table(key):
        if key not in tables:
            tables[key] = {"slice": lambda: slice_tables(dev),
                           "big": lambda: hypercube_tables(dev),
                           "huge": lambda: hypercube_tables(dev, 4096)}[key]()
        return tables[key]

    steps = {
        "parity": lambda r: phase_parity(dev, table("slice"), table("big"),
                                         table("huge")),
        "timing": lambda r: phase_timing(dev, table("slice"), table("big"),
                                         table("huge")),
        "perm_large": lambda r: phase_perm_large(dev, *waited_result(
            early.get("perm_large"))),
        "slice": lambda r: phase_slice(dev),
        "profile": lambda r: phase_profile(dev),
        "agreement": lambda r: phase_agreement(dev),
        "stream_chain": lambda r: phase_stream_chain(dev, table("slice")),
        "fused_parity": lambda r: phase_fused_parity(dev, table("slice"),
                                                     table("big")),
        "fused_timing": lambda r: phase_fused_timing(dev, table("slice"),
                                                     table("big")),
        "fused_chain": lambda r: phase_fused_chain(dev, table("slice"),
                                                   table("big")),
        "fused_slice": lambda r: phase_fused_slice(dev),
        "fused_large": lambda r: phase_fused_large(dev),
        "fused_sweep": lambda r: phase_fused_sweep(dev, spills),
        "split_probe": lambda r: phase_split_probe(dev),
        "split_timing": lambda r: phase_split_timing(dev),
        "epoch_end": lambda r: phase_epoch_end(dev),
        "communicators": lambda r: phase_communicators(dev),
        "determinism": lambda r: phase_determinism(dev),
        "choco": lambda r: phase_choco(dev),
        "models": lambda r: phase_models(dev),
        "resilience": lambda r: phase_resilience(dev),
        "pipeline": lambda r: phase_pipeline(dev, table("slice")),
        "planner": lambda r: phase_planner(dev, r["fused_timing"],
                                           table("huge")),
        "observability": lambda r: phase_observability(dev),
        "perf_obs": lambda r: phase_perf_obs(dev, r["fused_timing"],
                                             r["planner"], table("big")),
        "serve": lambda r: phase_serve(dev),
        "chaos": lambda r: phase_chaos(dev),
    }
    results, seconds = {}, {}
    for name in PHASES:
        if name in wanted:
            t0 = time.perf_counter()
            results[name] = steps[name](results)
            seconds[name] = time.perf_counter() - t0
    emit({"phase_seconds": seconds})
    return results


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(
        description="Proof that the port runs on the card: every phase, "
                    "the kernels line and the last line by default.")
    parser.add_argument("--phase", default=None,
                        help="run only these phases (comma-separated, with "
                             "the phases they read); no kernels line. "
                             f"Phases: {', '.join(PHASES)}")
    args = parser.parse_args(argv)
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

    names = (PHASES if args.phase is None
             else [n.strip() for n in args.phase.split(",") if n.strip()])
    # the 16,384-worker hypercube's schedule (minutes of host numpy: α's
    # spectral solve) is made in a process of its own while the kernels
    # build and the first phases run
    import concurrent.futures
    import multiprocessing

    pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    early = ({"perm_large": pool.submit(hypercube_schedule, 16384)}
             if "perm_large" in names else {})
    try:
        run_all(dev, names, early, smi, args.phase is None)
    finally:
        if any(not f.done() for f in early.values()):
            for proc in list((getattr(pool, "_processes", None)
                              or {}).values()):
                proc.kill()
        pool.shutdown(wait=True, cancel_futures=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


def run_all(dev, names, early, smi, kernels: bool) -> None:
    """Build the kernels, run ``names`` and print the kernels line (when
    ``kernels``) and the ``nvidia-smi`` line."""
    t0 = time.perf_counter()
    reports = _kernels.build_all(["perm_gossip", "fused_gossip"])
    ptxas = {k: ptxas_kernels(r["ptxas"]) for k, r in reports.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": [SOURCE, FUSED_SOURCE],
          "cached": {k: r["cached"] for k, r in reports.items()},
          "kernels": ptxas})
    # the per-step kernels, the shared-memory tensor-core mainloop and the
    # perm band kernel were designed to fit their registers: a spill fails
    # the run
    spills = step_spills(ptxas, reports)
    if any(spills.values()):
        raise AssertionError(f"kernels spill registers: {spills}")

    results = run_phases(dev, names, spills, early)
    results["spills"] = spills
    if kernels:
        emit({"kernels": kernels_line(results)})
    print(smi, flush=True)


if __name__ == "__main__":
    main()
