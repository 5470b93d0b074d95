"""Program costs, the cost ledger and the roofline on the card's own peaks.

Port of ``matcha_tpu/obs/costs.py``.  The JAX module asks XLA's compiler
for a program's costs; the port has no compiler to ask, so each number is
re-based on what one call of the program shows:

* **FLOPs**: ``torch.utils.flop_counter.FlopCounterMode`` around one call
  (matrix products and convolutions, forward and backward), plus the hand
  model of each of the port's kernels that the call launches
  (``_kernels.kernel_flop_meter``): a kernel launched through ``ctypes``
  is invisible to the counter.  ``kernel_flops`` says how much of the
  count is those hand models.  Elementwise work is not counted, where
  XLA's count includes it.
* **Boundary bytes** ``hbm_bytes = argument + output − aliased``: the bytes
  of the tensors in and out, less any output that shares storage with an
  input (an in-place update), the JAX module's ``memory_analysis()``
  formula.  ``bytes_accessed`` (XLA's realized traffic) has no counterpart
  and is ``None``.
* **Peak bytes**: on the card, ``torch.cuda.max_memory_allocated`` after
  ``reset_peak_memory_stats`` around the call; elsewhere the arguments
  plus the outputs.  A program over a worker mesh reports its largest
  card's footprint, as the JAX package's per-device memory analysis of
  the SPMD program gives it (and virtual cards of one device, that
  device's).
* **Compile seconds**: the synchronized wall time of that first call
  (it includes a kernel build and cuDNN's algorithm search).

A call on ``meta`` tensors is the counterpart of the JAX module's abstract
compile: shapes only, nothing allocated, nothing run.  The roofline and
capacity functions price their programs that way by default (the plain
version of a kernel's wrapper, whose products the counter sees).

:class:`CostLedger` journals one ``compile`` event per distinct program of
a run; :meth:`CostLedger.call` measures the first call of a program, the
call the loop makes anyway.  :class:`Roofline` divides the per-step costs
by one chip table with no TPU rows: the H100 (the NVIDIA H100 SXM data
sheet) and the CPU-provisional row.  A program whose compute dtype is f32
is priced at the FP32 peak, a bf16 one at the dense bf16 tensor-core
peak; each report names the peak it divided by.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ..parallel.mesh import WorkerBlocks

__all__ = ["ChipSpec", "CHIP_PEAKS", "CPU_PROVISIONAL", "H100", "chip_peaks",
           "resolve_chip", "program_fingerprint", "analyze_program",
           "CostLedger", "Roofline", "gossip_step_costs",
           "gossip_chain_costs", "elision_epoch_costs", "flat_param_dim",
           "roofline_report", "roofline_compare", "capacity_report",
           "render_roofline_markdown", "render_roofline_compare_markdown",
           "render_capacity_markdown"]


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Pinned per-chip peaks: bf16 dense matrix TFLOP/s, FP32 TFLOP/s, HBM
    GB/s and HBM GB.  ``provisional`` marks the CPU row: placeholders for
    relative arithmetic only, never a hardware claim."""

    peak_tflops: float
    peak_gbps: float
    hbm_gb: float
    provisional: bool = False
    peak_tflops_fp32: Optional[float] = None

    def peak_for(self, compute_dtype: str) -> float:
        """TFLOP/s of ``compute_dtype`` (``"bf16"`` or ``"f32"``)."""
        if compute_dtype == "f32" and self.peak_tflops_fp32 is not None:
            return self.peak_tflops_fp32
        return self.peak_tflops


#: NVIDIA H100 SXM data sheet: 989 TFLOP/s bf16 on dense tensor cores,
#: 67 TFLOP/s FP32, 3,350 GB/s HBM3, 80 GB.  The port's one copy of these
#: peaks: the probes' and chip_smoke's bounds read them from here.
H100 = ChipSpec(989.0, 3350.0, 80.0, peak_tflops_fp32=67.0)

#: ``torch.cuda.get_device_name`` substring → pinned peaks
CHIP_PEAKS: Dict[str, ChipSpec] = {"h100": H100}

#: The CPU-provisional row, the JAX package's: order-of-magnitude
#: placeholders for one server core, flagged provisional in every report.
CPU_PROVISIONAL = ChipSpec(0.1, 20.0, 64.0, provisional=True,
                           peak_tflops_fp32=0.1)


def chip_peaks(device_kind: str):
    """``(peak_tflops, peak_gbps)`` of a device name, ``(None, None)`` when
    the table has no row for it."""
    kind = device_kind.lower().replace(" ", "")
    for key, spec in CHIP_PEAKS.items():
        if key in kind:
            return spec.peak_tflops, spec.peak_gbps
    return None, None


def resolve_chip(chip: Optional[str] = None):
    """``(name, ChipSpec)`` of a chip named (a table key, or ``"cpu"`` for
    the provisional row), or of the card when ``chip`` is None.

    Raises ``ValueError`` for an unknown name, for a card the table has no
    row for, and with no card at all: the CPU row is returned only when it
    is asked for, never as a quiet fallback."""
    if chip is not None:
        key = chip.lower().replace(" ", "")
        for name, spec in CHIP_PEAKS.items():
            if name in key:
                return name, spec
        if "cpu" in key:
            return "cpu-provisional", CPU_PROVISIONAL
        raise ValueError(f"unknown chip {chip!r}; have "
                         f"{sorted(CHIP_PEAKS)} or 'cpu'")
    if not torch.cuda.is_available():
        raise ValueError("no CUDA card on this host to take the peaks of; "
                         "pass chip='cpu' for the provisional row")
    kind = torch.cuda.get_device_name(0)
    key = kind.lower().replace(" ", "")
    for name, spec in CHIP_PEAKS.items():
        if name in key:
            return name, spec
    raise ValueError(f"the card {kind!r} has no row in the chip table "
                     f"({sorted(CHIP_PEAKS)}); pass chip= explicitly")


# ---------------------------------------------------------------------------
# Program introspection
# ---------------------------------------------------------------------------

def _walk(obj, visit, optimizer_state: bool) -> None:
    """Call ``visit(tag)`` on the structure and ``visit(tensor)`` on every
    tensor of a call's arguments or outputs: tensors, modules (parameters,
    buffers), dicts, lists, tuples and dataclasses.  An optimizer's state
    is walked only with ``optimizer_state`` (it is created lazily, so the
    first step's signature would differ from the others')."""
    if isinstance(obj, torch.Tensor):
        visit(obj)
    elif isinstance(obj, WorkerBlocks):
        visit(f"WorkerBlocks{len(obj)}")
        for block in obj:
            visit(block)
    elif isinstance(obj, nn.Module):
        visit(type(obj).__name__)
        for t in list(obj.parameters()) + list(obj.buffers()):
            visit(t)
    elif isinstance(obj, torch.optim.Optimizer):
        if optimizer_state:
            for state in obj.state.values():
                _walk(dict(state), visit, optimizer_state)
    elif isinstance(obj, dict):
        visit("dict")
        for k in sorted(obj, key=str):
            visit(str(k))
            _walk(obj[k], visit, optimizer_state)
    elif isinstance(obj, (list, tuple)):
        visit(f"{type(obj).__name__}{len(obj)}")
        for v in obj:
            _walk(v, visit, optimizer_state)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        visit(type(obj).__name__)
        for f in dataclasses.fields(obj):
            _walk(getattr(obj, f.name), visit, optimizer_state)


def _tensors(obj) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    _walk(obj, lambda v: out.append(v) if isinstance(v, torch.Tensor)
          else None, optimizer_state=True)
    return out


def program_fingerprint(label: str, args) -> str:
    """Stable 12-hex id of (label, the arguments' structure and each
    tensor's shape, dtype and device): one fingerprint names one program
    of one call site."""
    h = hashlib.sha1(label.encode())

    def visit(v):
        if isinstance(v, torch.Tensor):
            h.update(f"{tuple(v.shape)}:{v.dtype}:{v.device}".encode())
        else:
            h.update(str(v).encode())

    _walk(args, visit, optimizer_state=False)
    return h.hexdigest()[:12]


def _storage_key(t: torch.Tensor):
    if t.device.type == "meta":
        return ("meta", id(t))
    return (str(t.device), t.untyped_storage().data_ptr())


def _boundary_bytes(args, out):
    """``(argument, output, aliased)`` bytes: each tensor once, and the
    outputs whose storage is an argument's."""
    seen_in, arg_b = set(), 0.0
    for t in _tensors(args):
        key = (_storage_key(t), t.data_ptr() if t.device.type != "meta"
               else 0, t.numel(), t.dtype)
        if key not in seen_in:
            seen_in.add(key)
            arg_b += t.numel() * t.element_size()
    in_storages = {k[0] for k in seen_in}
    seen_out, out_b, alias_b = set(), 0.0, 0.0
    for t in _tensors(out):
        key = (_storage_key(t), t.data_ptr() if t.device.type != "meta"
               else 0, t.numel(), t.dtype)
        if key in seen_out:
            continue
        seen_out.add(key)
        nbytes = t.numel() * t.element_size()
        out_b += nbytes
        if key[0] in in_storages:
            alias_b += nbytes
    return arg_b, out_b, alias_b


def _cards_of(args) -> List[torch.device]:
    """The distinct CUDA devices the arguments lie on (a mesh's cards)."""
    return list(dict.fromkeys(t.device for t in _tensors(args)
                              if t.device.type == "cuda"))


def _new_out_bytes(args, out, dev: torch.device) -> float:
    """The bytes of the outputs on ``dev`` that are no argument's."""
    _, out_b, alias_b = _boundary_bytes(
        [t for t in _tensors(args) if t.device == dev],
        [t for t in _tensors(out) if t.device == dev])
    return out_b - alias_b


def _measure(fn: Callable, args, label: str, fingerprint: str):
    """Run ``fn(*args)`` once under the counters: ``(output, costs)``,
    ``costs`` the payload of a ``compile`` journal event."""
    from torch.utils.flop_counter import FlopCounterMode

    from .._kernels import kernel_flop_meter

    cards = _cards_of(args)
    resident = {}
    for dev in cards:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        resident[dev] = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as counter, \
            kernel_flop_meter() as meter:
        out = fn(*args)
    for dev in cards:
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    arg_b, out_b, alias_b = _boundary_bytes(args, out)
    if cards:
        # the largest card's footprint, and what it held beyond its
        # resident memory and its new outputs
        peaks = {dev: float(torch.cuda.max_memory_allocated(dev))
                 for dev in cards}
        peak = max(peaks.values())
        temp = max(max(peaks[dev] - resident[dev]
                       - _new_out_bytes(args, out, dev), 0.0)
                   for dev in cards)
    else:
        peak, temp = arg_b + out_b - alias_b, 0.0
    costs = {
        "label": label,
        "fingerprint": fingerprint,
        "compile_seconds": seconds,
        "flops": float(counter.get_total_flops()) + meter[0],
        "kernel_flops": meter[0],
        "bytes_accessed": None,
        "arg_bytes": arg_b,
        "out_bytes": out_b,
        "temp_bytes": temp,
        "alias_bytes": alias_b,
        "hbm_bytes": arg_b + out_b - alias_b,
        "peak_bytes": peak,
        "arg_shardings": sorted({str(t.device) for t in _tensors(args)}),
    }
    return out, costs


def analyze_program(fn: Callable, *args, label: str = "program") -> Dict:
    """Run ``fn(*args)`` once and return its costs (the payload of a
    ``compile`` journal event):

    ``flops`` / ``kernel_flops``
        the counter's matrix products and convolutions plus the hand model
        of the port's kernels the call launched; the second is the hand
        models' part.
    ``hbm_bytes``
        program-boundary traffic: argument + output − aliased bytes.
    ``arg_bytes`` / ``out_bytes`` / ``temp_bytes`` / ``alias_bytes`` /
    ``peak_bytes``
        the bytes in, out and aliased; on the card the allocator's peak
        over the call and what it held beyond the resident memory and the
        new outputs (over a worker mesh, the largest card's: the JAX
        package's per-device memory analysis of the SPMD program);
        elsewhere ``peak = arg + out − alias``, ``temp = 0``.
    ``compile_seconds`` / ``arg_shardings``
        the synchronized wall time of the call, and the devices of the
        arguments.

    ``args`` on the ``meta`` device price the program from shapes alone.
    On the card the call resets the allocator's peak counter of every card
    the arguments lie on (``torch.cuda.reset_peak_memory_stats``): a peak
    reached before it is no longer in ``max_memory_allocated``.
    """
    _, costs = _measure(fn, args, label, program_fingerprint(label, args))
    return costs


class CostLedger:
    """Journal one ``compile`` event per distinct program of the run.

    The train loop routes the first call of each call site through
    :meth:`call` (label, function, arguments): the first time a (program,
    label, input signature) appears, that call, which the loop makes
    anyway, is measured (:func:`analyze_program`'s fields) and the event
    flows through ``log_event`` (the Recorder's journal sink); every later
    call of the same program is a dict lookup and a plain call.  The dedup
    key holds ``id(fn)``: a rebuilt program of the same signature (a
    recovery's) journals again; a held reference keeps a freed id from
    aliasing a later program."""

    def __init__(self, log_event: Callable[..., dict]):
        self._log = log_event
        self._seen: Dict[tuple, dict] = {}
        self._last_fp: Dict[str, str] = {}
        self._refs: List = []

    def call(self, label: str, fn, *args):
        """``fn(*args)``; when this (program, label, input signature) is
        new, the call is measured and its ``compile`` event journaled (the
        JAX ledger's ``observe``, on the call the loop makes anyway)."""
        fp = program_fingerprint(label, args)
        self._last_fp[label] = fp
        key = (id(fn), label, fp)
        if key in self._seen:
            return fn(*args)
        out, costs = _measure(fn, args, label, fp)
        self._seen[key] = self._log("compile", **costs)
        self._refs.append(fn)
        return out

    def last_fingerprint(self, label: str) -> Optional[str]:
        """The most recently seen program id of a call site."""
        return self._last_fp.get(label)

    def traces(self, label: str, fn) -> int:
        """How many input signatures ``fn`` has been journaled with under
        ``label``: the counterpart of a jitted function's cache size."""
        return sum(1 for (fid, lab, _) in self._seen
                   if fid == id(fn) and lab == label)

    @property
    def programs(self) -> List[dict]:
        return list(self._seen.values())


# ---------------------------------------------------------------------------
# The roofline
# ---------------------------------------------------------------------------

def flat_param_dim(model_name: str, dataset: str = "synthetic",
                   num_classes: int = 10) -> int:
    """Flat parameter dimension D of one worker of a registry model, built
    on the ``meta`` device (shapes only)."""
    from ..models import select_model
    from ..models.registry import dataset_input_shape

    try:
        dataset_input_shape(dataset)
    except KeyError as e:
        raise ValueError(f"unknown dataset {dataset!r} for --model dim "
                         f"derivation; pass --dim explicitly") from e
    with torch.device("meta"):
        model = select_model(model_name, dataset, num_classes=num_classes,
                             num_workers=1)
    return sum(int(p.numel()) for p in model.parameters())


def _wire(wire_dtype: str):
    from ..parallel.gossip import resolve_wire_dtype

    return resolve_wire_dtype(None if wire_dtype == "f32" else wire_dtype)


def gossip_step_costs(n: int, dim: int, decomposed: Sequence[Sequence[tuple]],
                      wire_dtype: str = "bf16", device="meta") -> Dict:
    """Costs of ONE dense per-step gossip program at ``[n, dim]``
    (``dense_gossip_fn``: ``(x, w) -> W_t @ x``), priced on ``device``
    (``meta``: shapes only)."""
    from ..parallel.gossip import dense_gossip_fn
    from ..topology import matching_laplacians

    dev = torch.device(device)
    laps = matching_laplacians(decomposed, n)
    wire = _wire(wire_dtype)
    compute_dtype = torch.float32 if wire is None else wire
    fn = dense_gossip_fn(laps, compute_dtype=compute_dtype, device=dev)
    x = torch.zeros((n, dim), dtype=compute_dtype, device=dev)
    w = torch.zeros((len(laps),), dtype=torch.float32, device=dev)
    return analyze_program(fn, x, w, label=f"gossip_step_dense_{wire_dtype}")


def gossip_chain_costs(n: int, dim: int, decomposed,
                       backend: str = "fused", wire_dtype: str = "bf16",
                       t_steps: int = 200, block_d: int = 2048,
                       dbuf: bool = True, device="meta") -> Dict:
    """Per-step costs of a T-step chain program: the fused W-stack kernel
    (``fused_gossip_run(x, stack)``) or the permutation-form flag-stream
    kernel (``perm_gossip_run(x, w, perms, partnered)``), amortized over
    ``t_steps``.  On ``meta`` the wrappers' plain versions price it.

    ``hbm_bytes`` is the program boundary, so the fused chain's bytes
    carry the ``[T, N, N]`` stack and the perm chain's the ``[T, M]``
    weights and the two ``[M, N]`` tables.  ``stream_hbm_bytes_per_step``
    subtracts the one-time state read and write (``2·N·D·state_bytes``)
    first: the streamed operand, the quantity the backend choice compares.
    ``model_*`` fields are the JAX package's hand models verbatim (fused:
    ``2·N²·D`` FLOPs a step, a stream of ``N²·w``; perm: ``(4·M+2)·N·D``
    FLOPs, a stream of ``M·4 + 2·M·N·4/T``)."""
    from .._kernels import fused_gossip_flops, perm_gossip_flops
    from ..parallel import (
        fused_gossip_plain,
        fused_gossip_run,
        involution_tables,
        perm_gossip_plain,
        perm_gossip_run,
    )
    from ..topology import matchings_to_perms

    dev = torch.device(device)
    abstract = dev.type == "meta"
    wire = _wire(wire_dtype)
    state_dtype = torch.float32 if wire is None else wire
    wire_bytes = torch.tensor([], dtype=state_dtype).element_size()
    m = len(decomposed)
    x = torch.zeros((n, dim), dtype=state_dtype, device=dev)
    if backend == "fused":
        run = fused_gossip_plain if abstract else fused_gossip_run
        stack = torch.zeros((t_steps, n, n), dtype=state_dtype, device=dev)
        costs = analyze_program(
            lambda xx, ss: run(xx, ss, block_d=block_d), x, stack,
            label=f"gossip_chain_fused_{wire_dtype}")
        model_stream = float(n * n * wire_bytes)
        model_flops = fused_gossip_flops(n, dim)
    elif backend == "perm":
        perms = matchings_to_perms([list(g) for g in decomposed], n)
        pi, pr = involution_tables(perms)
        w = torch.zeros((t_steps, m), dtype=torch.float32, device=dev)
        pi = torch.as_tensor(pi, device=dev)
        pr = torch.as_tensor(pr, device=dev)
        wd = wire_dtype if wire is not None else None
        if abstract:
            def fn(xx, ww, pi, pr):
                return perm_gossip_plain(xx, ww, pi, pr, block_d=block_d,
                                         wire_dtype=wd)
        else:
            def fn(xx, ww, pi, pr):
                return perm_gossip_run(xx, ww, pi, pr, block_d=block_d,
                                       wire_dtype=wd, dbuf=dbuf)
        costs = analyze_program(fn, x, w, pi, pr,
                                label=f"gossip_chain_perm_{wire_dtype}")
        model_stream = float(m * 4 + 2.0 * m * n * 4 / t_steps)
        model_flops = perm_gossip_flops(m, n, dim)
    else:
        raise ValueError(f"unknown chain backend {backend!r} (fused|perm)")
    state_bytes = 2.0 * n * dim * x.element_size()
    accessed = costs["bytes_accessed"]
    per_step = {
        "backend": backend, "t_steps": int(t_steps),
        "block_d": int(block_d), "matchings": m,
        "flops_per_step": costs["flops"] / t_steps,
        "hbm_bytes_per_step": costs["hbm_bytes"] / t_steps,
        "stream_hbm_bytes_per_step":
            max(costs["hbm_bytes"] - state_bytes, 0.0) / t_steps,
        "bytes_accessed_per_step": (None if accessed is None
                                    else accessed / t_steps),
        "model_hbm_bytes": model_stream + state_bytes / t_steps,
        "model_stream_hbm_bytes": model_stream,
        "model_flops": model_flops,
    }
    return {**costs, **per_step}


def elision_epoch_costs(n: int, dim: int, decomposed,
                        backend: str = "dense", wire_dtype: str = "bf16",
                        t_steps: int = 200, local_every: int = 1,
                        block_d: int = 2048, device="meta") -> Dict:
    """Per-epoch gossip boundary bytes under local-step elision: the mix
    executes on ``ceil(T/L)`` of ``T`` steps.  ``dense``/``skip``: the
    per-step program's ``hbm_bytes`` times the executed steps; ``fused``/
    ``perm``: one chain over the executed steps, its streamed operand
    (the state term stripped).  Adds ``exec_steps``,
    ``gossip_hbm_bytes_per_epoch`` and ``gossip_hbm_bytes_per_step`` (per
    scheduled step)."""
    local_every = max(int(local_every), 1)
    t_steps = int(t_steps)
    if t_steps < 1:
        raise ValueError(f"t_steps must be >= 1, got {t_steps}")
    exec_steps = -(-t_steps // local_every)  # ceil: t=0 always mixes
    if backend in ("dense", "skip"):
        costs = gossip_step_costs(n, dim, decomposed, wire_dtype=wire_dtype,
                                  device=device)
        per_epoch = costs["hbm_bytes"] * exec_steps
    elif backend in ("fused", "perm"):
        costs = gossip_chain_costs(
            n, dim, decomposed, backend=backend, wire_dtype=wire_dtype,
            t_steps=exec_steps, block_d=block_d, device=device)
        per_epoch = costs["stream_hbm_bytes_per_step"] * exec_steps
    else:
        raise ValueError(
            f"unknown elision backend {backend!r} (dense|skip|fused|perm)")
    return {
        **costs,
        "backend": backend,
        "t_steps": t_steps,
        "local_every": local_every,
        "exec_steps": exec_steps,
        "gossip_hbm_bytes_per_epoch": float(per_epoch),
        "gossip_hbm_bytes_per_step": float(per_epoch) / t_steps,
    }


@dataclasses.dataclass(frozen=True)
class Roofline:
    """Per-chip ceilings from per-step costs: the best steps/s any
    implementation of the program could reach, and which wall is closer."""

    chip: str
    spec: ChipSpec

    def ceilings(self, flops_per_step: float, hbm_bytes_per_step: float,
                 compute_dtype: str = "bf16") -> Dict:
        peak = self.spec.peak_for(compute_dtype)
        compute = (peak * 1e12) / max(flops_per_step, 1.0)
        hbm = (self.spec.peak_gbps * 1e9) / max(hbm_bytes_per_step, 1.0)
        return {
            "chip": self.chip,
            "peak_tflops": peak,
            "peak_dtype": compute_dtype,
            "peak_gbps": self.spec.peak_gbps,
            "provisional": self.spec.provisional,
            "compute_bound_steps_per_sec": compute,
            "hbm_bound_steps_per_sec": hbm,
            "ceiling_steps_per_sec": min(compute, hbm),
            "bound": "compute" if compute <= hbm else "hbm",
        }


def _compute_dtype(backend: str, wire_dtype: str) -> str:
    """What the program's operations run in: the perm kernel accumulates
    in f32 on the CUDA cores whatever the wire; dense and fused run in the
    wire's dtype (a bf16 stack on the tensor cores)."""
    if backend == "perm":
        return "f32"
    return "bf16" if wire_dtype == "bf16" else "f32"


def roofline_report(n: int, dim: int, decomposed, wire_dtype: str = "bf16",
                    chip: Optional[str] = None,
                    measured_steps_per_sec: Optional[float] = None,
                    backend: str = "dense", t_steps: int = 200,
                    device="meta") -> Dict:
    """Per-step costs of ``backend``'s program and the chip's peaks →
    ceilings, hand-model ratios and, with a measured rate, the
    measured-vs-ceiling ratio that ``auto``'s gate reads
    (``plan.load_measured_vs_ceiling``), with the backend whose ceiling it
    divides by.  ``t_steps``: the chains' length (fused, perm)."""
    if backend in ("fused", "perm"):
        costs = gossip_chain_costs(n, dim, decomposed, backend=backend,
                                   wire_dtype=wire_dtype, t_steps=t_steps,
                                   device=device)
        # the counter sees no elementwise work (the perm chain's): the
        # hand model is the floor of the work the formulation must issue,
        # and the ceiling takes the larger.  A launched kernel's count is
        # the hand model itself, so it is no check on the model.
        flops = max(costs["flops_per_step"], costs["model_flops"])
        metered = costs["kernel_flops"] > 0
        hbm = costs["hbm_bytes_per_step"]
        model_flops = costs["model_flops"]
        model_hbm = costs["model_hbm_bytes"]
        extra = {"bytes_accessed_per_step": costs["bytes_accessed_per_step"],
                 "stream_hbm_bytes_per_step":
                     costs["stream_hbm_bytes_per_step"],
                 "model_stream_hbm_bytes": costs["model_stream_hbm_bytes"],
                 "extracted_flops_per_step": costs["flops_per_step"],
                 "kernel_flops_per_step": costs["kernel_flops"] / t_steps,
                 "t_steps": costs["t_steps"], "block_d": costs["block_d"],
                 "matchings": costs["matchings"]}
    elif backend == "dense":
        costs = gossip_step_costs(n, dim, decomposed, wire_dtype=wire_dtype,
                                  device=device)
        flops = costs["flops"]
        hbm = costs["hbm_bytes"]
        bytes_el = 2 if wire_dtype == "bf16" else 4
        model_flops = 2.0 * n * n * dim
        model_hbm = 2.0 * n * dim * bytes_el
        metered = False
        extra = {"bytes_accessed_per_step": costs["bytes_accessed"]}
    else:
        raise ValueError(f"unknown roofline backend {backend!r} "
                         f"(dense|fused|perm)")
    name, spec = resolve_chip(chip)
    report = {
        "n": int(n), "dim": int(dim), "wire_dtype": wire_dtype,
        "backend": backend,
        "flops_per_step": flops,
        "hbm_bytes_per_step": hbm,
        "peak_bytes": costs["peak_bytes"],
        "compile_seconds": costs["compile_seconds"],
        "fingerprint": costs["fingerprint"],
        **extra,
    }
    report.update(
        model_flops=model_flops, model_hbm_bytes=model_hbm,
        flops_vs_model=(None if metered else
                        extra.get("extracted_flops_per_step", flops)
                        / model_flops),
        hbm_vs_model=hbm / model_hbm,
    )
    report.update(Roofline(name, spec).ceilings(
        flops, hbm, _compute_dtype(backend, wire_dtype)))
    if measured_steps_per_sec is not None:
        report["measured_steps_per_sec"] = float(measured_steps_per_sec)
        report["measured_vs_ceiling"] = (
            float(measured_steps_per_sec) / report["ceiling_steps_per_sec"])
        report["measured_vs_ceiling_backend"] = backend
        report["measured_vs_compute_bound"] = (
            float(measured_steps_per_sec)
            / report["compute_bound_steps_per_sec"])
    return report


def roofline_compare(n: int, dim: int, decomposed, wire_dtype: str = "bf16",
                     chip: Optional[str] = None,
                     measured_steps_per_sec: Optional[float] = None,
                     measured_backend: str = "perm", t_steps: int = 200,
                     device="meta") -> Dict:
    """Perm-vs-fused ceilings side by side.  The headline is
    ``hbm_ratio_fused_over_perm``: how many times more streamed bytes a
    step of the W-stack chain moves than one of the flag-stream chain.  A
    measured rate attaches only to ``measured_backend``'s report."""
    reports = {
        b: roofline_report(
            n, dim, decomposed, wire_dtype=wire_dtype, chip=chip,
            measured_steps_per_sec=(measured_steps_per_sec
                                    if b == measured_backend else None),
            backend=b, t_steps=t_steps, device=device)
        for b in ("fused", "perm")
    }
    perm_stream = reports["perm"]["stream_hbm_bytes_per_step"]
    return {
        "n": int(n), "dim": int(dim), "wire_dtype": wire_dtype,
        "chip": reports["perm"]["chip"],
        "fused": reports["fused"], "perm": reports["perm"],
        "hbm_ratio_fused_over_perm":
            reports["fused"]["stream_hbm_bytes_per_step"]
            / max(perm_stream, 1.0),
        "ceiling_ratio_perm_over_fused":
            reports["perm"]["ceiling_steps_per_sec"]
            / max(reports["fused"]["ceiling_steps_per_sec"], 1e-30),
    }


def _state_update_program(n: int, dim: int, communicator: str, device):
    """A flat-state momentum-SGD update over every persistent ``[N, D]``
    buffer: parameters and momentum, plus CHOCO's {x̂, s} carry.  Its
    argument bytes are what the buffers occupy."""
    if communicator == "choco":
        def update(x, m, xhat, s):
            m2 = 0.9 * m + x
            x2 = x - 0.1 * m2
            return x2, m2, xhat + 0.1 * s, s - xhat
    else:
        def update(x, m):
            m2 = 0.9 * m + x
            x2 = x - 0.1 * m2
            return x2, m2
    nargs = 4 if communicator == "choco" else 2
    args = tuple(torch.zeros((n, dim), dtype=torch.float32, device=device)
                 for _ in range(nargs))
    return update, args


def capacity_report(dim: int, workers: Sequence[int] = (256, 64),
                    communicators: Sequence[str] = ("decen", "choco"),
                    chip: Optional[str] = None, device="meta") -> Dict:
    """The HBM capacity table: each row prices the persistent-state update
    program at ``[N, dim]`` and reads its argument bytes (what the
    optimizer state must occupy), then divides by the chip's HBM."""
    name, spec = resolve_chip(chip)
    hbm = spec.hbm_gb * 1e9
    rows = []
    for comm in communicators:
        for n in workers:
            fn, args = _state_update_program(n, dim, comm,
                                             torch.device(device))
            costs = analyze_program(fn, *args,
                                    label=f"state_update_{comm}_n{n}")
            state_bytes = costs["arg_bytes"]
            rows.append({
                "communicator": comm, "n": int(n), "dim": int(dim),
                "state_bytes": state_bytes,
                "buffers": 4 if comm == "choco" else 2,
                "chips_needed": int(np.ceil(state_bytes / hbm)),
                "fits_one_chip": bool(state_bytes <= hbm),
            })
    return {"chip": name, "hbm_gb": spec.hbm_gb,
            "provisional": spec.provisional, "dim": int(dim), "rows": rows}


# ---------------------------------------------------------------------------
# Markdown (obs_torch.py roofline/capacity --md)
# ---------------------------------------------------------------------------

def _gb(x: float) -> str:
    for scale, unit in ((1e12, "TB"), (1e9, "GB"), (1e6, "MB"), (1e3, "kB")):
        if x >= scale:
            return f"{x / scale:.2f} {unit}"
    return f"{x:.0f} B"


_MODEL_LABELS = {
    "dense": ("2·N²·D", "2·N·D·w"),
    "fused": ("2·N²·D", "N²·w + 2·N·D·w/T"),
    "perm": ("(4·M+2)·N·D", "M·4 + 2·M·N·4/T + 2·N·D·w/T"),
}
_BACKEND_TITLES = {
    "dense": "dense per-step gossip",
    "fused": "fused W-stack chain (per step)",
    "perm": "permutation-form flag-stream chain (per step)",
}


def _ratio(value: Optional[float]) -> str:
    """A counted-vs-model ratio; ``None`` (the count is the hand model of
    a launched kernel, no cross-check) prints as a dash."""
    return "—" if value is None else f"{value:.4f}"


def render_roofline_markdown(report: Dict, source: str = "") -> str:
    prov = (" (**CPU-provisional peaks** — relative arithmetic only)"
            if report.get("provisional") else "")
    backend = report.get("backend", "dense")
    flops_label, hbm_label = _MODEL_LABELS.get(backend,
                                               _MODEL_LABELS["dense"])
    raw_flops = report.get("extracted_flops_per_step",
                           report["flops_per_step"])
    clamped = raw_flops < report["flops_per_step"]
    peak_name = "FP32" if report.get("peak_dtype") == "f32" else "bf16"
    lines = [
        f"# Automatic roofline — "
        f"{_BACKEND_TITLES.get(backend, backend)} @ N={report['n']}, "
        f"D={report['dim']}, {report['wire_dtype']} wire", "",
        f"Counted on one call of the program (`FlopCounterMode` plus the "
        f"kernels' hand models; boundary bytes of its tensors; program "
        f"`{report['fingerprint']}`); chip peaks pinned for "
        f"**{report['chip']}**{prov}.", "",
        "| quantity | counted | hand model | ratio |",
        "|---|---:|---:|---:|",
        f"| FLOPs/step | {raw_flops:.4g} "
        f"| {report['model_flops']:.4g} ({flops_label}) "
        f"| {_ratio(report['flops_vs_model'])} |",
        f"| HBM bytes/step (boundary) | {report['hbm_bytes_per_step']:.4g} "
        f"| {report['model_hbm_bytes']:.4g} ({hbm_label}) "
        f"| {report['hbm_vs_model']:.4f} |",
        "",
        "| ceiling | steps/s |",
        "|---|---:|",
        f"| compute-bound ({report['peak_tflops']} TFLOP/s, {peak_name}) "
        f"| {report['compute_bound_steps_per_sec']:.1f} |",
        f"| HBM-bound ({report['peak_gbps']} GB/s) "
        f"| {report['hbm_bound_steps_per_sec']:.1f} |",
        f"| **binding: {report['bound']}** "
        f"| **{report['ceiling_steps_per_sec']:.1f}** |",
    ]
    if clamped:
        lines += ["", f"FLOPs note: the counter sees matrix products and "
                      f"metered kernel launches only, so the count above "
                      f"is below the hand model; the ceilings use the "
                      f"hand-model floor ({report['flops_per_step']:.4g} "
                      f"FLOPs/step)."]
    if "measured_steps_per_sec" in report:
        origin = report.get("measured_backend")
        via = (f" (rate measured on the **{origin}** backend)"
               if origin and origin != backend else "")
        lines += ["", f"Measured: **{report['measured_steps_per_sec']:.1f} "
                      f"steps/s**{via} = "
                      f"{report['measured_vs_ceiling']:.1%} of "
                      f"the **{report.get('measured_vs_ceiling_backend', backend)}** "
                      f"ceiling (the ratio's denominator — quote it against "
                      f"no other backend's)."]
    if source:
        lines += ["", f"Source: `{source}`"]
    lines.append("")
    return "\n".join(lines)


def render_roofline_compare_markdown(report: Dict, source: str = "") -> str:
    """The perm-vs-fused comparison (``roofline --backend both``)."""
    f, p = report["fused"], report["perm"]
    lines = [
        f"# Perm vs fused roofline @ N={report['n']}, D={report['dim']}, "
        f"{report['wire_dtype']} wire ({report['chip']})", "",
        f"Streamed-operand comparison: the fused chain moves the "
        f"`[T, N, N]` W stack, the perm chain only the `[T, M]` flag "
        f"array — "
        f"**{report['hbm_ratio_fused_over_perm']:.0f}× less streamed HBM "
        f"traffic per step** at this shape (state read+write, identical "
        f"in both, stripped).", "",
        "| per step | fused (W stack) | perm (flag stream) |",
        "|---|---:|---:|",
        f"| streamed HBM bytes | {f['stream_hbm_bytes_per_step']:.4g} "
        f"| {p['stream_hbm_bytes_per_step']:.4g} |",
        f"| HBM bytes (boundary, incl. state) "
        f"| {f['hbm_bytes_per_step']:.4g} "
        f"| {p['hbm_bytes_per_step']:.4g} |",
        f"| FLOPs | {f['flops_per_step']:.4g} | {p['flops_per_step']:.4g} |",
        f"| compute-bound steps/s | {f['compute_bound_steps_per_sec']:.1f} "
        f"| {p['compute_bound_steps_per_sec']:.1f} |",
        f"| HBM-bound steps/s | {f['hbm_bound_steps_per_sec']:.1f} "
        f"| {p['hbm_bound_steps_per_sec']:.1f} |",
        f"| **ceiling (binding: {f['bound']} / {p['bound']})** "
        f"| **{f['ceiling_steps_per_sec']:.1f}** "
        f"| **{p['ceiling_steps_per_sec']:.1f}** |",
        "",
        f"Ceiling ratio perm/fused: "
        f"**{report['ceiling_ratio_perm_over_fused']:.2f}×**.  (The perm "
        f"chain is priced at the FP32 peak, the fused chain at its stack "
        f"dtype's; fewer bytes win only where the fused form has no "
        f"headroom left — the `plan.cost.choose_gossip_backend` gate.)",
    ]
    for rep in (f, p):
        if "measured_steps_per_sec" in rep:
            lines += ["", f"Measured {rep['backend']}: "
                          f"**{rep['measured_steps_per_sec']:.1f} steps/s**"
                          f" = {rep['measured_vs_ceiling']:.1%} of the "
                          f"{rep['measured_vs_ceiling_backend']} ceiling."]
            break
    if source:
        lines += ["", f"Source: `{source}`"]
    lines.append("")
    return "\n".join(lines)


def render_capacity_markdown(report: Dict) -> str:
    prov = (" (**CPU-provisional HBM figure**)" if report.get("provisional")
            else "")
    lines = [
        f"# HBM capacity — D={report['dim']}, per-chip HBM "
        f"{report['hbm_gb']:.0f} GB ({report['chip']}){prov}", "",
        "Derived from the argument bytes of the persistent-state update "
        "program — what the optimizer state occupies.", "",
        "| communicator | N | persistent buffers | state bytes | "
        "chips needed (N/C fold) |",
        "|---|---:|---:|---:|---:|",
    ]
    for r in report["rows"]:
        lines.append(
            f"| {r['communicator']} | {r['n']} | {r['buffers']}×[N,D] f32 "
            f"| {_gb(r['state_bytes'])} | {r['chips_needed']} |")
    lines.append("")
    return "\n".join(lines)
