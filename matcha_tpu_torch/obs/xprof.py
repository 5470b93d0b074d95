"""Overlap truth: parse an executed profiler trace, attribute device time.

Port of ``matcha_tpu/obs/xprof.py`` on the Kineto trace that
``utils.profiling.trace`` (``torch.profiler``) writes.  The report fields
are JAX's; two rules are re-based on the trace's format:

1. **Device rows.**  A Kineto trace names no ``/device:`` process.  A
   device row is a complete (``ph == "X"``) row whose ``cat`` is
   ``kernel``, ``gpu_memcpy`` or ``gpu_memset``; the device processes are
   the ``pid`` values those rows carry.
2. **Phase.**  An eager kernel carries no scope metadata.  A kernel takes
   the phase of the innermost ``comm/*`` (the exchange) or ``matcha/*``
   (the training phases) ``user_annotation`` range that encloses its
   launch on the host: the ``cuda_runtime`` (or ``cuda_driver``) row with
   the kernel's ``correlation`` id.  The range is looked for on the
   launching thread first, then on the other threads of its process
   (autograd launches the backward pass from a thread of its own while
   the step's thread waits inside its range).  The port's kernels are
   launched through ``ctypes``, outside PyTorch's dispatcher, so nothing
   rests on the ``External id`` field or the ``gpu_user_annotation`` rows:
   only the launch's time and thread (CUPTI records their runtime calls
   like any other).  A kernel in no such range, or whose launch row is
   missing, is ``other`` (compute, as in JAX).

Then each phase's intervals are merged and intersected on each device
(a Kineto kernel row names its device in ``args["device"]``), and the
seconds are summed over the devices: on a worker mesh every card's
exchange and compute count, and the overlap fraction is the share of the
exchange's device time that ran while compute also ran on the same card.
Where the rows carry a device the report adds ``per_device``, the same
seconds and row counts card by card (rows that name no device under
``"None"``).  Virtual cards of one device (a
mesh of ``["cuda:0"] * C``) put every row on that one device, so the
split then has one entry.  A CPU capture has no device rows: the parser
raises :class:`TraceParseError` instead of reporting a fake 0 %.
"""

from __future__ import annotations

import bisect
import gzip
import json
import os
from typing import Dict, List, Sequence, Tuple

__all__ = ["TraceParseError", "find_trace_file", "kernel_phases",
           "load_trace_events", "overlap_report", "profile_report",
           "render_profile_markdown"]

#: the ``cat`` of a Kineto row that ran on the device
DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
#: the ``cat`` of a host row that launched device work
LAUNCH_CATS = frozenset({"cuda_runtime", "cuda_driver"})


class TraceParseError(ValueError):
    """A trace that cannot answer the overlap question (missing file,
    malformed JSON, or, the CPU case, no device rows)."""


def find_trace_file(source: str) -> str:
    """Resolve a trace source to one ``*.trace.json.gz`` (or ``.json``).

    ``source`` may be the file itself, a profiler log directory (what
    ``utils.profiling.trace`` was given; searched recursively) or any
    directory above one.  Several captures resolve to the newest."""
    if os.path.isfile(source):
        return source
    if not os.path.isdir(source):
        raise TraceParseError(f"no trace at {source}")
    candidates = []
    for root, _, files in os.walk(source):
        for f in files:
            if f.endswith(".trace.json.gz") or f.endswith(".trace.json"):
                candidates.append(os.path.join(root, f))
    if not candidates:
        raise TraceParseError(
            f"{source} holds no *.trace.json.gz — was the window captured "
            f"with utils.profiling.trace(log_dir)?")
    return max(candidates, key=os.path.getmtime)


def load_trace_events(path: str) -> List[dict]:
    """Parse a Chrome trace-event file (gzipped or plain JSON)."""
    opener = gzip.open if path.endswith(".gz") else open
    try:
        with opener(path, "rt") as f:
            data = json.load(f)
    except (OSError, json.JSONDecodeError, UnicodeDecodeError) as e:
        raise TraceParseError(f"{path}: not a readable trace JSON ({e})") \
            from e
    events = data.get("traceEvents") if isinstance(data, dict) else data
    if not isinstance(events, list):
        raise TraceParseError(f"{path}: no traceEvents array")
    return events


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    if not intervals:
        return []
    intervals = sorted(intervals)
    out = [list(intervals[0])]
    for lo, hi in intervals[1:]:
        if lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


def _intersect_len(a: List[Tuple[float, float]],
                   b: List[Tuple[float, float]]) -> float:
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _span_len(a: List[Tuple[float, float]]) -> float:
    return sum(hi - lo for lo, hi in a)


def _phase_name(name: str) -> str:
    """``comm``/``comp`` of a range name, or ``""`` for any other range."""
    if "comm/" in name:
        return "comm"
    if "matcha/" in name:
        return "comp"
    return ""


class _Ranges:
    """The phase ranges of one host thread, sorted by start, for "the
    innermost range enclosing t" queries."""

    def __init__(self):
        self.rows: List[Tuple[float, float, str]] = []
        self.starts: List[float] = []

    def add(self, lo: float, hi: float, phase: str) -> None:
        self.rows.append((lo, hi, phase))

    def seal(self) -> None:
        self.rows.sort()
        self.starts = [r[0] for r in self.rows]

    def innermost(self, t: float) -> Tuple[float, str]:
        """``(start, phase)`` of the latest-starting range with
        ``lo <= t <= hi``; ``(-inf, "")`` when none encloses ``t``."""
        k = bisect.bisect_right(self.starts, t)
        for lo, hi, phase in reversed(self.rows[:k]):
            if hi >= t:
                return lo, phase
        return float("-inf"), ""


def _host_ranges(events: Sequence[dict]) -> Dict[tuple, _Ranges]:
    lanes: Dict[tuple, _Ranges] = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") != "user_annotation":
            continue
        phase = _phase_name(str(e.get("name", "")))
        ts, dur = e.get("ts"), e.get("dur")
        if not phase or ts is None or dur is None:
            continue
        lanes.setdefault((e.get("pid"), e.get("tid")), _Ranges()).add(
            float(ts), float(ts) + float(dur), phase)
    for lane in lanes.values():
        lane.seal()
    return lanes


def _attribute(events: Sequence[dict], rows: List[dict]) -> List[str]:
    """The phase of each device row in ``rows`` (module docstring)."""
    host = _host_ranges(events)
    by_pid: Dict[object, List[_Ranges]] = {}
    for (pid, _), lane in host.items():
        by_pid.setdefault(pid, []).append(lane)
    launches: Dict[object, dict] = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches.setdefault(corr, e)
    phases = []
    for row in rows:
        corr = (row.get("args") or {}).get("correlation")
        launch = launches.get(corr) if corr is not None else None
        phase = ""
        if launch is not None:
            t = float(launch["ts"])
            lane = host.get((launch.get("pid"), launch.get("tid")))
            if lane is not None:
                phase = lane.innermost(t)[1]
            if not phase:
                # the innermost range of any thread of the process
                found = [other.innermost(t)
                         for other in by_pid.get(launch.get("pid"), ())]
                phase = max(found, default=(0.0, ""))[1]
        phases.append(phase or "other")
    return phases


def kernel_phases(events: Sequence[dict]) -> List[Tuple[dict, str]]:
    """Each complete device row of the trace with its phase (``comm``,
    ``comp`` or ``other``), in the trace's order."""
    rows = [e for e in events if e.get("cat") in DEVICE_CATS
            and e.get("ph") == "X" and e.get("ts") is not None
            and e.get("dur")]
    return list(zip(rows, _attribute(events, rows)))


def overlap_report(events: Sequence[dict], source: str = "trace") -> Dict:
    """Device-time phase attribution and the comm/comp overlap fraction.

    Raises :class:`TraceParseError` when the trace has no device rows:
    the CPU-capture case fails loudly, not with a fake 0 %."""
    proc_names: Dict[object, str] = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            proc_names[e.get("pid")] = (e.get("args") or {}).get("name", "")
    device_rows = [e for e in events if e.get("cat") in DEVICE_CATS]
    if not device_rows:
        hosts = sorted(str(n) for n in proc_names.values() if n)
        raise TraceParseError(
            f"{source}: trace contains no device rows (processes: "
            f"{hosts or 'none'}) — a CPU capture carries only host lanes, "
            f"so the comm/comp overlap cannot be measured from it; capture "
            f"on the card (train(trace_dir=...) with device='cuda')")
    device_pids = {e.get("pid") for e in device_rows}
    phased = kernel_phases(events)
    if not phased:
        raise TraceParseError(
            f"{source}: device processes exist but carry no complete "
            f"(ph=X) kernel rows — truncated capture?")
    by_device: Dict[object, Dict[str, List[Tuple[float, float]]]] = {}
    for e, phase in phased:
        ts, dur = float(e["ts"]), float(e["dur"])
        card = (e.get("args") or {}).get("device")
        spans = by_device.setdefault(card, {"comm": [], "comp": [],
                                            "other": []})
        spans[phase].append((ts * 1e-6, (ts + dur) * 1e-6))
    per_device = {card: _phase_seconds(spans)
                  for card, spans in by_device.items()}
    total = {key: sum(p[key] for p in per_device.values())
             for key in ("comm_seconds", "comp_seconds", "other_seconds",
                         "compute_seconds", "overlap_seconds")}
    rows = {phase: sum(p["rows"][phase] for p in per_device.values())
            for phase in ("comm", "comp", "other")}
    comm_s = total["comm_seconds"]
    report = {
        "source": source,
        "device_processes": sorted(
            str(proc_names.get(p) or f"device {p}") for p in device_pids),
        "rows": rows,
        **total,
        # of all communication device time, the share that ran while
        # compute was also executing; None with no comm row at all
        "overlap_fraction": (total["overlap_seconds"] / comm_s)
        if comm_s > 0 else None,
    }
    if any(card is not None for card in per_device):
        report["per_device"] = {str(card): per_device[card]
                                for card in sorted(per_device, key=str)}
    return report


def _phase_seconds(spans: Dict[str, List[Tuple[float, float]]]) -> Dict:
    """One device's rows and seconds by phase, and the exchange's seconds
    that overlapped compute."""
    comm = _merge(spans["comm"])
    compute = _merge(spans["comp"] + spans["other"])
    return {"rows": {phase: len(v) for phase, v in spans.items()},
            "comm_seconds": _span_len(comm),
            "comp_seconds": _span_len(_merge(spans["comp"])),
            "other_seconds": _span_len(_merge(spans["other"])),
            "compute_seconds": _span_len(compute),
            "overlap_seconds": _intersect_len(comm, compute)}


def profile_report(source: str) -> Dict:
    """Resolve a trace source, parse it, attribute phases."""
    path = find_trace_file(source)
    return overlap_report(load_trace_events(path), source=path)


def render_profile_markdown(reports: Sequence[Dict]) -> str:
    lines = [
        "# Overlap truth — executed-trace comm/comp attribution", "",
        "Device kernel rows attributed through the `device_span` ranges "
        "around their launches (`comm/*` = exchange, `matcha/*` = training "
        "phases); the overlap fraction is the share of communication "
        "device-time that ran concurrently with compute.", "",
        "| trace | comm s | compute s | overlap s | overlap fraction |",
        "|---|---:|---:|---:|---:|",
    ]
    for r in reports:
        frac = r.get("overlap_fraction")
        lines.append(
            f"| {os.path.basename(str(r['source']))} "
            f"| {r['comm_seconds']:.6g} | {r['compute_seconds']:.6g} "
            f"| {r['overlap_seconds']:.6g} "
            f"| {'-' if frac is None else f'{frac:.1%}'} |")
    lines.append("")
    return "\n".join(lines)
