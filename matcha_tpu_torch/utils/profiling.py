"""Profiler integration.

Port of ``matcha_tpu/utils/profiling.py`` on ``torch.profiler``:

* :func:`trace` opens a profiler window and writes one Chrome trace
  (``*.pt.trace.json.gz``) into ``log_dir``; ``obs.xprof`` attributes its
  kernel rows to the step's phases.
* :func:`annotate` names a host phase (checkpointing, the comm-split
  timer, a Recorder flush).
* :func:`device_span` names a phase of the step (``matcha/fwd_bwd``,
  ``matcha/sgd``, ``matcha/heal``, ``comm/step``).  An eager kernel carries
  no scope of its own, so the parser gives each kernel the innermost such
  range around its launch on the host.  The JAX span is a trace-time
  construct that costs nothing at run time; this one costs nothing outside
  a profiler window: it enters a range only while a profiler is on, and is
  a ``nullcontext`` otherwise.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from pathlib import Path

import torch

__all__ = ["trace", "annotate", "device_span"]


@contextlib.contextmanager
def trace(log_dir: str, device=None):
    """A ``torch.profiler`` window writing one Chrome trace into
    ``log_dir``.

    Records CPU and CUDA activity when the card is in use (``device`` a
    CUDA device, a sequence of devices holding one, the cards of a worker
    mesh, or ``None`` with CUDA available), the CPU alone otherwise.  The
    CUDA activity is every card's: CUPTI traces each device the process
    launches on, and each kernel row carries its device.  Every card is
    synchronized before the window closes, so work queued inside the
    window lands in the capture (the JAX contract of ending the block with
    a readback).  Yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    Path(log_dir).mkdir(parents=True, exist_ok=True)
    if device is None:
        devices = [torch.device("cuda" if torch.cuda.is_available()
                                else "cpu")]
    elif isinstance(device, (list, tuple)):
        devices = [torch.device(d) for d in device]
    else:
        devices = [torch.device(device)]
    cards = list(dict.fromkeys(d for d in devices if d.type == "cuda"))
    activities = [ProfilerActivity.CPU]
    if cards:
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield log_dir
    finally:
        for card in cards:
            torch.cuda.synchronize(card)
        prof.stop()
        name = (f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}"
                f".pt.trace.json.gz")
        prof.export_chrome_trace(str(Path(log_dir) / name))


def annotate(name: str):
    """A named range on the profiler's host timeline
    (``torch.profiler.record_function``), for host phases: data staging,
    checkpointing, the comm-split timer, a Recorder flush."""
    return torch.profiler.record_function(name)


def device_span(name: str):
    """A named range around a phase of the step.  Inside a profiler window
    it is ``record_function(name)``: every kernel launched under it is the
    phase's (``obs.xprof``).  Outside a window it is a ``nullcontext`` and
    records nothing."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()
