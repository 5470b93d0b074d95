"""The run supervisor: own the train loop across process lifetimes.

Port of ``matcha_tpu/serve/controller.py``.  ``Controller.run`` is the
daemon's core loop: it launches the trainer (``python -m
matcha_tpu_torch.serve.trainer``, from the same tree) as a subprocess,
waits, and switches on the exit code:

* ``0`` — the run completed (epochs exhausted, or a ``stop`` control
  document drained it): supervision ends;
* ``RESTART_EXIT`` — a deliberate restart requested by a restart-scope
  control field: the supervisor merges the field into the config and
  relaunches from the checkpoint, **without** charging the budget;
* anything else — a crash: charged against ``restart_budget``, relaunch
  after exponential backoff, resuming from the latest checkpoint (the
  journal + CSVs extend; the resumed recorder state is byte-identical
  to an uninterrupted run's — pinned by test).

Supervisor-side decisions journal as v6 ``control`` events through
``serve.control.journal_control`` — appended only **between** trainer
lifetimes (the journal has one writer at a time; ``epoch=-1`` marks
"supervisor-side, epoch unknown").  The trainer's own decisions ride its
recorder inside the run.

The controller is deliberately dumb about training: everything it knows
arrives through files (spec out, journal/checkpoint/heartbeats back),
so a kill -9 of either process loses nothing but uncheckpointed epochs.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import subprocess
import sys
import time
from typing import Dict, Optional

from ..utils.atomicio import atomic_publish
from .control import (
    CONTROL_BASENAME,
    RESTART_EXIT,
    RESTART_FIELDS,
    journal_control,
    load_control,
)

__all__ = ["Controller", "ServeConfig"]


@dataclasses.dataclass
class ServeConfig:
    """Everything the daemon needs beyond the training config itself."""

    #: TrainConfig field dict (the trainer subprocess rebuilds it; paths
    #: and plain JSON values only — a daemon's config must survive a file)
    config: Dict
    control_path: Optional[str] = None  # default: {savePath}/control.json
    serving_dir: Optional[str] = None  # default: {savePath}/{name}_serving
    promote_every: int = 0  # epochs between promotion evals; 0 disables
    promote_margin: float = 0.0  # tolerated test_acc drop before rollback
    promote_keep: int = 3
    eval_batch: int = 256
    restart_budget: int = 3  # crash relaunches before giving up
    backoff: float = 1.0  # seconds, decorrelated-jittered per crash
    backoff_max: float = 30.0
    #: decorrelated-jitter RNG seed; None = nondeterministic (production),
    #: an int pins the sleep schedule (an exact replay)
    jitter_seed: Optional[int] = None
    #: K clean epoch boundaries of checkpointed progress refill one crash
    #: credit (capped at restart_budget); 0 disables — without it a
    #: week-long run with rare unrelated crashes deterministically aborts
    refill_epochs: int = 0
    #: crash-loop window (seconds): two consecutive crashes with the same
    #: exit signature, both inside this window, escalate to checkpoint
    #: quarantine + older-generation resume instead of burning the budget
    #: on a deterministically poisoned artifact; 0 defaults to backoff_max
    crash_window: float = 0.0
    #: extra environment for the trainer subprocess; None = inherit only
    env: Optional[Dict] = None
    #: the trainer's device, "cuda" or "cpu"; None = the card (a host
    #: without CUDA raises in the trainer, never trains on the CPU)
    device: Optional[str] = None

    def __post_init__(self):
        if not isinstance(self.config, dict):
            raise ValueError("ServeConfig.config must be a dict of "
                             "TrainConfig fields (it crosses a process "
                             "boundary as JSON)")
        if self.restart_budget < 0:
            raise ValueError("restart_budget must be >= 0")
        if self.refill_epochs < 0:
            raise ValueError("refill_epochs must be >= 0")
        if self.crash_window < 0:
            raise ValueError("crash_window must be >= 0")
        if self.promote_every < 0:
            raise ValueError("promote_every must be >= 0")
        if self.device not in (None, "cuda", "cpu"):
            raise ValueError(f"device must be 'cuda', 'cpu' or None, got "
                             f"{self.device!r}")


class Controller:
    def __init__(self, serve: ServeConfig):
        self.serve = serve
        self.config = dict(serve.config)
        # a daemon without a run folder has no journal, no heartbeats, no
        # checkpoints — nothing to supervise with
        self.config["save"] = True
        save_path = self.config.get("savePath", "runs")
        name = self.config.get("name", "experiment")
        model = self.config.get("model", "resnet20")
        self.run_dir = os.path.join(save_path, f"{name}_{model}")
        self.ckpt_dir = os.path.join(save_path, f"{name}_ckpt")
        self.journal_path = os.path.join(self.run_dir, "events.jsonl")
        self.control_path = serve.control_path or os.path.join(
            save_path, CONTROL_BASENAME)
        self.serving_dir = serve.serving_dir or os.path.join(
            save_path, f"{name}_serving")
        self.spec_path = os.path.join(save_path, f"{name}_serve_spec.json")
        self.restarts_used = 0
        self.lifetimes = 0
        self.last_exit: Optional[int] = None
        self._proc: Optional[subprocess.Popen] = None
        self._stopping = False
        self._rng = random.Random(serve.jitter_seed)
        #: checkpointed progress already converted into refill credits
        self._refill_base: Optional[int] = None
        #: previous crash's (exit code, latest checkpoint step, wall time)
        self._last_crash: Optional[tuple] = None

    # ------------------------------------------------------------- plumbing
    def _write_spec(self) -> None:
        config = dict(self.config)
        if os.path.isdir(self.ckpt_dir):
            from ..train import latest_step

            if latest_step(self.ckpt_dir) is not None:
                config["resume"] = self.ckpt_dir
        spec = {
            "config": config,
            "control_path": self.control_path,
            "serving_dir": self.serving_dir,
            "promote_every": self.serve.promote_every,
            "promote_margin": self.serve.promote_margin,
            "promote_keep": self.serve.promote_keep,
            "eval_batch": self.serve.eval_batch,
            "device": self.serve.device,
        }
        # through the publish seam: mkstemp never collides, so a stale
        # temp file cannot wedge a later publish
        atomic_publish(self.spec_path,
                       json.dumps(spec, indent=2, sort_keys=True) + "\n",
                       prefix=".spec.")

    def _launch(self) -> subprocess.Popen:
        self._write_spec()
        # status() readers tolerate a one-poll-stale count
        self.lifetimes += 1
        # the package may be running straight out of a checkout (not
        # installed): make the child resolve `-m matcha_tpu_torch...` from
        # the same tree the supervisor imported, whatever the daemon's cwd
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env = dict(os.environ)
        if self.serve.env:
            env.update({str(k): str(v) for k, v in self.serve.env.items()})
        env["PYTHONPATH"] = pkg_root + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        return subprocess.Popen(
            [sys.executable, "-m", "matcha_tpu_torch.serve.trainer",
             self.spec_path], env=env)

    def _merge_restart_fields(self) -> Dict:
        """Fold the current (valid) control document's restart-scope
        fields into the config the next lifetime launches with."""
        raw, problems = load_control(self.control_path)
        if not raw or problems:
            return {}
        merged = {k: raw[k] for k in RESTART_FIELDS
                  if k in raw and self.config.get(k) != raw[k]}
        if not merged:
            return {}
        # same cross-field guard the trainer applies before requesting
        # the restart: a merge that cannot construct a TrainConfig would
        # crash-loop the next lifetime into the budget
        try:
            from ..train import TrainConfig

            TrainConfig(**{**self.config, **merged})
        except (ValueError, TypeError) as e:
            journal_control(
                self.journal_path, action="reject", applied=False,
                reason=f"restart-scope merge invalid: {e}", epoch=-1)
            return {}
        self.config.update(merged)
        return merged

    def _progress(self) -> Optional[int]:
        """Latest checkpointed epoch, or ``None`` before any checkpoint —
        the supervisor's only notion of "how far did training get"."""
        if not os.path.isdir(self.ckpt_dir):
            return None
        from ..train import latest_step

        return latest_step(self.ckpt_dir)

    def _maybe_refill(self, progress: Optional[int]) -> None:
        """Sustained healthy progress earns crash credits back: every
        ``refill_epochs`` clean checkpointed epochs since the last refill
        restore one credit (never below 0 used — the cap is the budget
        itself).  Without this, a week-long run with rare unrelated
        crashes deterministically aborts."""
        if not self.serve.refill_epochs or progress is None:
            return
        if self._refill_base is None:
            self._refill_base = progress
            return
        delta = progress - self._refill_base
        credits = min(delta // self.serve.refill_epochs, self.restarts_used)
        if credits <= 0:
            return
        self.restarts_used -= credits
        self._refill_base += credits * self.serve.refill_epochs
        from ..obs.journal import append_journal_record

        append_journal_record(
            self.journal_path, "recovery", scope="budget", action="refill",
            reason=f"{delta} clean checkpointed epoch(s) since the last "
                   f"refill restored {credits} crash credit(s) "
                   f"({self.restarts_used}/{self.serve.restart_budget} "
                   f"used)", epoch=-1)

    def _maybe_escalate(self, rc: int, progress: Optional[int],
                        crashed_at: float) -> bool:
        """Crash-loop detection: two consecutive crashes with the same
        exit signature (exit code + checkpoint step they restored from),
        spaced inside one crash window, mean the relaunch is
        deterministically re-hitting the same poisoned artifact — burning
        the rest of the budget on it is pointless.  Escalate: quarantine
        the checkpoint generation both lifetimes resumed from, so the
        next relaunch restores the next-oldest one."""
        window = self.serve.crash_window or self.serve.backoff_max
        sig = (rc, progress)
        prev = self._last_crash
        self._last_crash = (sig, crashed_at)
        if (prev is None or prev[0] != sig or progress is None
                or crashed_at - prev[1] > window):
            return False
        from ..obs.journal import append_journal_record
        from ..train.checkpoint import quarantine_step

        qpath = quarantine_step(self.ckpt_dir, progress)
        append_journal_record(
            self.journal_path, "recovery", scope="checkpoint",
            action="quarantine",
            reason=f"crash loop: two consecutive exits {rc} from "
                   f"checkpoint step {progress} inside {window:.1f}s — "
                   f"quarantined the generation; next relaunch resumes "
                   f"from the next-oldest", epoch=-1,
            quarantined=qpath)
        self._last_crash = None  # the signature's cause was removed
        return True

    # ----------------------------------------------------------- the daemon
    def run(self) -> int:
        """Supervise until the run completes, the budget exhausts, or
        ``shutdown()`` is called.  Returns the final exit code (0 on a
        clean completion)."""
        sleep = self.serve.backoff
        while True:
            self._proc = self._launch()
            rc = self._proc.wait()
            self._proc = None
            self.last_exit = rc
            if self._stopping or rc == 0:
                return 0 if rc in (0, RESTART_EXIT) else rc
            if rc == RESTART_EXIT:
                merged = self._merge_restart_fields()
                journal_control(
                    self.journal_path, action="relaunch", applied=True,
                    reason=f"restart-scope control fields {sorted(merged)} "
                           f"merged; relaunching from checkpoint",
                    epoch=-1, fields=merged)
                sleep = self.serve.backoff  # deliberate, not a crash
                continue
            progress = self._progress()
            self._maybe_refill(progress)
            self._maybe_escalate(rc, progress, time.monotonic())
            self.restarts_used += 1
            if self.restarts_used > self.serve.restart_budget:
                journal_control(
                    self.journal_path, action="abort", applied=False,
                    reason=f"trainer exit {rc}: restart budget "
                           f"({self.serve.restart_budget}) exhausted",
                    epoch=-1)
                return rc
            journal_control(
                self.journal_path, action="restart", applied=True,
                reason=f"trainer crashed with exit {rc} (attempt "
                       f"{self.restarts_used}/{self.serve.restart_budget}, "
                       f"backoff {sleep:.1f}s)",
                epoch=-1)
            time.sleep(sleep)
            # decorrelated jitter: next sleep drawn from [base, 3*previous]
            # instead of a deterministic doubling — a fleet of daemons
            # crashing together (shared-FS hiccup) de-synchronizes their
            # relaunch stampede instead of re-colliding every 2^k seconds
            sleep = min(self.serve.backoff_max,
                        self._rng.uniform(self.serve.backoff, sleep * 3))

    def shutdown(self, timeout: float = 30.0) -> None:
        """Terminate the current trainer (SIGTERM, then SIGKILL after
        ``timeout``) and end supervision — the signal-handler path."""
        self._stopping = True
        proc = self._proc
        if proc is None:
            return
        proc.terminate()
        try:
            proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()

    # ------------------------------------------------------------ reporting
    def status(self) -> Dict:
        """The ``/status`` payload: pure supervisor state + file facts
        (no device reads — the controller has no device)."""
        proc = self._proc
        return {
            "name": self.config.get("name", "experiment"),
            "run_dir": self.run_dir,
            "serving_dir": self.serving_dir,
            "control_path": self.control_path,
            "trainer_alive": proc is not None and proc.poll() is None,
            "lifetimes": self.lifetimes,
            "restarts_used": self.restarts_used,
            "restart_budget": self.serve.restart_budget,
            "last_exit": self.last_exit,
            "stopping": self._stopping,
        }
