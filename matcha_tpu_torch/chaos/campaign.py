"""Seeded chaos campaigns against the serve daemon.

Port of ``matcha_tpu/chaos/campaign.py`` (:1-371).  One trial = one seed
= one scheduled fault against one supervised run of the daemon's own
stack (``serve.Controller`` launching the ``matcha_tpu_torch.serve.
trainer`` subprocess — the code path ``serve_torch.py run`` drives),
judged by the pinned invariant suite (``chaos.invariants``).

The trainer runs on the card: ``run_trial``, ``run_campaign`` and
``shrink`` take ``device`` (``None`` = the card, as every entry point of
the port; a host without CUDA raises before any trial starts, never a
quiet CPU run; ``"cpu"`` asks for the plain PyTorch path).  It reaches
the trainer through ``ServeConfig.device``.

Determinism contract: ``schedule_for_seed`` is a pure function of the
seed (family round-robin + ``random.Random(seed)`` parameters), every
disk injector draws from the same RNG, the supervisor's backoff jitter
is pinned to the seed, and kill/fs/skew specs cross the process boundary
as environment variables — so ``replay(seed)`` re-runs the exact fault
schedule and must reproduce the verdict (an acceptance criterion).

Failing seeds **shrink**: every spec parameter is greedily reduced
toward its default while the trial still fails, yielding the minimal
fault schedule that reproduces the failure.

Uninterrupted **twins**: kill-family trials compare their final epoch
row against a fault-free run of the identical config.  Twins are cached
per configuration signature under ``{workdir}/twins/`` — a campaign
pays for each distinct twin once, not per trial.  The signature holds
the device and a digest of the trial config, so a twin trained on the
CPU never stands for a card trial, nor one config's twin for another's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import random
import shutil
from typing import Dict, Optional

from ..obs.bestio import ENV_FS, ENV_SKEW
from ..utils.device import resolve_device
from .injectors import (
    bitflip_checkpoint,
    corrupt_journal_midstream,
    delete_checkpoint_file,
    stale_checkpoint_tempfile,
    tear_journal_tail,
    torn_control_tempfile,
    torn_spec_tempfile,
)
from .invariants import check_invariants, final_epoch_row
from .taps import ENV_KILL

__all__ = ["FAMILIES", "FaultSpec", "schedule_for_seed", "run_trial",
           "run_campaign", "shrink", "render_report"]

#: every injector family a seed can land on (seed % len → family):
#: durable-state faults injected between two supervised runs, process
#: kills at seeded barriers, observability-IO faults, and clock skew
FAMILIES = (
    "ckpt_bitflip",        # flip one bit in the latest checkpoint
    "ckpt_missing_file",   # delete a file inside the latest step dir
    "ckpt_stale_tmp",      # stale sidecar tempfile in the ckpt root
    "journal_torn_tail",   # truncate the journal mid-final-line
    "journal_midstream",   # corrupt an interior journal line
    "control_torn_tmp",    # half-written control.json.tmp (torn publish)
    "kill_epoch_boundary",  # SIGKILL/SIGTERM at the epoch-loop top
    "kill_mid_save",       # … mid-save (step committed, no sidecar)
    "kill_mid_promote",    # … between the manifest tmp-write and replace
    "kill_mid_control",    # … after control values applied, pre-journal
    "io_enospc",           # ENOSPC on heartbeat writes
    "io_slow",             # hung/slow heartbeat writes (past the deadline)
    "clock_skew",          # skewed heartbeat wall clock
    "spec_torn_tmp",       # directory squatting on spec.json.tmp
)

#: training seed shared by every trial and twin — variety comes from the
#: *fault* schedule, and a fixed train seed is what lets one twin serve
#: every same-config trial
TRAIN_SEED = 3


@dataclasses.dataclass
class FaultSpec:
    """One trial's complete fault schedule — a pure function of ``seed``
    (see ``schedule_for_seed``), JSON-serializable for replay/reports."""

    family: str
    seed: int
    signal: str = "KILL"    # kill families: SIGKILL or SIGTERM
    kill_count: int = 1     # which barrier occurrence fires
    skew: float = 0.0       # clock_skew: seconds added to wall time
    delay: float = 0.0      # io_slow: per-op sleep (past the sink deadline)
    io_after: int = 0       # io families: clean ops before the window
    io_count: int = 2       # io families: faulted ops in the window

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)


def schedule_for_seed(seed: int) -> FaultSpec:
    """Seed → fault schedule, purely: same seed, same schedule, always."""
    seed = int(seed)
    family = FAMILIES[seed % len(FAMILIES)]
    rng = random.Random(seed)
    spec = FaultSpec(family=family, seed=seed)
    if family.startswith("kill_"):
        spec.signal = rng.choice(("KILL", "TERM"))
        if family == "kill_epoch_boundary":
            spec.kill_count = rng.randint(1, 3)
        elif family == "kill_mid_save":
            spec.kill_count = rng.randint(1, 2)
    elif family == "clock_skew":
        spec.skew = rng.choice((-300.0, -45.0, 60.0, 600.0))
    elif family == "io_slow":
        # past the heartbeat sink's 2s deadline: the hung-write path
        spec.delay = round(rng.uniform(3.0, 6.0), 1)
        spec.io_after = rng.randint(0, 2)
        spec.io_count = rng.randint(1, 3)
    elif family == "io_enospc":
        # >= 2 so the sink's one retry cannot absorb the fault silently
        spec.io_after = rng.randint(0, 2)
        spec.io_count = rng.randint(2, 5)
    return spec


# --------------------------------------------------------------- trial setup

def _trial_config(save_path: str, epochs: int) -> Dict:
    """The small MLP ring every trial trains (seconds per lifetime,
    checkpoint every epoch so generations exist to fall back through)."""
    return {
        "name": "chaos", "model": "mlp", "dataset": "synthetic",
        "dataset_kwargs": {"num_train": 64, "num_test": 16},
        "num_workers": 4, "graphid": None, "topology": "ring",
        "batch_size": 8, "epochs": int(epochs), "lr": 0.05,
        "warmup": False, "matcha": True, "budget": 0.5,
        "seed": TRAIN_SEED, "save": True, "savePath": save_path,
        "eval_every": 0, "checkpoint_every": 1,
        "measure_comm_split": False,
    }


def _env_for(spec: FaultSpec, trial_dir: str) -> Dict[str, str]:
    """The process-boundary injection: env vars the trainer subprocess
    reads (``chaos.taps`` / ``obs.bestio``)."""
    family = spec.family
    if family.startswith("kill_"):
        return {ENV_KILL: json.dumps({
            "barrier": family[len("kill_"):],
            "count": spec.kill_count,
            "signal": spec.signal,
            "marker": os.path.join(trial_dir, "kill.fired")})}
    if family in ("io_enospc", "io_slow"):
        fs = {"mode": "enospc" if family == "io_enospc" else "slow",
              "match": "health" + os.sep, "after": spec.io_after,
              "count": spec.io_count}
        if family == "io_slow":
            fs["delay"] = spec.delay
        return {ENV_FS: json.dumps(fs)}
    if family == "clock_skew":
        return {ENV_SKEW: str(spec.skew)}
    return {}


def _controller(save_path: str, epochs: int, spec: FaultSpec,
                env: Optional[Dict[str, str]] = None,
                promote: bool = False, *, device: str):
    from ..serve import Controller, ServeConfig

    return Controller(ServeConfig(
        config=_trial_config(save_path, epochs),
        promote_every=1 if promote else 0,
        restart_budget=3, backoff=0.05, backoff_max=0.5,
        jitter_seed=spec.seed, env=env or None, device=device))


def _config_digest(epochs: int) -> str:
    """Digest of the trial config a twin trains, its run folder aside."""
    config = {k: v for k, v in _trial_config("", epochs).items()
              if k != "savePath"}
    blob = json.dumps(config, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def _twin_row(workdir: str, epochs: int, promote: bool,
              control_doc: Optional[Dict], log, device: str) -> tuple:
    """Final epoch row of the uninterrupted twin for this configuration,
    cached under ``{workdir}/twins/`` (one fault-free run per distinct
    config signature per campaign, not per trial)."""
    key = (f"e{epochs}-p{int(promote)}-c{int(control_doc is not None)}"
           f"-{device}-{_config_digest(epochs)}")
    cache = os.path.join(workdir, "twins", key + ".json")
    if os.path.exists(cache):
        with open(cache) as f:
            return tuple(json.load(f)["row"])
    log(f"chaos: running uninterrupted twin {key}")
    twin_dir = os.path.join(workdir, "twins", key)
    shutil.rmtree(twin_dir, ignore_errors=True)
    spec = FaultSpec(family="twin", seed=0)
    ctl = _controller(twin_dir, epochs, spec, promote=promote,
                      device=device)
    if control_doc is not None:
        from ..serve.control import write_control

        write_control(ctl.control_path, control_doc)
    rc = ctl.run()
    if rc != 0 or ctl.restarts_used:
        raise RuntimeError(
            f"uninterrupted twin {key} failed (rc {rc}, "
            f"{ctl.restarts_used} restart(s)) — the baseline itself is "
            f"broken; no chaos verdict is meaningful")
    from ..obs.journal import read_journal

    row = final_epoch_row(read_journal(ctl.journal_path))
    with open(cache, "w") as f:
        json.dump({"row": list(row)}, f)
    return row


_DURABLE = ("ckpt_bitflip", "ckpt_missing_file", "ckpt_stale_tmp",
            "journal_torn_tail", "journal_midstream", "control_torn_tmp",
            "spec_torn_tmp")


def _inject_durable(spec: FaultSpec, ctl, rng: random.Random) -> Dict:
    """Break the paused run's durable state per the family (phase A of a
    durable-state trial, between the two supervised runs)."""
    from ..train.checkpoint import latest_step

    family = spec.family
    if family in ("ckpt_bitflip", "ckpt_missing_file", "ckpt_stale_tmp"):
        step = latest_step(ctl.ckpt_dir)
        if step is None:
            raise RuntimeError("phase A left no checkpoint to corrupt")
        if family == "ckpt_bitflip":
            return bitflip_checkpoint(ctl.ckpt_dir, step, rng)
        if family == "ckpt_missing_file":
            return delete_checkpoint_file(ctl.ckpt_dir, step, rng)
        return stale_checkpoint_tempfile(ctl.ckpt_dir, step)
    if family == "journal_torn_tail":
        return tear_journal_tail(ctl.journal_path, rng)
    if family == "journal_midstream":
        return corrupt_journal_midstream(ctl.journal_path, rng)
    if family == "spec_torn_tmp":
        return torn_spec_tempfile(ctl.spec_path)
    return torn_control_tempfile(ctl.control_path)


# ---------------------------------------------------------------- the trial

def run_trial(spec: FaultSpec, workdir: str, log=lambda msg: None,
              device=None) -> Dict:
    """Run one seeded trial end-to-end on ``device`` (``None``: the card);
    returns the verdict dict (``ok``, ``violations``, evidence, and
    everything the invariant suite judged)."""
    device = resolve_device(device).type
    epochs = 4
    trial_dir = os.path.join(
        workdir, f"trial-{spec.seed:05d}-{spec.family}")
    shutil.rmtree(trial_dir, ignore_errors=True)
    os.makedirs(trial_dir)
    rng = random.Random(spec.seed)
    family = spec.family
    evidence: Dict = {}
    promote = family == "kill_mid_promote"
    control_doc = ({"version": 1, "drift_tolerance": 5.0}
                   if family == "kill_mid_control" else None)

    if family in _DURABLE:
        # phase A: a clean supervised run that leaves durable state …
        ctl_a = _controller(trial_dir, 2, spec, device=device)
        rc_a = ctl_a.run()
        if rc_a != 0:
            raise RuntimeError(f"trial {spec.seed}: phase A failed "
                               f"(rc {rc_a}) before any fault was injected")
        # … broken on disk while no process is alive …
        evidence = _inject_durable(spec, ctl_a, rng)
        log(f"chaos: seed {spec.seed} [{family}] injected "
            f"{evidence.get('injector')}")
        # … then a resuming supervised run that must recover in-process
        ctl = _controller(trial_dir, epochs, spec, device=device)
        rc = ctl.run()
    else:
        env = _env_for(spec, trial_dir)
        ctl = _controller(trial_dir, epochs, spec, env=env,
                          promote=promote, device=device)
        if control_doc is not None:
            from ..serve.control import write_control

            write_control(ctl.control_path, control_doc)
        log(f"chaos: seed {spec.seed} [{family}] env "
            f"{sorted(env) or '(none)'}")
        rc = ctl.run()
        evidence = {"env": env}
        if family.startswith("kill_"):
            evidence["fired"] = os.path.exists(
                os.path.join(trial_dir, "kill.fired"))

    trial = {
        "seed": spec.seed, "family": family, "spec": spec.to_json(),
        "rc": rc, "restarts_used": ctl.restarts_used,
        "lifetimes": ctl.lifetimes, "expect_epochs": epochs,
        "journal_path": ctl.journal_path, "ckpt_dir": ctl.ckpt_dir,
        "serving_dir": ctl.serving_dir if promote else None,
        "evidence": evidence,
    }
    if family.startswith("kill_"):
        if not evidence.get("fired"):
            trial["violations"] = [
                f"injection: the {family} barrier never fired (marker "
                f"absent) — the trial tested nothing"]
            trial["ok"] = False
            return trial
        trial["twin_row"] = _twin_row(workdir, epochs, promote,
                                      control_doc, log, device)
    trial["violations"] = check_invariants(trial)
    trial["ok"] = not trial["violations"]
    log(f"chaos: seed {spec.seed} [{family}] "
        f"{'PASS' if trial['ok'] else 'FAIL: ' + trial['violations'][0]}")
    return trial


# ------------------------------------------------------------- the campaign

def run_campaign(seeds, workdir: str, log=lambda msg: None,
                 device=None) -> Dict:
    """Run one trial per seed on ``device`` (``None``: the card); returns
    the campaign verdict."""
    device = resolve_device(device).type
    results = []
    for seed in seeds:
        results.append(run_trial(schedule_for_seed(seed), workdir,
                                 log=log, device=device))
    failed = [r for r in results if not r["ok"]]
    families = sorted({r["family"] for r in results})
    return {
        "trials": len(results),
        "failed_seeds": [r["seed"] for r in failed],
        "families": families,
        "ok": not failed,
        "results": results,
    }


def shrink(spec: FaultSpec, workdir: str, log=lambda msg: None,
           device=None) -> FaultSpec:
    """Greedily reduce a FAILING spec toward defaults while it still
    fails — the minimal fault schedule that reproduces the failure."""
    device = resolve_device(device).type

    def fails(candidate: FaultSpec) -> bool:
        return not run_trial(candidate, workdir, log=log,
                             device=device)["ok"]

    if not fails(spec):
        raise ValueError(f"seed {spec.seed} passes — nothing to shrink")
    current = spec
    defaults = FaultSpec(family=spec.family, seed=spec.seed)
    for field in ("signal", "kill_count", "skew", "delay", "io_after",
                  "io_count"):
        value = getattr(defaults, field)
        if getattr(current, field) == value:
            continue
        candidate = dataclasses.replace(current, **{field: value})
        if fails(candidate):
            current = candidate
            log(f"chaos: shrink kept {field}={value!r}")
    return current


def render_report(campaign: Dict, markdown: bool = True) -> str:
    """The campaign report (``chaos_r8.md`` artifact shape)."""
    lines = ["# Chaos campaign", "",
             f"- trials: {campaign['trials']}",
             f"- families covered: {', '.join(campaign['families'])}",
             f"- verdict: **{'PASS' if campaign['ok'] else 'FAIL'}**"]
    if campaign["failed_seeds"]:
        lines.append(f"- failing seeds: {campaign['failed_seeds']} "
                     f"(replay: `python chaos_torch.py replay --seed N`)")
    lines += ["", "| seed | family | rc | restarts | lifetimes | verdict |",
              "|---|---|---|---|---|---|"]
    for r in campaign["results"]:
        verdict = "pass" if r["ok"] else r["violations"][0]
        lines.append(f"| {r['seed']} | {r['family']} | {r['rc']} | "
                     f"{r['restarts_used']} | {r['lifetimes']} | "
                     f"{verdict} |")
    for r in campaign["results"]:
        if r["ok"]:
            continue
        lines += ["", f"## seed {r['seed']} ({r['family']})", ""]
        lines += [f"- {v}" for v in r["violations"]]
        lines += [f"- spec: `{json.dumps(r['spec'])}`"]
    return "\n".join(lines) + "\n"
