"""The chaos harness of the port (``matcha_tpu_torch.chaos``, the taps at
their sites, ``FaultyFS`` and ``wall_clock``, ``atomic_publish``'s
barrier, ``chaos_torch.py``) against the JAX package's
(``matcha_tpu.chaos``, ``chaos_tpu.py``), on the CPU.

Every comparison is exact: the harness is host code on both sides.  The
seeded schedules, the injectors' choices (offset, bit, line, span, cut)
and the bytes they leave, the invariant suite's violation strings and
the campaign report are held equal to the JAX package's on the same
inputs; the report names the package's own CLI in its replay hint
(``chaos_torch.py`` for ``chaos_tpu.py``), which is the one difference.
The taps are reached at their sites in the port's own ``train()``,
``save_checkpoint``, promotion writer and trainer harness, under a
``SIGUSR1`` spec whose handler records where the signal landed.  The
end-to-end trials are in ``test_torch_chaos_trial.py``.
"""

import dataclasses
import json
import os
import random
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from matcha_tpu.chaos import campaign as jcampaign
from matcha_tpu.chaos import injectors as jinjectors
from matcha_tpu.chaos import invariants as jinvariants
from matcha_tpu.chaos import taps as jtaps
from matcha_tpu.obs import bestio as jbestio
from matcha_tpu.serve import promote as jpromote
from matcha_tpu.utils import atomicio as jatomicio
from matcha_tpu_torch.chaos import campaign, injectors, invariants, taps
from matcha_tpu_torch.obs import bestio
from matcha_tpu_torch.obs.journal import append_journal_record, read_journal
from matcha_tpu_torch.serve import TrainerHarness, promote, write_control
from matcha_tpu_torch.train import TrainConfig, train
from matcha_tpu_torch.train.checkpoint import (
    restore_with_fallback,
    verify_checkpoint_digest,
)
from matcha_tpu_torch.utils import atomicio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.chaos

#: the JAX chaos tests' CHAOS_CFG (``tests/test_chaos.py``), on the port
CHAOS_CFG = TrainConfig(
    name="cz", model="mlp", dataset="synthetic",
    dataset_kwargs={"num_train": 64, "num_test": 16}, num_workers=4,
    graphid=None, topology="ring", batch_size=8, epochs=2, lr=0.05,
    warmup=False, matcha=True, budget=0.5, seed=3, save=True,
    eval_every=0, checkpoint_every=1, measure_comm_split=False)


@pytest.fixture(autouse=True)
def _clean_chaos_seams():
    """Every test leaves both packages' process-global seams unarmed."""
    yield
    for module in (taps, jtaps):
        module.reset()
    for module in (bestio, jbestio):
        module.install_fs(None)


# ------------------------------------------------------- seeded schedules

def test_schedule_for_seed_equals_jax():
    for seed in range(56):
        assert campaign.schedule_for_seed(seed).to_json() == \
            jcampaign.schedule_for_seed(seed).to_json(), seed
    spec = campaign.schedule_for_seed(11)
    assert campaign.FaultSpec(**spec.to_json()) == spec


def test_families_expectations_and_trial_config_equal_jax(tmp_path):
    assert campaign.FAMILIES == jcampaign.FAMILIES
    assert len(campaign.FAMILIES) == 14
    assert campaign.TRAIN_SEED == jcampaign.TRAIN_SEED
    assert invariants.EXPECTED_RESTARTS == jinvariants.EXPECTED_RESTARTS
    assert invariants.EXPECTED_RECOVERY == jinvariants.EXPECTED_RECOVERY
    assert set(invariants.EXPECTED_RESTARTS) == set(campaign.FAMILIES)
    for epochs in (2, 4):
        assert campaign._trial_config(str(tmp_path), epochs) == \
            jcampaign._trial_config(str(tmp_path), epochs)
    # the trial config builds a TrainConfig of the port as it is
    TrainConfig(**campaign._trial_config(str(tmp_path), 4))
    assert (taps.ENV_KILL, taps.BARRIERS) == (jtaps.ENV_KILL, jtaps.BARRIERS)
    assert (bestio.ENV_FS, bestio.ENV_SKEW) == (jbestio.ENV_FS,
                                                jbestio.ENV_SKEW)


@pytest.mark.parametrize("seed", [6, 7, 10, 11, 12, 20, 21, 25])
def test_env_for_equals_jax(seed, tmp_path):
    spec = campaign.schedule_for_seed(seed)
    jspec = jcampaign.schedule_for_seed(seed)
    assert campaign._env_for(spec, str(tmp_path)) == \
        jcampaign._env_for(jspec, str(tmp_path))


def test_twin_key_holds_the_device_and_the_config(tmp_path, monkeypatch):
    """A twin cached on the CPU or for another config is never reused."""
    rows = {"cuda": [0, 1.0, 0.5, 0.5, 0.1], "cpu": [0, 2.0, 0.5, 0.5, 0.1]}
    digest = campaign._config_digest(4)
    for device, row in rows.items():
        cache = tmp_path / "twins" / f"e4-p0-c0-{device}-{digest}.json"
        cache.parent.mkdir(exist_ok=True)
        cache.write_text(json.dumps({"row": row}))
    for device, row in rows.items():
        assert campaign._twin_row(str(tmp_path), 4, False, None, print,
                                  device) == tuple(row)
    base = campaign._trial_config
    monkeypatch.setattr(campaign, "_trial_config",
                        lambda path, epochs: {**base(path, epochs),
                                              "num_workers": 8})
    assert campaign._config_digest(4) != digest
    # the run folder is not part of the signature
    monkeypatch.setattr(campaign, "_trial_config", base)
    assert campaign._config_digest(4) == digest


# ----------------------------------------------------------------- the taps

def _arm(monkeypatch, tmp_path, barrier, count=1, signal_name="USR1"):
    marker = str(tmp_path / "fired")
    monkeypatch.setenv(taps.ENV_KILL, json.dumps(
        {"barrier": barrier, "count": count, "signal": signal_name,
         "marker": marker}))
    return marker


def _scenario_unarmed(module, monkeypatch, tmp_path):
    monkeypatch.delenv(taps.ENV_KILL, raising=False)
    module.reset()
    for barrier in module.BARRIERS:
        module.maybe_kill(barrier)
    return []


def _scenario_fires_on_count(module, monkeypatch, tmp_path):
    marker = _arm(monkeypatch, tmp_path, "mid_save", count=2)
    module.reset()
    seen = []
    for barrier in ("epoch_boundary", "mid_save", "mid_save", "mid_save"):
        module.maybe_kill(barrier)
        seen.append((barrier, os.path.exists(marker)))
    return seen


def _scenario_existing_marker(module, monkeypatch, tmp_path):
    marker = _arm(monkeypatch, tmp_path, "epoch_boundary")
    with open(marker, "w"):
        pass
    module.reset()
    module.maybe_kill("epoch_boundary")
    return [os.path.getsize(marker)]


def _malformed(raw):
    def scenario(module, monkeypatch, tmp_path):
        monkeypatch.setenv(taps.ENV_KILL, raw)
        module.reset()
        for barrier in module.BARRIERS:
            module.maybe_kill(barrier)
        return []
    return scenario


@pytest.mark.parametrize("scenario,expect_fired,expect", [
    (_scenario_unarmed, 0, []),
    (_scenario_fires_on_count, 1,
     [("epoch_boundary", False), ("mid_save", False), ("mid_save", True),
      ("mid_save", True)]),
    (_scenario_existing_marker, 0, [0]),
    (_malformed("not json"), 0, []),
    (_malformed('{"count": 1}'), 0, []),
    (_malformed('{"barrier": "nope", "marker": "/x"}'), 0, []),
    (_malformed('{"barrier": "mid_save"}'), 0, []),
], ids=["unarmed", "fires_on_count", "existing_marker", "not_json",
        "no_barrier", "unknown_barrier", "no_marker"])
def test_taps_equal_jax(scenario, expect_fired, expect, monkeypatch,
                        tmp_path):
    """Unarmed no-op; the counted occurrence fires SIGUSR1 once, marker
    first; an existing marker means already fired; a malformed spec
    disarms silently — the same on both packages."""
    outcomes = {}
    for name, module in (("port", taps), ("jax", jtaps)):
        fired = []
        prev = signal.signal(signal.SIGUSR1, lambda *_: fired.append(1))
        try:
            where = tmp_path / name
            where.mkdir()
            outcomes[name] = (scenario(module, monkeypatch, where),
                              len(fired))
        finally:
            signal.signal(signal.SIGUSR1, prev)
    assert outcomes["port"] == outcomes["jax"] == (expect, expect_fired)


# ------------------------------------------------------------- the fs seam

def _fs_trace(module, tmp_path):
    fs = module.FaultyFS(mode="enospc", match="health", after=1, count=2)
    hp = str(tmp_path / "health-x.json")
    other = str(tmp_path / "other.json")
    trace = []
    for path, mode in ((hp, "w"), (other, "w"), (hp, "a"), (hp, "w"),
                       (hp, "w"), (hp, "r"), (other, "a")):
        try:
            with fs.open(path, mode) as f:
                if mode != "r":
                    f.write("x")
            trace.append("ok")
        except OSError as e:
            trace.append(f"errno {e.errno}: {e.strerror}")
    src = str(tmp_path / "src")
    with open(src, "w") as f:
        f.write("y")
    fs2 = module.FaultyFS(mode="enospc", match="health", count=1)
    try:
        fs2.replace(src, hp)
        trace.append("replaced")
    except OSError as e:
        trace.append(f"replace errno {e.errno}")
    return trace, fs.ops, fs2.ops


def test_faultyfs_window_and_match_gate_equal_jax(tmp_path):
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    port = _fs_trace(bestio, tmp_path / "p")
    assert port == _fs_trace(jbestio, tmp_path / "j")
    trace, ops, ops2 = port
    # matching op 1 passes, ops 2-3 fault, op 4 the device healed; reads
    # and other paths never count
    assert [t.split(":")[0] for t in trace] == [
        "ok", "ok", "errno 28", "errno 28", "ok", "ok", "ok",
        "replace errno 28"]
    assert trace[2] == "errno 28: chaos: no space left on device " \
                       "(injected, op 2)"
    assert (ops, ops2) == (4, 1)
    with pytest.raises(ValueError, match="unknown FaultyFS mode"):
        bestio.FaultyFS(mode="nope")


def test_faultyfs_slow_mode_delays_and_replace_trips(tmp_path):
    fs = bestio.FaultyFS(mode="slow", delay=0.15, count=1)
    src, dst = str(tmp_path / "a"), str(tmp_path / "b")
    with open(src, "w") as f:
        f.write("x")
    t0 = time.monotonic()
    fs.replace(src, dst)
    assert time.monotonic() - t0 >= 0.15
    assert os.path.exists(dst)
    t0 = time.monotonic()
    with fs.open(str(tmp_path / "c"), "w") as f:  # past the window
        f.write("y")
    assert time.monotonic() - t0 < 0.15


@pytest.mark.parametrize("raw,want", [
    (json.dumps({"mode": "enospc", "match": "health", "count": 3}),
     ("FaultyFS", "enospc", "health", 0, 3, 0.0)),
    (json.dumps({"mode": "slow", "after": 2, "count": 1, "delay": 4.5}),
     ("FaultyFS", "slow", "", 2, 1, 4.5)),
    ("{broken", ("DirectFS",)),
    (json.dumps({"mode": "nope"}), ("DirectFS",)),
    (json.dumps({"mode": "enospc", "bogus": 1}), ("DirectFS",)),
    (None, ("DirectFS",)),
], ids=["enospc", "slow", "not_json", "bad_mode", "bad_key", "unset"])
def test_get_fs_reads_the_environment_like_jax(raw, want, monkeypatch):
    if raw is None:
        monkeypatch.delenv(bestio.ENV_FS, raising=False)
    else:
        monkeypatch.setenv(bestio.ENV_FS, raw)
    got = {}
    for name, module in (("port", bestio), ("jax", jbestio)):
        module.install_fs(None)
        fs = module.get_fs()
        assert module.get_fs() is fs  # parsed once
        got[name] = (type(fs).__name__,) + (
            (fs.mode, fs.match, fs.after, fs.count, fs.delay)
            if isinstance(fs, module.FaultyFS) else ())
    assert got["port"] == got["jax"] == want


@pytest.mark.parametrize("skew,want", [
    ("600", 1600.0), ("-45", 955.0), ("garbage", 1000.0), ("", 1000.0),
    ("-5000", 0.0), (None, 1000.0)])
def test_wall_clock_skew_equals_jax(skew, want, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1000.0)
    if skew is None:
        monkeypatch.delenv(bestio.ENV_SKEW, raising=False)
    else:
        monkeypatch.setenv(bestio.ENV_SKEW, skew)
    assert bestio.wall_clock() == jbestio.wall_clock() == want


def test_one_shot_appender_stamps_the_skewed_clock(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1000.0)
    monkeypatch.setenv(bestio.ENV_SKEW, "60")
    path = str(tmp_path / "events.jsonl")
    event = append_journal_record(path, "recovery", scope="io",
                                  action="restored", reason="r", epoch=0)
    assert event["t"] == 1060.0
    assert read_journal(path)[0]["t"] == 1060.0


# ------------------------------------------------------------ the injectors

def _fabricate(root):
    """A step directory ``7`` (three files of seeded bytes, one nested),
    its digest-less checkpoint root, a 6-line journal and a control path."""
    rng = np.random.default_rng(5)
    step = os.path.join(root, "ckpt", "7")
    os.makedirs(os.path.join(step, "sub"))
    for rel, size in (("a.bin", 64), ("state.pt", 301),
                      (os.path.join("sub", "b.bin"), 17)):
        with open(os.path.join(step, rel), "wb") as f:
            f.write(rng.integers(0, 256, size, dtype=np.uint8).tobytes())
    lines = [json.dumps({"v": 8, "kind": "epoch", "t": float(i),
                         "epoch": i, "pad": "x" * (10 + 7 * i)}) + "\n"
             for i in range(6)]
    with open(os.path.join(root, "events.jsonl"), "w") as f:
        f.writelines(lines)
    return os.path.join(root, "ckpt"), os.path.join(root, "events.jsonl")


def _tree(root):
    out = {}
    for base, dirs, names in os.walk(root):
        for d in dirs:
            out[os.path.relpath(os.path.join(base, d), root) + "/"] = None
        for name in names:
            path = os.path.join(base, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _relative(evidence, root):
    return {k: (os.path.relpath(v, root) if k == "path" else v)
            for k, v in evidence.items()}


INJECTIONS = {
    "bitflip_checkpoint":
        lambda m, ck, jr, rng: m.bitflip_checkpoint(ck, 7, rng),
    "delete_checkpoint_file":
        lambda m, ck, jr, rng: m.delete_checkpoint_file(ck, 7, rng),
    "stale_checkpoint_tempfile":
        lambda m, ck, jr, rng: m.stale_checkpoint_tempfile(ck, 7),
    "tear_journal_tail": lambda m, ck, jr, rng: m.tear_journal_tail(jr, rng),
    "corrupt_journal_midstream":
        lambda m, ck, jr, rng: m.corrupt_journal_midstream(jr, rng),
    "torn_control_tempfile": lambda m, ck, jr, rng: m.torn_control_tempfile(
        os.path.join(os.path.dirname(jr), "ctl", "control.json"), version=7),
    "torn_spec_tempfile": lambda m, ck, jr, rng: m.torn_spec_tempfile(
        os.path.join(os.path.dirname(jr), "spec.json")),
}


@pytest.mark.parametrize("seed", [0, 1, 2, 13])
@pytest.mark.parametrize("injector", sorted(INJECTIONS))
def test_injector_equals_jax(injector, seed, tmp_path):
    """Same seeded ``random.Random``, same file list: the same choice
    (path, offset, bit, cut, line, span) and the same bytes out."""
    results = {}
    for name, module in (("port", injectors), ("jax", jinjectors)):
        root = str(tmp_path / name)
        ckpt, journal = _fabricate(root)
        rng = random.Random(seed)
        evidence = INJECTIONS[injector](module, ckpt, journal, rng)
        results[name] = (_relative(evidence, root), _tree(root),
                         rng.random())
    assert results["port"] == results["jax"]
    clean = str(tmp_path / "clean")
    _fabricate(clean)
    assert results["port"][1] != _tree(clean)


def test_checkpoint_files_sorted_like_jax(tmp_path):
    ckpt, _ = _fabricate(str(tmp_path))
    assert injectors.checkpoint_files(ckpt, 7) == \
        jinjectors.checkpoint_files(ckpt, 7)
    assert [os.path.relpath(p, ckpt) for p in
            injectors.checkpoint_files(ckpt, 7)] == [
        "7/a.bin", "7/state.pt", "7/sub/b.bin"]


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """Two generations of the port's checkpoint (``torch.save``) format."""
    root = str(tmp_path_factory.mktemp("run"))
    result = train(dataclasses.replace(CHAOS_CFG, savePath=root),
                   device="cpu")
    return root, f"{root}/{CHAOS_CFG.name}_ckpt", result


@pytest.mark.parametrize("seed", range(6))
def test_bitflip_in_the_torch_save_archive_is_caught_by_the_digest(
        seed, port_run, tmp_path, monkeypatch):
    """A flipped bit anywhere in the zip archive — a float of the state
    that ``torch.load`` would load silently, or a header it would refuse —
    fails the digest, and the ladder falls back without loading it."""
    root, ckpt, result = port_run
    copy = str(tmp_path / "ckpt")
    shutil.copytree(ckpt, copy)
    evidence = injectors.bitflip_checkpoint(copy, 1, random.Random(seed))
    assert os.path.basename(evidence["path"]) == "state.pt"
    problems = verify_checkpoint_digest(copy, 1)
    assert problems == ["state.pt: content hash mismatch"]
    from matcha_tpu_torch.train import checkpoint as ck

    loaded = []
    real_load = ck.torch.load
    monkeypatch.setattr(ck.torch, "load", lambda path, **kw: (
        loaded.append(path), real_load(path, **kw))[1])
    notices = []
    _state, epoch = restore_with_fallback(copy, result.state,
                                          notices=notices)
    assert epoch == 0 and [n["step"] for n in notices] == [1]
    assert "digest verification failed" in notices[0]["reason"]
    assert loaded == [os.path.join(os.path.abspath(copy), "0", "state.pt")]


def test_delete_checkpoint_file_empties_the_port_step(port_run, tmp_path):
    """The port's generation is one file: deleting it leaves an empty step
    directory, which the digest lists as missing and the ladder
    quarantines."""
    root, ckpt, result = port_run
    copy = str(tmp_path / "ckpt")
    shutil.copytree(ckpt, copy)
    evidence = injectors.delete_checkpoint_file(copy, 1, random.Random(0))
    assert os.path.basename(evidence["path"]) == "state.pt"
    assert os.listdir(os.path.join(copy, "1")) == []
    assert verify_checkpoint_digest(copy, 1) == ["state.pt: missing"]
    notices = []
    _state, epoch = restore_with_fallback(copy, result.state,
                                          notices=notices)
    assert epoch == 0 and notices[0]["path"].endswith("quarantine-1")


# ------------------------------------------------------- invariant suite

def _fabricated_trial(path, family="clock_skew", epochs=4, rc=0,
                      restarts=0):
    for i in range(epochs):
        append_journal_record(
            str(path), "epoch", epoch=i, epoch_time=0.1, comp_time=0.05,
            comm_time=0.05, train_loss=1.0 - 0.1 * i, train_acc=0.5,
            test_acc_mean=0.5, disagreement=0.01)
    return {"seed": 0, "family": family, "rc": rc,
            "restarts_used": restarts, "journal_path": str(path),
            "serving_dir": None, "expect_epochs": epochs}


def _control(path, version, fields, action="apply"):
    append_journal_record(str(path), "control", epoch=2, action=action,
                          applied=True, reason="r", version=version,
                          fields=fields)


def _case_clean(tmp_path):
    return _fabricated_trial(tmp_path / "e.jsonl")


def _case_silent_death(tmp_path):
    return _fabricated_trial(tmp_path / "e.jsonl", rc=1)


def _case_wrong_accounting(tmp_path):
    return _fabricated_trial(tmp_path / "e.jsonl", restarts=1)


def _case_kill_unjournaled_restart(tmp_path):
    return _fabricated_trial(tmp_path / "e.jsonl",
                             family="kill_mid_save", restarts=1)


def _case_short_run(tmp_path):
    trial = _fabricated_trial(tmp_path / "e.jsonl", epochs=3)
    trial["expect_epochs"] = 4
    return trial


def _case_twin_drift(tmp_path):
    trial = _fabricated_trial(tmp_path / "e.jsonl")
    row = jinvariants.final_epoch_row(read_journal(trial["journal_path"]))
    trial["twin_row"] = (row[0], row[1] + 1e-9, row[2], row[3], row[4])
    return trial


def _case_ghost_control(tmp_path):
    trial = _fabricated_trial(tmp_path / "e.jsonl",
                              family="control_torn_tmp")
    trial["evidence"] = {"version": 99}
    _control(trial["journal_path"], 99, {"budget": 0.25})
    return trial


def _case_no_recovery(tmp_path):
    return _fabricated_trial(tmp_path / "e.jsonl", family="ckpt_bitflip")


def _case_half_applied(tmp_path):
    trial = _fabricated_trial(tmp_path / "e.jsonl")
    _control(trial["journal_path"], 1, {"budget": 0.25})
    _control(trial["journal_path"], 1, {"budget": 0.5})
    return trial


def _case_torn_journal(tmp_path):
    trial = _fabricated_trial(tmp_path / "e.jsonl", rc=3)
    with open(trial["journal_path"], "ab") as f:
        f.write(b'{"v": 8, "kind": "epo')
    return trial


def _case_invalid_event(tmp_path):
    trial = _fabricated_trial(tmp_path / "e.jsonl")
    with open(trial["journal_path"], "a") as f:  # an epoch row short of
        f.write(json.dumps({"v": 7, "kind": "epoch", "t": 9.0,  # its fields
                            "epoch": 0}) + "\n")
    return trial


def _case_dangling_pointer(tmp_path):
    trial = _fabricated_trial(tmp_path / "e.jsonl")
    serving = tmp_path / "serving"
    manifest = jpromote.write_candidate(
        str(serving), 3, 12, {"w": np.ones(3, np.float32)},
        {"test_acc": 0.5}, "fp", 0)
    jpromote.decide_promotion(str(serving), manifest)
    os.remove(serving / manifest["params_file"])
    trial["serving_dir"] = str(serving)
    return trial


CASES = {name[len("_case_"):]: fn for name, fn in dict(globals()).items()
         if name.startswith("_case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_check_invariants_equals_jax(case, tmp_path):
    """The same fabricated trial: the same violations, word for word."""
    trial = CASES[case](tmp_path)
    got = invariants.check_invariants(dict(trial))
    assert got == jinvariants.check_invariants(dict(trial))
    assert bool(got) == (case != "clean"), got
    assert invariants.final_epoch_row(read_journal(
        trial["journal_path"], repair=True)) == jinvariants.final_epoch_row(
        read_journal(trial["journal_path"], repair=True))


def _campaign_dict(tmp_path, failing):
    results = []
    for seed in (0, 6, 13):
        trial = _fabricated_trial(tmp_path / f"{seed}.jsonl",
                                  family=jcampaign.FAMILIES[seed])
        trial.update(spec=jcampaign.schedule_for_seed(seed).to_json(),
                     seed=seed, lifetimes=1)
        trial["violations"] = (jinvariants.check_invariants(trial)
                               if failing else [])
        trial["ok"] = not trial["violations"]
        results.append(trial)
    failed = [r for r in results if not r["ok"]]
    return {"trials": len(results), "failed_seeds": [r["seed"]
                                                     for r in failed],
            "families": sorted({r["family"] for r in results}),
            "ok": not failed, "results": results}


@pytest.mark.parametrize("failing", [False, True], ids=["pass", "fail"])
def test_render_report_equals_jax(failing, tmp_path):
    """Byte-equal, the replay hint naming each package's own CLI."""
    report = _campaign_dict(tmp_path, failing)
    port = campaign.render_report(report)
    jax = jcampaign.render_report(report)
    assert port == jax.replace("python chaos_tpu.py replay",
                               "python chaos_torch.py replay")
    assert ("chaos_torch.py replay" in port) == failing
    if not failing:
        assert port == jax


# ------------------------------------------------- atomic_publish's barrier

@pytest.mark.parametrize("package", ["port", "jax"])
def test_atomic_publish_barrier_fires_between_write_and_rename(
        package, monkeypatch, tmp_path):
    """At the tap the payload is flushed into the tempfile and the target
    still holds the old document; an unarmed barrier publishes."""
    module, tap = ((atomicio, taps) if package == "port"
                   else (jatomicio, jtaps))
    target = tmp_path / "pub" / "doc.json"
    target.parent.mkdir()
    target.write_text("old")
    _arm(monkeypatch, tmp_path, "mid_promote")
    tap.reset()
    seen = []

    def handler(*_):
        seen.append({name: (target.parent / name).read_text()
                     for name in sorted(os.listdir(target.parent))})

    prev = signal.signal(signal.SIGUSR1, handler)
    try:
        module.atomic_publish(str(target), "new", barrier="mid_save")
        assert seen == []  # another barrier: no tap
        module.atomic_publish(str(target), "newer", barrier="mid_promote")
    finally:
        signal.signal(signal.SIGUSR1, prev)
    (state,) = seen
    tmps = [n for n in state if n.endswith(".tmp")]
    assert state["doc.json"] == "new" and len(tmps) == 1
    assert tmps[0].startswith(".doc.json.") and state[tmps[0]] == "newer"
    assert os.listdir(target.parent) == ["doc.json"]
    assert target.read_text() == "newer"


def test_atomic_publish_killed_at_the_barrier_leaves_a_stale_tempfile(
        tmp_path):
    """A real SIGKILL at the tap: the old target intact beside a stale
    tempfile holding the whole new payload — for both packages' code."""
    states = {}
    for package, module in (("port", "matcha_tpu_torch.utils.atomicio"),
                            ("jax", "matcha_tpu.utils.atomicio")):
        where = tmp_path / package
        where.mkdir()
        (where / "MANIFEST.json").write_text('{"epoch": 1}')
        env = dict(os.environ, **{taps.ENV_KILL: json.dumps(
            {"barrier": "mid_promote", "signal": "KILL",
             "marker": str(tmp_path / f"{package}.fired")})})
        code = (f"import {module} as m; m.atomic_publish("
                f"{str(where / 'MANIFEST.json')!r}, '{{\"epoch\": 2}}', "
                f"barrier='mid_promote')")
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == -signal.SIGKILL, out.stderr
        states[package] = {
            ("tmp" if n.endswith(".tmp") else n): (where / n).read_text()
            for n in os.listdir(where)}
    assert states["port"] == states["jax"] == {
        "MANIFEST.json": '{"epoch": 1}', "tmp": '{"epoch": 2}'}


# ------------------------------------------------- the taps at their sites

def _site_config(tmp_path, **over):
    cfg = dataclasses.replace(CHAOS_CFG, savePath=str(tmp_path / "run"),
                              **over)
    return cfg


def _drive_epoch_boundary(tmp_path, probe):
    train(_site_config(tmp_path, epochs=3), device="cpu")


def _drive_mid_save(tmp_path, probe):
    cfg = _site_config(tmp_path)
    ckpt = os.path.join(cfg.savePath, f"{cfg.name}_ckpt")
    probe.append(lambda frame: {
        "committed": sorted(n for n in os.listdir(ckpt) if n.isdigit()),
        "digests": sorted(n for n in os.listdir(ckpt)
                          if n.startswith("digest-"))})
    train(cfg, device="cpu")


def _drive_mid_promote(tmp_path, probe):
    serving = str(tmp_path / "serving")
    probe.append(lambda frame: sorted(os.listdir(serving)))
    promote.write_candidate(serving, 2, 8, {"w": np.ones(4, np.float32)},
                            {"test_acc": 0.5}, "fp", 0)


def _seam(frame):
    """The boundary seam in the frames above the tap."""
    while "seam" not in frame.f_locals:
        frame = frame.f_back
    return frame.f_locals["seam"]


def _drive_mid_control(tmp_path, probe):
    cfg = _site_config(tmp_path)
    control = str(tmp_path / "control.json")
    write_control(control, {"version": 1, "drift_tolerance": 5.0})
    probe.append(lambda frame: [
        e["action"] for e in _seam(frame).recorder.events
        if e["kind"] == "control"])
    harness = TrainerHarness({"control_path": control})
    result = train(cfg, device="cpu", boundary_hook=harness.on_boundary)
    probe.append(result)


SITES = {
    # barrier: (driver, count, the frames above maybe_kill, the state)
    "epoch_boundary": (_drive_epoch_boundary, 2,
                       [("train", "train/loop.py")], None),
    "mid_save": (_drive_mid_save, 2,
                 [("save_checkpoint", "train/checkpoint.py")],
                 {"committed": ["0", "1"], "digests": ["digest-0.json"]}),
    "mid_promote": (_drive_mid_promote, 1,
                    [("atomic_publish", "utils/atomicio.py"),
                     ("_atomic_json", "serve/promote.py"),
                     ("write_candidate", "serve/promote.py")], None),
    "mid_control": (_drive_mid_control, 1,
                    [("_maybe_apply_control", "serve/trainer.py"),
                     ("on_boundary", "serve/trainer.py")], []),
}


@pytest.mark.parametrize("barrier", sorted(SITES))
def test_tap_is_reached_at_its_site(barrier, monkeypatch, tmp_path):
    """The armed tap fires once, from the JAX package's position in the
    port's code; the state at that instant is the torn state the family
    is about."""
    driver, count, frames, state = SITES[barrier]
    _arm(monkeypatch, tmp_path, barrier, count=count)
    taps.reset()
    hits, probe = [], []

    def handler(signum, frame):
        chain, f = [], frame
        while f is not None and len(chain) < 8:
            chain.append((f.f_code.co_name,
                          "/".join(f.f_code.co_filename.split(os.sep)[-2:])))
            f = f.f_back
        hits.append((chain, probe[0](frame) if probe else None))

    prev = signal.signal(signal.SIGUSR1, handler)
    try:
        driver(tmp_path, probe)
    finally:
        signal.signal(signal.SIGUSR1, prev)
    assert len(hits) == 1, hits
    chain, seen = hits[0]
    assert chain[0] == ("maybe_kill", "chaos/taps.py")
    assert chain[1:1 + len(frames)] == frames, chain
    if state is not None:
        assert seen == state
    if barrier == "mid_control":
        # the decision journaled after the tap, applied once
        events = read_journal(os.path.join(
            probe[1].recorder.folder, "events.jsonl"))
        assert [(e["action"], e["version"]) for e in events
                if e["kind"] == "control"] == [("apply", 1)]


# ------------------------------------------------------------- the CLI

BLOCK = """
import importlib.abc, runpy, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "flax", "optax", "matcha_tpu",
                                  "ml_dtypes", "orbax"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.argv = ["chaos_torch.py"] + sys.argv[1:]
runpy.run_path("chaos_torch.py", run_name="__main__")
"""


def test_chaos_torch_families_runs_with_jax_blocked():
    out = subprocess.run([sys.executable, "-c", BLOCK, "families"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    jax = subprocess.run([sys.executable, "chaos_tpu.py", "families"],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.stdout == jax.stdout
    assert len(out.stdout.splitlines()) == 14


@pytest.mark.parametrize("cmd", ["replay", "shrink", "campaign"])
def test_chaos_torch_defaults_to_the_card(cmd, tmp_path):
    """Without ``--device`` the trainers want the card: a host without
    CUDA fails before any trial starts, never a quiet CPU run."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default runs trials on it")
    args = {"replay": ["--seed", "7"], "shrink": ["--seed", "7"],
            "campaign": ["--trials", "1"]}[cmd]
    work = tmp_path / "w"
    out = subprocess.run([sys.executable, "-c", BLOCK, cmd, *args,
                          "--workdir", str(work)], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    assert not work.exists()


@pytest.mark.parametrize("entry", ["run_trial", "run_campaign", "shrink"])
def test_campaign_entry_points_default_to_the_card(entry, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default runs trials on it")
    spec = campaign.schedule_for_seed(3)
    call = {"run_trial": lambda: campaign.run_trial(spec, str(tmp_path)),
            "run_campaign": lambda: campaign.run_campaign([3],
                                                          str(tmp_path)),
            "shrink": lambda: campaign.shrink(spec, str(tmp_path))}[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()
    assert os.listdir(tmp_path) == []
