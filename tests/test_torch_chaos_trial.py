"""Chaos trials of the port end to end, on the CPU (``device="cpu"``):
the daemon's own ``Controller`` launching ``python -m
matcha_tpu_torch.serve.trainer`` per lifetime, broken by a seeded fault
and judged by the pinned invariant suite.

Not slow: one kill trial (``kill_mid_save``, seed 7, its signal SIGTERM,
with its uninterrupted twin: three lifetimes) and one durable-state
trial (``journal_torn_tail``, seed 3: two lifetimes), and the
``delete_checkpoint_file`` → empty step directory → quarantine path
through ``train()``.  Slow, as the JAX package's are: the 26-seed
campaign across all 14 families, and ``shrink`` on a trial made to fail.
"""

import dataclasses
import os
import random

import pytest

from matcha_tpu_torch.chaos import campaign, invariants
from matcha_tpu_torch.chaos.injectors import delete_checkpoint_file
from matcha_tpu_torch.obs.journal import read_journal
from matcha_tpu_torch.train import TrainConfig, train
from matcha_tpu_torch.train.checkpoint import (
    latest_step,
    verify_checkpoint_digest,
)

pytestmark = pytest.mark.chaos


@pytest.fixture(autouse=True)
def _one_thread_trainers(monkeypatch):
    """Each trainer subprocess (a tiny MLP) uses one CPU thread, so the
    trials do not crowd the other test workers' CPUs."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def test_kill_mid_save_trial_resumes_to_its_twin(tmp_path):
    spec = campaign.schedule_for_seed(7)
    assert (spec.family, spec.signal) == ("kill_mid_save", "TERM")
    trial = campaign.run_trial(spec, str(tmp_path), device="cpu")
    assert trial["ok"], trial["violations"]
    assert trial["evidence"]["fired"]
    assert (trial["rc"], trial["restarts_used"], trial["lifetimes"]) == \
        (0, 1, 2)
    events = read_journal(trial["journal_path"])
    assert tuple(trial["twin_row"]) == invariants.final_epoch_row(events)
    # the tap's SIGTERM is charged as a crash, exactly as a SIGKILL is
    restarts = [e for e in events if e["kind"] == "control"
                and e["action"] == "restart"]
    assert len(restarts) == 1
    assert "exit -15" in restarts[0]["reason"]
    # killed after the commit, before the digest: the resumed lifetime
    # restored the unverifiable generation and every later save verifies
    ckpt = trial["ckpt_dir"]
    assert latest_step(ckpt) == 3
    assert all(verify_checkpoint_digest(ckpt, s) == [] for s in (1, 2, 3))
    twins = os.listdir(tmp_path / "twins")
    assert len([t for t in twins if t.endswith(".json")]) == 1
    assert "-cpu-" in twins[0]


def test_journal_torn_tail_trial_repairs_in_process(tmp_path):
    spec = campaign.schedule_for_seed(3)
    assert spec.family == "journal_torn_tail"
    trial = campaign.run_trial(spec, str(tmp_path), device="cpu")
    assert trial["ok"], trial["violations"]
    assert (trial["rc"], trial["restarts_used"]) == (0, 0)
    assert trial["evidence"]["injector"] == "tear_journal_tail"
    repairs = [e for e in read_journal(trial["journal_path"])
               if e["kind"] == "recovery" and e["scope"] == "journal"]
    assert [e["action"] for e in repairs] == ["repair"]


def test_deleted_payload_empties_the_step_and_the_ladder_quarantines(
        tmp_path):
    """The port's generation is one ``torch.save`` file: the injector
    empties the step directory; the resume quarantines it, restores the
    previous generation, journals the move, and the re-save at the same
    step lands with a verifying digest (JAX's
    ``test_partial_step_dir_falls_back_and_later_save_does_not_trip``)."""
    cfg = TrainConfig(**campaign._trial_config(str(tmp_path), 2))
    train(cfg, device="cpu")
    ckpt = f"{cfg.savePath}/{cfg.name}_ckpt"
    evidence = delete_checkpoint_file(ckpt, 1, random.Random(1))
    assert os.path.basename(evidence["path"]) == "state.pt"
    assert os.listdir(os.path.join(ckpt, "1")) == []
    r2 = train(dataclasses.replace(cfg, epochs=3), resume_dir=ckpt,
               device="cpu")
    assert r2.history[0]["epoch"] == 1  # resumed from generation 0
    assert latest_step(ckpt) == 2
    assert sorted(os.listdir(os.path.join(ckpt, "quarantine-1"))) == [
        "1", "digest-1.json", "schedule-1.json"]
    assert os.listdir(os.path.join(ckpt, "quarantine-1", "1")) == []
    events = read_journal(f"{cfg.savePath}/{cfg.name}_{cfg.model}"
                          "/events.jsonl")
    quarantines = [e for e in events if e["kind"] == "recovery"
                   and e["scope"] == "checkpoint"]
    assert [(e["action"], e["epoch"]) for e in quarantines] == [
        ("quarantine", 1)]
    assert "state.pt: missing" in quarantines[0]["reason"]
    assert verify_checkpoint_digest(ckpt, 1) == []


@pytest.mark.slow
def test_campaign_all_families_pass_invariants(tmp_path):
    """The acceptance campaign: 26 seeded trials spanning every injector
    family, each judged by the pinned invariant suite."""
    result = campaign.run_campaign(range(26), str(tmp_path), log=print,
                                   device="cpu")
    assert result["trials"] == 26
    assert set(result["families"]) == set(campaign.FAMILIES)
    assert result["ok"], result["failed_seeds"]
    for r in result["results"]:
        assert r["restarts_used"] == (1 if r["family"].startswith("kill_")
                                      else 0), r
        if r["family"].startswith("kill_"):
            assert tuple(r["twin_row"]) == invariants.final_epoch_row(
                read_journal(r["journal_path"]))
    assert "verdict: **PASS**" in campaign.render_report(result)


@pytest.mark.slow
def test_shrink_walks_a_failing_spec_back_to_its_defaults(tmp_path,
                                                          monkeypatch):
    """A trial made to fail (the suite told the family charges no restart)
    fails with every parameter: shrink ends at the default schedule."""
    seed = next(s for s in range(6, 200, 14)
                if campaign.schedule_for_seed(s).signal == "TERM"
                and campaign.schedule_for_seed(s).kill_count > 1)
    spec = campaign.schedule_for_seed(seed)
    monkeypatch.setitem(invariants.EXPECTED_RESTARTS, spec.family, 0)
    minimal = campaign.shrink(spec, str(tmp_path), device="cpu")
    assert minimal == campaign.FaultSpec(family=spec.family, seed=seed)
    monkeypatch.setitem(invariants.EXPECTED_RESTARTS, spec.family, 1)
    with pytest.raises(ValueError, match="nothing to shrink"):
        campaign.shrink(minimal, str(tmp_path), device="cpu")
