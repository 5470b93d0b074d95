"""The port's health plane and live membership against the JAX package's,
on the CPU.

* ``mad_zscores``, ``liveness`` and every ``AnomalyDetector`` verdict
  (dead, straggler, disagreement outlier, step- and comm-time spike) on
  the same records: equal.  Deadline missed is ``liveness``'s.
* ``HeartbeatEmitter``: the record, the EWMA, the clamp and the line on
  disk equal at a fixed clock; ``read_heartbeats`` and
  ``worker_last_seen`` equal, and a concurrent partial append dropped.
* ``LiveMembershipSource`` on the same heartbeat files and clock: the
  same events at every epoch (the grace window from the first poll, the
  ``min_live`` clamp, a stale stranger, a join, the poll cache, the
  capacity deferral, ``seed_replay``), and the controller it drives
  equal to the one the declared trace drives.
* ``tests/test_health.py``'s chaos plan (w3 dead over steps 4–12, w5
  straggling at period 4) through both ``train()``s: the same anomaly
  ``(subject, cause)`` set; and a ``membership_live`` run (w3's newest
  beat an hour stale): the same ``membership`` events, losses within
  ``REL``.
* ``TrainConfig``'s ``membership_live`` validation, like JAX's.
* ``train()`` flushes the telemetry once an epoch from the values of its
  one read, and reads nothing else of the device.
"""

import dataclasses
import json
import os
import time

import numpy as np
import pytest
import torch

from _torch_parity import load_into_port, to_numpy
from matcha_tpu import elastic as jel
from matcha_tpu.obs import anomaly as janomaly
from matcha_tpu.obs import health as jhealth
from matcha_tpu.obs import journal as jjournal
from matcha_tpu.train import TrainConfig as JaxTrainConfig
from matcha_tpu.train import train as jax_train
from matcha_tpu_torch import elastic as el
from matcha_tpu_torch.obs import anomaly, health, journal
from matcha_tpu_torch.train import TrainConfig, train
from matcha_tpu_torch.train import loop as loop_mod

# tests/test_health.py's BASE and chaos plan: ring-8 MATCHA, 4 steps an
# epoch, so a period-4 straggler takes part in a quarter of each epoch
BASE = dict(name="health", model="mlp", dataset="synthetic",
            dataset_kwargs={"num_train": 256, "num_test": 32},
            num_workers=8, graphid=5, batch_size=8, epochs=4, lr=0.05,
            warmup=False, matcha=True, budget=0.5, seed=3, save=True,
            eval_every=0, measure_comm_split=False)
CHAOS_PLAN = {"events": [
    {"kind": "dead", "worker": 3, "start": 4, "stop": 12},
    {"kind": "straggler", "worker": 5, "start": 0, "period": 4},
]}
# the acceptance run's bar (tests/test_torch_acceptance.py)
REL = 1e-4


def _hb(epoch, workers, host="host0", step_time=0.1, comm_time=0.1):
    return {"host": host, "epoch": epoch, "step": (epoch + 1) * 4,
            "step_time": step_time, "step_time_ewma": step_time,
            "comp_time": 0.3, "comm_time": comm_time, "peak_bytes": None,
            "workers": workers}


def _w(participation=1.0, disagreement=0.0, slot=0):
    return {"slot": slot, "participation": participation,
            "disagreement": disagreement}


def _write_hb(health_dir, host, t, workers, epoch=0):
    """A heartbeat line with a chosen absolute time."""
    event = {"v": 3, "kind": "heartbeat", "t": float(t), **_hb(
        epoch, {w: _w(slot=i) for i, w in enumerate(workers)}, host=host)}
    assert journal.validate_event(event) == []
    os.makedirs(health_dir, exist_ok=True)
    with open(health.heartbeat_path(health_dir, host), "a") as f:
        f.write(json.dumps(event) + "\n")


# --------------------------------------------------------------- detectors

def test_mad_zscores_and_liveness_equal_jax():
    rng = np.random.default_rng(0)
    for values in ([1.0, 1.0, 1.0, 1.0, 11.0], [2.0, 2.0, 2.0, 9.0],
                   [5.0] * 6, rng.normal(size=17).tolist(), [3.0]):
        got, want = anomaly.mad_zscores(values), janomaly.mad_zscores(values)
        assert np.array_equal(got, want)
    assert anomaly.mad_zscores([5.0] * 6).tolist() == [0.0] * 6
    seen = {"host0": 100.0, "host1": 10.0, "host2": 500.0}
    for now, deadline in ((130.0, 60.0), (1000.0, 1.0), (0.0, 5.0)):
        assert anomaly.liveness(seen, now, deadline) == \
            janomaly.liveness(seen, now, deadline)
    assert anomaly.liveness(seen, 130.0, 60.0) == {"host1": 120.0}
    assert anomaly.ANOMALY_CAUSES == janomaly.ANOMALY_CAUSES


def _detector_records():
    """Records that convict every heartbeat cause: a dead worker, a
    straggler, a disagreement outlier, then a step-time and a comm-time
    spike over a steady history, and a beat closer to consensus."""
    outlier = {f"w{i}": _w(1.0, 0.001, slot=i) for i in range(7)}
    outlier["w7"] = _w(1.0, 0.05, slot=7)
    converged = dict(outlier, w7=_w(1.0, 0.0, slot=7))
    records = [_hb(0, {"w0": _w(1.0, slot=0), "w1": _w(0.0, slot=1),
                       "w2": _w(0.25, slot=2), "w3": _w(0.95, slot=3)}),
               _hb(1, outlier), _hb(2, converged)]
    records += [_hb(e, {}, host="host1", comm_time=0.05) for e in range(4)]
    records += [_hb(4, {}, host="host1", step_time=1.0),
                _hb(5, {}, host="host1", comm_time=2.0),
                _hb(6, {}, host="host1")]
    return records


def test_anomaly_detector_verdicts_equal_jax():
    ours, ref = anomaly.AnomalyDetector(), janomaly.AnomalyDetector()
    causes = set()
    for record in _detector_records():
        got, want = ours.observe(record), ref.observe(record)
        assert got == want
        causes |= {a["cause"] for a in got}
    assert causes == {"dead", "straggler", "disagreement_outlier",
                      "step_time_spike", "comm_time_spike"}
    for bad in (dict(dead_below=0.9, straggler_below=0.5),
                dict(z_threshold=-1.0), dict(rel_floor=0.5)):
        with pytest.raises(ValueError):
            anomaly.AnomalyDetector(**bad)
        with pytest.raises(ValueError):
            janomaly.AnomalyDetector(**bad)


# ----------------------------------------------------------------- emitter

def test_heartbeat_emitter_equals_jax_at_a_fixed_clock(tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1234.5)
    ours = health.HeartbeatEmitter(str(tmp_path / "port"), ewma_alpha=0.5)
    ref = jhealth.HeartbeatEmitter(str(tmp_path / "jax"), ewma_alpha=0.5)
    beats = [dict(epoch=0, step=4, steps=4.0, epoch_time=0.4, comm_time=0.1,
                  workers={"w0": _w(1.0, 0.01, slot=0)}, peak_bytes=None),
             dict(epoch=1, step=8, steps=4.0, epoch_time=1.2, comm_time=0.2,
                  workers={"w0": _w(1.0, 0.01, slot=0),
                           "w1": _w(0.5, None, slot=1)}, peak_bytes=7e6),
             dict(epoch=2, step=12, steps=0.0, epoch_time=0.4,
                  comm_time=9.0, workers={})]
    for kw in beats:
        assert ours.beat(**kw) == ref.beat(**kw)
    assert ours.path == health.heartbeat_path(str(tmp_path / "port"),
                                              "host0")
    assert open(ours.path).read() == open(ref.path).read()
    events = journal.read_journal(ours.path)
    assert [e["t"] for e in events] == [1234.5] * 3
    assert events[1]["step_time_ewma"] == pytest.approx(0.5 * 0.3 + 0.5 * 0.1)
    assert events[2]["comm_time"] == 0.4 and events[2]["comp_time"] == 0.0
    assert ours.drain_recovery() == ref.drain_recovery() == []
    with pytest.raises(ValueError, match="ewma_alpha"):
        health.HeartbeatEmitter(str(tmp_path), ewma_alpha=0.0)


def test_read_heartbeats_drops_a_concurrent_partial_append(tmp_path):
    hdir = str(tmp_path / "health")
    for host, t0 in (("host0", 100.0), ("host1", 50.0)):
        for e in range(5):
            _write_hb(hdir, host, t0 + e, [f"{host}w{i}" for i in range(3)],
                      epoch=e)
    (tmp_path / "health" / "events.jsonl").write_text(json.dumps(
        {"v": 3, "kind": "heartbeat", "t": 2.5, **_hb(0, {})}) + "\n")
    with open(health.heartbeat_path(hdir, "host0"), "a") as f:
        f.write('{"v": 3, "kind": "heartbeat", "t": 99.0, "host": "ho')
    got, want = health.read_heartbeats(hdir, 10), \
        jhealth.read_heartbeats(hdir, 10)
    assert got == want and sorted(got) == ["host0", "host1"]
    assert [e["epoch"] for e in got["host0"]] == [0, 1, 2, 3, 4]
    assert health.worker_last_seen(got) == jhealth.worker_last_seen(want)
    assert health.worker_last_seen(got)["host1w2"] == 54.0
    assert health._resolve_health_dir(str(tmp_path)) == \
        jhealth._resolve_health_dir(str(tmp_path)) == hdir
    run = tmp_path / "run_only"
    run.mkdir()
    (run / "events.jsonl").write_text("")
    for resolve in (health._resolve_health_dir, jhealth._resolve_health_dir):
        with pytest.raises(FileNotFoundError, match="no health"):
            resolve(str(run))


# --------------------------------------------------- the live membership

class _StubSchedule:
    alpha = 0.5

    def refold_for(self, alive):
        return 0.1 * float(np.sum(alive)), 0.9, None


def _both_sources(hdir, clock, **kw):
    return (el.LiveMembershipSource(hdir, now_fn=lambda: clock[0], **kw),
            jel.LiveMembershipSource(hdir, now_fn=lambda: clock[0], **kw))


def _events(evs):
    return [(e.kind, e.epoch, e.worker) for e in evs]


def test_live_source_equals_jax_and_its_declared_trace(tmp_path):
    hdir = str(tmp_path / "health")
    clock = [10.0]
    ours, ref = _both_sources(hdir, clock, deadline=30.0, min_live=2)
    live_ctl = el.ElasticController(ours, 4)
    jax_ctl = jel.ElasticController(ref, 4)
    declared = el.ElasticController(el.load_membership_trace({"events": [
        {"kind": "leave", "epoch": 2, "worker": "w3"},
        {"kind": "rejoin", "epoch": 3, "worker": "w3"}]}), 4)
    beats = {0: (10.0, ["w0", "w1", "w2", "w3"]),
             1: (20.0, ["w0", "w1", "w2"]),   # w3 silent, age 10 < 30
             2: (55.0, ["w0", "w1", "w2"]),   # age 45 > 30: leave
             3: (65.0, ["w0", "w1", "w2", "w3"])}  # back: rejoin
    for epoch, (now, workers) in beats.items():
        clock[0] = now
        _write_hb(hdir, "host0", now, workers, epoch=epoch)
        for ctl in (live_ctl, jax_ctl, declared):
            ctl.advance(epoch, _StubSchedule())
        assert live_ctl.alive_mask().tolist() == \
            jax_ctl.alive_mask().tolist() == declared.alive_mask().tolist()
        assert _events(ours.at_epoch(epoch)) == _events(ref.at_epoch(epoch))
    assert live_ctl.view.occupants == declared.view.occupants
    assert live_ctl.alpha == declared.alpha == jax_ctl.alpha
    assert _events(ours.as_trace().events) == _events(ref.as_trace().events) \
        == [("leave", 2, "w3"), ("rejoin", 3, "w3")]
    assert ours.horizon() == ref.horizon() == 3


def test_live_source_rules_equal_jax(tmp_path):
    hdir = str(tmp_path / "health")
    clock = [100.0]
    ours, ref = _both_sources(hdir, clock, deadline=10.0, min_live=2)
    for src in (ours, ref):
        with pytest.raises(RuntimeError, match="start_view"):
            src.at_epoch(0)
        src.start_view(4)
    _write_hb(hdir, "host0", 100.0, ["w0", "w1", "w2", "w3"])
    script = [
        (0, 100.0, None),
        (0, 1000.0, None),        # the cache: the boundary is not re-polled
        (1, 1000.0, None),        # all overdue; leaves clamp at min_live
        (2, 1000.0, [("host1", 500.0, ["old_news"]),   # a stale stranger
                     ("host2", 999.0, ["fresh"])]),    # a fresh one joins
        (3, 1000.0, [("host3", 1000.0, ["late", "later", "latest"])]),
    ]
    seen = []
    for epoch, now, writes in script:
        clock[0] = now
        for host, t, workers in writes or ():
            _write_hb(hdir, host, t, workers)
        got, want = _events(ours.at_epoch(epoch)), _events(ref.at_epoch(epoch))
        assert got == want
        seen.append(got)
    assert seen[2] == [("leave", 1, "w0"), ("leave", 1, "w1")]
    assert ("join", 2, "fresh") in seen[3]
    assert all(w != "old_news" for _, _, w in seen[3])
    # the pool holds 4: the third arrival waits for a free slot
    assert [w for k, _, w in seen[4] if k == "join"] == ["late", "later"]
    assert _events(ours.as_trace().events) == _events(ref.as_trace().events)
    # grace from the first poll for a member never heard from
    ours, ref = _both_sources(str(tmp_path / "empty"), clock, deadline=10.0,
                              grace=50.0)
    for now, epoch in ((1040.0, 0), (1080.0, 1), (1095.0, 2)):
        clock[0] = now
        if epoch == 0:
            ours.start_view(3)
            ref.start_view(3)
        assert _events(ours.at_epoch(epoch)) == _events(ref.at_epoch(epoch))
    assert _events(ours.at_epoch(2)) == [("leave", 2, "w0")]
    for bad in (dict(deadline=0.0), dict(min_live=1)):
        with pytest.raises(ValueError):
            el.LiveMembershipSource(hdir, **bad)


def test_live_source_seed_replay_equals_jax(tmp_path):
    hdir = str(tmp_path / "health")
    clock = [1000.0]
    ours, ref = _both_sources(hdir, clock, deadline=30.0)
    _write_hb(hdir, "host0", 1000.0, ["w0", "w1", "w2", "w3"])
    history = [{"v": 2, "kind": "membership", "t": 1.0, "epoch": 1,
                "old_alive": [1, 1, 1, 1], "new_alive": [1, 1, 1, 0],
                "trigger": [{"kind": "leave", "epoch": 1, "worker": "w3"}],
                "alpha": 0.5, "rho": 0.9, "replanned": True}]
    for src in (ours, ref):
        src.start_view(4)
        src.seed_replay(history, upto_epoch=3)
    got = [_events(ours.at_epoch(e)) for e in range(4)]
    assert got == [_events(ref.at_epoch(e)) for e in range(4)]
    assert got == [[], [("leave", 1, "w3")], [], [("rejoin", 3, "w3")]]


# ------------------------------------------------------ train() against JAX

@pytest.fixture(scope="module")
def jax_init():
    init = jax_train(JaxTrainConfig(**{**BASE, "epochs": 0, "save": False},
                                    devices=1, telemetry=False,
                                    health=False)).state
    return to_numpy(init.params), to_numpy(init.batch_stats)


def train_pair(root, jax_init, name, **over):
    """The port's and the JAX ``train()`` on ``BASE`` with ``over`` (the
    JAX package's defaults, telemetry and health on, on both sides), the
    port from the JAX run's initial parameters."""
    cfg = dict(BASE, name=name, **over)
    ref = jax_train(JaxTrainConfig(**cfg, savePath=str(root / "jax"),
                                   devices=1))
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr("matcha_tpu_torch.train.state.init_workers",
                      lambda model, seed: load_into_port(model, *jax_init))
        port = train(TrainConfig(**cfg, savePath=str(root / "port"),
                                 sync_init=False), device="cpu")
    return port, ref


def of_kind(result, kind):
    return [e for e in result.recorder.events if e["kind"] == kind]


@pytest.fixture(scope="module")
def chaos_pair(tmp_path_factory, jax_init):
    return train_pair(tmp_path_factory.mktemp("chaos"), jax_init, "chaos",
                      fault_plan=dict(CHAOS_PLAN))


def test_chaos_run_convicts_what_jax_convicts(chaos_pair):
    port, ref = chaos_pair
    got = {(a["subject"], a["cause"]) for a in of_kind(port, "anomaly")}
    want = {(a["subject"], a["cause"]) for a in of_kind(ref, "anomaly")}
    assert got == want
    assert {("w3", "dead"), ("w5", "straggler")} <= got
    dead = [a for a in of_kind(port, "anomaly") if a["cause"] == "dead"]
    assert {a["epoch"] for a in dead} == {1, 2}
    straggler = [a for a in of_kind(port, "anomaly")
                 if (a["subject"], a["cause"]) == ("w5", "straggler")]
    assert all(a["value"] == 0.25 for a in straggler)
    for g, w in zip(of_kind(port, "heartbeat"), of_kind(ref, "heartbeat")):
        assert {k: s["participation"] for k, s in g["workers"].items()} == \
            {k: s["participation"] for k, s in w["workers"].items()}
    # the heartbeat files alone name the same workers
    by_host = health.read_heartbeats(os.path.join(port.recorder.folder,
                                                  "health"))
    detector = anomaly.AnomalyDetector()
    replayed = {(a["subject"], a["cause"]) for rec in by_host["host0"]
                for a in detector.observe(rec)}
    assert replayed == got


@pytest.fixture(scope="module")
def live_pair(tmp_path_factory, jax_init):
    root = tmp_path_factory.mktemp("live")
    hdir = str(root / "fleet_health")
    now = time.time()
    _write_hb(hdir, "host0", now - 3600.0, [f"w{i}" for i in range(8)],
              epoch=0)
    _write_hb(hdir, "host0", now, [f"w{i}" for i in range(8) if i != 3],
              epoch=1)
    return train_pair(root, jax_init, "live", epochs=2,
                      dataset_kwargs={"num_train": 128, "num_test": 32},
                      membership_live=hdir, membership_deadline=60.0)


def test_membership_live_run_equals_jax(live_pair):
    port, ref = live_pair
    got, want = of_kind(port, "membership"), of_kind(ref, "membership")
    assert len(got) == len(want) == 1 and got[0]["epoch"] == 0
    for key in ("epoch", "old_alive", "new_alive", "trigger", "replanned"):
        assert got[0][key] == want[0][key], key
    assert [t["worker"] for t in got[0]["trigger"]] == ["w3"]
    for key in ("alpha", "alpha_scale", "rho"):
        assert abs(got[0][key] - want[0][key]) <= 1e-12 * abs(want[0][key])
    assert set(got[0]["predicted"]) == set(want[0]["predicted"])
    for key, value in want[0]["predicted"].items():
        assert abs(got[0]["predicted"][key] - value) <= 1e-12 * abs(value)
    for g, w in zip(port.history, ref.history):
        assert g["alive_workers"] == w["alive_workers"] == 7.0
        for key in ("loss", "disagreement"):
            assert abs(g[key] - w[key]) <= REL * abs(w[key]), key
    hb = of_kind(port, "heartbeat")
    assert len(hb) == 2
    assert all(sorted(e["workers"]) == [f"w{i}" for i in range(8) if i != 3]
               for e in hb)


def test_config_membership_live_validation():
    assert TrainConfig(membership_live="x").membership_live == "x"
    for bad, match in ((dict(membership_live="x",
                             membership_trace={"events": []}),
                        "mutually exclusive"),
                       (dict(membership_deadline=0.0), "membership_deadline"),
                       (dict(communicator="none", membership_live="x"),
                        "communicator")):
        with pytest.raises(ValueError, match=match):
            TrainConfig(**bad)
        with pytest.raises(ValueError, match=match):
            JaxTrainConfig(**bad)
    cfg = TrainConfig()
    assert (cfg.telemetry, cfg.health) == (True, True) == \
        (JaxTrainConfig().telemetry, JaxTrainConfig().health)


# --------------------------------------------------- the epoch's one read

def test_train_flushes_once_an_epoch_from_its_one_read(tmp_path,
                                                       monkeypatch):
    """The flush takes the values the loop read with the epoch's metrics
    (it reads nothing itself), once an epoch; from the first epoch on, the
    run's only reads of the device are those ``tolist`` calls, one an
    epoch (the layers' initialisation reads bounds before it)."""
    flushes, reads = [], {"tolist": 0, "item": 0, "cpu": 0, "numpy": 0}
    counting = [False]
    real_flush = loop_mod.telemetry_flush
    real_batches = loop_mod._epoch_batches

    def flush(acc, values=None):
        assert values is not None
        flushes.append(len(values))
        return real_flush(acc, values)

    def batches(*args):
        counting[0] = True
        return real_batches(*args)

    monkeypatch.setattr(loop_mod, "telemetry_flush", flush)
    monkeypatch.setattr(loop_mod, "_epoch_batches", batches)
    cfg = TrainConfig(**dict(BASE, name="reads", savePath=str(tmp_path),
                             epochs=3, fault_plan=dict(CHAOS_PLAN),
                             dataset_kwargs={"num_train": 64,
                                             "num_test": 32}))
    real = {name: getattr(torch.Tensor, name) for name in reads}
    for name in reads:
        def counted(self, *a, _name=name, **kw):
            reads[_name] += counting[0]
            return real[_name](self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, counted)
    result = train(cfg, device="cpu")
    monkeypatch.undo()
    assert len(flushes) == 3
    assert reads == {"tolist": 3, "item": 0, "cpu": 0, "numpy": 0}
    assert [e["epoch"] for e in of_kind(result, "telemetry")] == [0, 1, 2]
    assert len(of_kind(result, "heartbeat")) == 3


def test_cli_takes_the_observability_flags():
    import train_torch

    cfg, _ = train_torch.parse_args([])
    assert (cfg.telemetry, cfg.health, cfg.drift_tolerance,
            cfg.drift_patience, cfg.membership_live,
            cfg.membership_deadline) == (True, True, 0.25, 2, None, 60.0)
    cfg, device = train_torch.parse_args([
        "--no-telemetry", "--no-health", "--drift-tolerance", "0.5",
        "--drift-patience", "3", "--membership-live", "fleet/health",
        "--membership-deadline", "30", "--device", "cpu"])
    assert (cfg.telemetry, cfg.health, cfg.drift_tolerance,
            cfg.drift_patience, cfg.membership_live,
            cfg.membership_deadline, device) == (
        False, False, 0.5, 3, "fleet/health", 30.0, "cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        train_torch.parse_args(["--membership-live", "x",
                                "--membership-trace", "{}"])
