"""The port's observability plane against the JAX package's, on the CPU:
in-step telemetry, the journal's readers, the composed ρ and the drift
monitor, and ``train()`` with telemetry on.

* ``make_telemetry_spec`` equal; ``telemetry_step`` over the same seeded
  steps (flag rows, disagreements, alive masks, heal and drop counts, the
  ring's consumed ages, per-worker deviations) flushed on both sides:
  steps, matchings, wire bytes, quantized values, alive and heal counts,
  the age histogram and participation exact; the float sums within
  ``TEL_REL`` (float32 sums on both sides).  A zero-step flush equal.
* ``compose_predicted_rho`` within 1e-12 relative (float64 numpy on both
  sides) for f32 and bf16 wire, staleness 1, 2 and ``{1: .5, 2: .5}``,
  local steps, and a fault plan's expectations.
* ``DriftMonitor`` on the same series: the same trips and counters;
  ``drift_report`` equal, re-basing on ``alpha_rederived``.
* ``read_journal_tail``, ``epoch_series``, ``fmt_value`` and
  ``resolve_journal_path`` equal on the same files (a torn tail, blank
  lines, corruption mid-window).
* ``tests/test_obs.py``'s ``ring8_run`` and ``misplan_run`` through both
  ``train()``s from the JAX run's initial parameters: the same event kinds
  in order (the cost ledger's ``compile`` events included, with the same
  labels), the heartbeat's ``peak_bytes`` the ledger's largest so far,
  ``telemetry`` fields within ``TEL_REL`` with the counts exact, the same
  ``drift`` epochs, the same ``predicted`` blocks; and the misplanned run
  through a rollback: ``alpha_rederived`` carries the same re-based
  prediction.
* A checkpoint and a resume with telemetry on.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import load_into_port, to_numpy
from matcha_tpu import obs as jobs
from matcha_tpu.obs import journal as jjournal
from matcha_tpu.obs import telemetry as jtel
from matcha_tpu.topology import matching_laplacians as jax_laplacians
from matcha_tpu.topology import select_graph as jax_select_graph
from matcha_tpu.train import TrainConfig as JaxTrainConfig
from matcha_tpu.train import train as jax_train
from matcha_tpu_torch import obs
from matcha_tpu_torch.obs import journal
from matcha_tpu_torch.obs import telemetry as tel
from matcha_tpu_torch.resilience import FaultEvent, FaultPlan
from matcha_tpu_torch.topology import matching_laplacians, select_graph
from matcha_tpu_torch.train import TrainConfig, train

# float32 sums of float32 values in both packages, in other orders for the
# per-row deviations (one pass over the rows here, XLA's reduction there)
TEL_REL = 1e-5
EXACT = ("steps", "matchings_mean", "wire_bytes", "alive_mean", "alive_min",
         "stale_steps", "stale_dropped", "stale_age_hist", "quantized_values",
         "healed")

# tests/test_obs.py's BASE: ring-8 MATCHA, pure gossip from an unsynced init
BASE = dict(name="obs", model="mlp", dataset="synthetic",
            dataset_kwargs={"num_train": 256, "num_test": 32},
            num_workers=8, graphid=5, batch_size=8, epochs=6, lr=0.0,
            warmup=False, momentum=0.0, weight_decay=0.0, matcha=True,
            budget=0.5, seed=3, save=True, sync_init=False, eval_every=0,
            measure_comm_split=False)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))), 1e-300))


def assert_telemetry_equal(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for key, value in want.items():
        if key in EXACT:
            assert got[key] == value or (np.isnan(got[key])
                                         and np.isnan(value)), key
        elif isinstance(value, (int, float, list)):
            assert rel(got[key], value) <= TEL_REL, (key, got[key], value)
        else:
            assert got[key] == value, key


# ----------------------------------------------------------- the accumulator

def _steps(n: int, m: int, t_steps: int, staleness: int, faulted: bool,
           seed: int = 0):
    """Seeded per-step inputs of ``telemetry_step``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(t_steps):
        step = {"flags_t": (rng.random(m) < 0.6).astype(np.float32),
                "disagreement": np.float32(rng.random()),
                "worker_disagreement": rng.random(n).astype(np.float32)}
        if faulted:
            alive = (rng.random(n) < 0.8).astype(np.float32)
            step.update(worker_alive=alive, alive_count=alive.sum(),
                        healed=np.float32(rng.integers(0, 2)),
                        stale_dropped=np.float32(rng.integers(0, 3)))
        if staleness > 1:
            step["consumed_age"] = rng.integers(
                -1, staleness + 2, n).astype(np.int32)
        out.append(step)
    return out


@pytest.mark.parametrize("wire,overlap,staleness,faulted", [
    ("f32", "off", 1, False), ("bf16", "1step", 1, True),
    ("f32", "1step", 3, False), ("bf16", "1step", 3, True),
])
def test_telemetry_step_and_flush_equal_jax(wire, overlap, staleness,
                                            faulted):
    n, dim = 8, 37
    dec = select_graph(5)
    spec = tel.make_telemetry_spec(dec, dim, wire_dtype=wire,
                                   overlap=overlap, staleness=staleness)
    jspec = jtel.make_telemetry_spec(jax_select_graph(5), dim,
                                     wire_dtype=wire, overlap=overlap,
                                     staleness=staleness)
    assert np.array_equal(spec.wire_bytes_per_matching,
                          jspec.wire_bytes_per_matching)
    assert np.array_equal(spec.wire_values_per_matching,
                          jspec.wire_values_per_matching)
    assert (spec.quantizing, spec.overlap, spec.staleness) == \
        (jspec.quantizing, jspec.overlap, jspec.staleness)
    acc = tel.Telemetry.zeros(n, staleness)
    jacc = jtel.Telemetry.zeros(n, staleness)
    bins = tel.age_bin_table(staleness, "cpu")
    for step in _steps(n, len(dec), 9, staleness, faulted):
        t = {k: torch.as_tensor(v) for k, v in step.items()
             if k != "flags_t"}
        tel.telemetry_step(
            acc, spec, disagreement=t["disagreement"],
            flags_t=step["flags_t"],
            alive_count=t["alive_count"] if faulted else n,
            healed=t.get("healed"), stale_dropped=t.get("stale_dropped"),
            consumed_age=t.get("consumed_age"),
            worker_alive=t.get("worker_alive"),
            worker_disagreement=t["worker_disagreement"], age_bins=bins)
        j = {k: jnp.asarray(v) for k, v in step.items()}
        jacc = jtel.telemetry_step(
            jacc, jspec, disagreement=j["disagreement"],
            flags_t=j["flags_t"],
            alive_count=(j["alive_count"] if faulted
                         else jnp.asarray(np.float32(n))),
            healed=j.get("healed"), stale_dropped=j.get("stale_dropped"),
            consumed_age=j.get("consumed_age"),
            worker_alive=j.get("worker_alive"),
            worker_disagreement=j["worker_disagreement"])
    got, want = tel.telemetry_flush(acc), jtel.telemetry_flush(jacc)
    assert got["worker_participation"] == want["worker_participation"]
    assert_telemetry_equal(got, want)
    # the loop's path: the vector read with the epoch's metrics
    assert tel.telemetry_flush(
        acc, tel.telemetry_tensor(acc).tolist()) == got


def test_zero_step_flush_equals_jax():
    got = tel.telemetry_flush(tel.Telemetry.zeros(4, 2))
    want = jtel.telemetry_flush(jtel.Telemetry.zeros(4, 2))
    assert np.isnan(got["alive_min"]) and np.isnan(want["alive_min"])
    assert_telemetry_equal(got, want)
    assert got["worker_participation"] == want["worker_participation"]


def test_telemetry_step_reads_nothing_back():
    """Every device value of a step is added in place; a read would go
    through ``Tensor.item``/``tolist``/``__bool__``."""
    acc = tel.Telemetry.zeros(4, 2)
    spec = tel.make_telemetry_spec(select_graph(5)[:2], 3, staleness=2)
    inputs = {"disagreement": torch.tensor(0.5),
              "alive_count": torch.tensor(3.0), "healed": torch.tensor(1.0),
              "stale_dropped": torch.tensor(2.0),
              "consumed_age": torch.tensor([-1, 0, 1, 2], dtype=torch.int32),
              "worker_alive": torch.tensor([1.0, 1.0, 0.0, 1.0]),
              "worker_disagreement": torch.ones(4)}
    with pytest.MonkeyPatch.context() as patch:
        for name in ("item", "tolist", "__bool__", "__float__"):
            patch.setattr(torch.Tensor, name, _refuse)
        tel.telemetry_step(acc, spec, flags_t=np.ones(2, np.float32),
                           age_bins=tel.age_bin_table(2, "cpu"), **inputs)
    assert tel.telemetry_flush(acc)["stale_age_hist"] == [2.0, 1.0, 1.0]


def _refuse(*args, **kwargs):
    raise AssertionError("telemetry_step read a device value")


# --------------------------------------------------------- composed ρ, drift

@pytest.mark.parametrize("wire", ["f32", "bf16"])
@pytest.mark.parametrize("staleness,local_steps", [
    (1, 1), (2, 1), ({1: 0.5, 2: 0.5}, 1), (2, 2)])
@pytest.mark.parametrize("faulted", [False, True])
def test_compose_predicted_rho_equals_jax(wire, staleness, local_steps,
                                          faulted):
    dec = select_graph(4)
    Ls = matching_laplacians(dec, 16)
    assert np.array_equal(Ls, np.asarray(jax_laplacians(jax_select_graph(4),
                                                        16)))
    probs = np.linspace(0.3, 0.9, len(dec))
    kw = dict(overlap="1step" if staleness != 1 else "off", wire_dtype=wire,
              staleness=staleness, local_steps=local_steps)
    if faulted:
        plan = FaultPlan((FaultEvent("dead", worker=3, start=0, stop=20),
                          FaultEvent("flaky_link", start=0, drop_prob=0.2,
                                     seed=7)))
        faults = plan.compile(80, 16, len(dec))
        kw.update(worker_alive=np.asarray(faults.expected_alive()),
                  link_up=np.asarray(faults.expected_link_up()))
    got = obs.compose_predicted_rho(Ls, probs, 0.35, **kw)
    want = jobs.compose_predicted_rho(Ls, probs, 0.35, **kw)
    assert set(got) == set(want)
    for key, value in want.items():
        if isinstance(value, float):
            assert rel(got[key], value) <= 1e-12, key
        else:
            assert got[key] == value, key


def test_drift_monitor_band_logic_equals_jax():
    for series in ([0.55 ** e for e in range(8)], [0.97 ** e for e in range(8)],
                   [1.0, 1.2, 1.1, 1.15, 1.12, float("nan"), 1.1, 1.3]):
        ours = obs.DriftMonitor(0.6, 2, tolerance=0.25, patience=2)
        ref = jobs.DriftMonitor(0.6, 2, tolerance=0.25, patience=2)
        got = [ours.observe(e, d) for e, d in enumerate(series)]
        want = [ref.observe(e, d) for e, d in enumerate(series)]
        assert got == want
        assert (ours.checked_total, ours.violations_total, ours.band) == \
            (ref.checked_total, ref.violations_total, ref.band)
    flat = obs.DriftMonitor(0.6, 2, tolerance=0.25, patience=2)
    trips = [flat.observe(e, 0.97 ** e) for e in range(8)]
    assert any(trips)
    for bad in (dict(steps_per_epoch=0), dict(patience=0),
                dict(tolerance=0.0)):
        args = {"rho": 0.5, "steps_per_epoch": 2, **bad}
        with pytest.raises(ValueError):
            obs.DriftMonitor(**args)


def _drift_journal(make_event, with_rederivation: bool):
    """tests/test_obs.py's journal: ρ 0.09 predicted, 0.8 an epoch
    measured, re-derived at epoch 1 to a plan that promises 0.8."""
    events = [make_event("run_start", 0.0, config={},
                         predicted={"rho": 0.09, "steps_per_epoch": 2,
                                    "tolerance": 0.25, "patience": 2})]
    d = 1.0
    for ep in range(6):
        if with_rederivation and ep == 1:
            events.append(make_event(
                "alpha_rederived", float(ep), epoch=ep, old=0.6, new=0.2,
                rho=0.8, predicted={"rho": 0.8}))
        events.append(make_event(
            "telemetry", float(ep), epoch=ep, steps=2.0, disagreement_mean=d,
            disagreement_last=d, wire_bytes=1.0, matchings_mean=1.0,
            alive_mean=8.0))
        d *= 0.8
    return events


def test_drift_report_rebases_on_alpha_rederivation_like_jax():
    for with_rederivation in (False, True):
        events = _drift_journal(journal.make_event, with_rederivation)
        assert events == _drift_journal(jjournal.make_event,
                                        with_rederivation)
        got, want = obs.drift_report(events), jobs.drift_report(events)
        assert got == want
        assert got["consistent"] is with_rederivation
        assert got["rebases"] == int(with_rederivation)
        what_if = obs.drift_report(events, rho=0.09, patience=1)
        assert what_if == jobs.drift_report(events, rho=0.09, patience=1)
        assert not what_if["consistent"]
    with pytest.raises(ValueError, match="run_start prediction"):
        obs.drift_report([])


# ------------------------------------------------------------ journal readers

def test_journal_readers_equal_jax(tmp_path):
    path = tmp_path / "big.jsonl"
    with open(path, "w") as f:
        for i in range(2000):
            f.write(json.dumps({"v": 2, "kind": "telemetry", "t": float(i),
                                "epoch": i % 50, "steps": float(i)}) + "\n")
    for n in (0, 1, 5, 20, 2001):
        for block in (64, 65536):
            got = journal.read_journal_tail(str(path), n, block=block)
            assert got == jjournal.read_journal_tail(str(path), n,
                                                     block=block)
    gappy = tmp_path / "gappy.jsonl"
    gappy.write_text("".join(json.dumps({"v": 2, "kind": "resume",
                                         "t": float(i), "epoch": i})
                             + "\n\n\n" for i in range(10)))
    got = journal.read_journal_tail(str(gappy), 5, block=32)
    assert got == jjournal.read_journal_tail(str(gappy), 5, block=32)
    assert len(got) == 5
    with open(path, "a") as f:  # a writer caught mid-append
        f.write('{"v": 2, "kind": "ep')
    assert journal.read_journal_tail(str(path), 3) == \
        jjournal.read_journal_tail(str(path), 3)
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"v": 1, "kind": "resume", "t": 0.0}\nnot json\n'
                   '{"v": 1, "kind": "resume", "t": 1.0}\n')
    with pytest.raises(ValueError, match="malformed journal line"):
        journal.read_journal_tail(str(bad), 3)
    events = journal.read_journal(str(path), repair=True)
    assert journal.epoch_series(events, "telemetry", "steps") == \
        jjournal.epoch_series(events, "telemetry", "steps")
    assert journal.epoch_series(events, "telemetry", "nope", 1.5) == \
        jjournal.epoch_series(events, "telemetry", "nope", 1.5)
    for v in (None, 0.123456789, 7, "x", 1e-9):
        assert journal.fmt_value(v) == jjournal.fmt_value(v)
        assert journal.fmt_value(v, 3) == jjournal.fmt_value(v, 3)
    run = tmp_path / "run"
    run.mkdir()
    for source in (str(run), str(tmp_path / "missing.jsonl")):
        with pytest.raises(FileNotFoundError):
            journal.resolve_journal_path(source)
        with pytest.raises(FileNotFoundError):
            jjournal.resolve_journal_path(source)
    (run / "events.jsonl").write_text("")
    for source in (str(run), str(path)):
        assert journal.resolve_journal_path(source) == \
            jjournal.resolve_journal_path(source)


# ------------------------------------------------------ train() against JAX

@pytest.fixture(scope="module")
def jax_init():
    init = jax_train(JaxTrainConfig(**{**BASE, "epochs": 0, "save": False},
                                    devices=1, telemetry=False,
                                    health=False)).state
    return to_numpy(init.params), to_numpy(init.batch_stats)


def train_pair(root, jax_init, name, **over):
    """The port's and the JAX ``train()`` on ``BASE`` with ``over``, the
    port from the JAX run's initial parameters; the JAX package's defaults
    (telemetry and health on) on both sides."""
    cfg = dict(BASE, name=name, **over)
    ref = jax_train(JaxTrainConfig(**cfg, savePath=str(root / "jax"),
                                   devices=1))
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr("matcha_tpu_torch.train.state.init_workers",
                      lambda model, seed: load_into_port(model, *jax_init))
        port = train(TrainConfig(**cfg, savePath=str(root / "port")),
                     device="cpu")
    return port, ref


@pytest.fixture(scope="module")
def ring8_pair(tmp_path_factory, jax_init):
    return train_pair(tmp_path_factory.mktemp("ring8"), jax_init, "ring8")


@pytest.fixture(scope="module")
def misplan_pair(tmp_path_factory, jax_init):
    return train_pair(tmp_path_factory.mktemp("misplan"), jax_init,
                      "misplan", alpha_override=0.03)


def journals(port, ref):
    """Both runs' journals as written."""
    got = journal.read_journal(os.path.join(port.recorder.folder,
                                            "events.jsonl"))
    want = jjournal.read_journal(os.path.join(ref.recorder.folder,
                                              "events.jsonl"))
    assert all(jjournal.validate_event(e) == [] for e in got)
    return got, want


def of_kind(events, kind):
    return [e for e in events if e["kind"] == kind]


#: the anomaly causes scored on the host's wall clock: a run on a loaded
#: host may show one that the other package's run did not
HOST_TIME_CAUSES = ("step_time_spike", "comm_time_spike")


def off_clock(events):
    """``events`` without the anomalies whose verdict comes from the wall
    clock (``HOST_TIME_CAUSES``).  The detector that gives them is held
    to JAX's on fixed heartbeat records, both causes included, by
    ``test_anomaly_detector_verdicts_equal_jax`` in
    ``tests/test_torch_health.py``."""
    return [e for e in events if not (e["kind"] == "anomaly"
                                      and e["cause"] in HOST_TIME_CAUSES)]


@pytest.mark.parametrize("pair", ["ring8_pair", "misplan_pair"])
def test_train_journals_what_jax_journals(request, pair):
    port, ref = request.getfixturevalue(pair)
    got, want = journals(port, ref)
    assert [e["kind"] for e in off_clock(got)] == \
        [e["kind"] for e in off_clock(want)]
    assert [e["label"] for e in of_kind(got, "compile")] == \
        [e["label"] for e in of_kind(want, "compile")]
    for g, w in zip(of_kind(got, "telemetry"), of_kind(want, "telemetry")):
        strip = lambda e: {k: v for k, v in e.items() if k != "t"}
        assert_telemetry_equal(strip(g), strip(w))
    (g_start,), (w_start,) = of_kind(got, "run_start"), of_kind(want,
                                                               "run_start")
    assert set(g_start["predicted"]) == set(w_start["predicted"])
    for key, value in w_start["predicted"].items():
        assert rel(g_start["predicted"][key], value) <= 1e-12, key
    assert [e["epoch"] for e in of_kind(got, "drift")] == \
        [e["epoch"] for e in of_kind(want, "drift")]
    for g, w in zip(of_kind(got, "heartbeat"), of_kind(want, "heartbeat")):
        assert (g["host"], g["epoch"], g["step"], g["steps"]) == \
            (w["host"], w["epoch"], w["step"], w["steps"])
        # the cost ledger's largest footprint of the programs so far
        seen = got[:got.index(g)]
        assert g["peak_bytes"] == max(e["peak_bytes"]
                                      for e in of_kind(seen, "compile"))
        assert set(g["workers"]) == set(w["workers"])
        for wid, stats in w["workers"].items():
            mine = g["workers"][wid]
            assert (mine["slot"], mine["participation"]) == \
                (stats["slot"], stats["participation"])
            assert rel(mine["disagreement"], stats["disagreement"]) \
                <= TEL_REL
    assert of_kind(off_clock(got), "anomaly") == \
        of_kind(off_clock(want), "anomaly") == []


def test_ring8_is_in_band_and_misplan_drifts(ring8_pair, misplan_pair):
    ring8, _ = ring8_pair
    assert not of_kind(ring8.recorder.events, "drift")
    report = obs.drift_report(journal.read_journal(os.path.join(
        ring8.recorder.folder, "events.jsonl")))
    assert report["consistent"] and report["violations"] == 0
    misplan, ref = misplan_pair
    drift = of_kind(misplan.recorder.events, "drift")
    assert drift and drift[0]["measured_factor"] > drift[0]["predicted_factor"]
    start = of_kind(misplan.recorder.events, "run_start")[0]["predicted"]
    assert start["executed_alpha"] == pytest.approx(0.03)
    assert start["plan_alpha"] > 0.1
    events = journal.read_journal(os.path.join(misplan.recorder.folder,
                                               "events.jsonl"))
    got = obs.drift_report(events)
    want = jobs.drift_report(journals(misplan, ref)[1])
    assert not got["consistent"] and got["journaled"]
    assert [t["epoch"] for t in got["trips"]] == \
        [t["epoch"] for t in want["trips"]]


def test_recovery_rebases_the_drift_monitor_like_jax(tmp_path, jax_init):
    """The misplanned run with a NaN on every worker at step 5 and one
    recovery: the rollback re-derives α (the solved one, in place of the
    override), and ``alpha_rederived`` carries the re-based prediction,
    equal on both sides; the retried epoch's telemetry counts from zero."""
    nan_all = {"events": [{"kind": "nan", "worker": w, "start": 5}
                          for w in range(8)]}
    port, ref = train_pair(tmp_path, jax_init, "rebase", epochs=3,
                           alpha_override=0.03, fault_plan=nan_all,
                           max_recoveries=1)
    got, want = journals(port, ref)
    assert [e["kind"] for e in off_clock(got)] == \
        [e["kind"] for e in off_clock(want)]
    (g,), (w,) = of_kind(got, "alpha_rederived"), of_kind(want,
                                                          "alpha_rederived")
    assert g["epoch"] == w["epoch"] == 1
    assert set(g["predicted"]) == set(w["predicted"])
    for key, value in w["predicted"].items():
        assert rel(g["predicted"][key], value) <= 1e-12, key
    assert g["predicted"]["plan_alpha"] == pytest.approx(g["new"])
    ours, theirs = obs.drift_report(got), jobs.drift_report(want)
    assert ours["rebases"] == theirs["rebases"] == 1
    for key in ("checked_epochs", "violations", "consistent"):
        assert ours[key] == theirs[key], key
    assert [t["epoch"] for t in ours["trips"]] == \
        [t["epoch"] for t in theirs["trips"]]
    assert [e["steps"] for e in of_kind(got, "telemetry")] == [4.0] * 3


def test_telemetry_counts_the_schedule(ring8_pair):
    """steps = batches an epoch; matchings and wire bytes the flag rows'
    sums times the matchings' bytes, exactly."""
    port, _ = ring8_pair
    flags = np.asarray(port.schedule.flags, np.float64)
    dim = sum(p[0].numel() for p in port.state.model.parameters())
    bytes_vec = tel.make_telemetry_spec(port.schedule.decomposed, dim) \
        .wire_bytes_per_matching.astype(np.float64)
    epochs, wire = journal.epoch_series(port.recorder.events, "telemetry",
                                        "wire_bytes")
    _, match = journal.epoch_series(port.recorder.events, "telemetry",
                                    "matchings_mean")
    assert epochs == list(range(BASE["epochs"]))
    for e in epochs:
        rows = flags[e * 4:(e + 1) * 4]
        assert match[e] == rows.sum() / 4.0
        assert wire[e] == float(rows.sum(0) @ bytes_vec)


def test_checkpoint_and_resume_with_telemetry(tmp_path):
    """The accumulator is never checkpointed and starts fresh on resume:
    the resumed epochs journal their telemetry after a ``resume`` event
    whose ``predicted`` is the run's."""
    cfg = TrainConfig(**dict(BASE, name="resume", savePath=str(tmp_path),
                             epochs=2, checkpoint_every=2,
                             dataset_kwargs={"num_train": 64,
                                             "num_test": 32}))
    first = train(cfg, device="cpu")
    result = train(dataclasses.replace(
        cfg, epochs=4, resume=str(tmp_path / "resume_ckpt")), device="cpu")
    events = result.recorder.events
    kinds = [e["kind"] for e in events]
    assert "resume" in kinds and "checkpoint" in kinds
    epochs, steps = journal.epoch_series(events, "telemetry", "steps")
    assert epochs == [0, 1, 2, 3] and all(s == 1.0 for s in steps)
    (resume,) = of_kind(events, "resume")
    assert resume["predicted"] == \
        of_kind(first.recorder.events, "run_start")[0]["predicted"]
    assert isinstance(result.state.telemetry, tel.Telemetry)
