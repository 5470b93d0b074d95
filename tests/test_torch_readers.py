"""The port's journal readers against the JAX package's, on the CPU.

One small port run (ring-8 MLP, 3 epochs, telemetry, health, ``save``
and the comm-split timer on, a CPU profiler window in epoch 1) is read
by both packages:

* ``summarize`` (dicts equal, floats to 1e-12), ``render_summary``,
  ``render_summary_markdown`` and ``render_tail`` (text equal, the same
  source named on both sides); ``compare_sources`` and ``render_compare``;
* ``fleet_status`` at a fixed clock and ``render_watch``;
* ``build_timeline`` / ``timeline_for_run`` (equal, ``validate_trace``
  clean on both sides) and ``render_timeline_summary``;
* ``attribute_run``, ``critical_path_report``, ``render_attribution`` and
  ``link_costs_artifact``.

The planted-cost recipes of the JAX ``tests/test_attribution.py`` give
the same estimates on both sides to 1e-9, and the port's artifact passes
the port's planlint.  ``obs_torch.py`` runs every command on the run in
one subprocess with ``jax`` and ``matcha_tpu`` blocked, each with the
exit code ``obs_tpu.py`` gives on the same arguments.
"""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import obs_tpu
from matcha_tpu.obs import attribution as jattr
from matcha_tpu.obs import health as jhealth
from matcha_tpu.obs import report as jreport
from matcha_tpu.obs import timeline as jtimeline
from matcha_tpu_torch.analysis import lint_link_costs_data, lint_plan_file
from matcha_tpu_torch.obs import attribution, health, report, timeline
from matcha_tpu_torch.obs.journal import (
    make_event,
    read_journal,
    resolve_journal_path,
)
from matcha_tpu_torch.train import TrainConfig, train

REPO = pathlib.Path(__file__).resolve().parents[1]

#: the JAX attribution tests' ring-8 schedule
RING8_CFG = {"graphid": 5, "num_workers": 8, "budget": 0.5, "seed": 3,
             "matcha": True, "topology": "ring"}


def assert_close(got, want, tol=1e-12, where="$"):
    """Equal structures; floats within ``tol`` relative (absolute near 0)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), where
        for k in want:
            assert_close(got[k], want[k], tol, f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close(g, w, tol, f"{where}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        if np.isnan(want):
            assert np.isnan(got), where
        else:
            assert abs(got - want) <= tol * max(abs(want), 1.0), \
                (where, got, want)
    else:
        assert got == want, (where, got, want)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("readers")
    cfg = TrainConfig(
        name="readers", model="mlp", dataset="synthetic",
        dataset_kwargs={"num_train": 128, "num_test": 32}, num_workers=8,
        graphid=5, batch_size=8, epochs=3, lr=0.0, warmup=False,
        momentum=0.0, weight_decay=0.0, budget=0.5, seed=3,
        sync_init=False, eval_every=1, save=True, savePath=str(root),
        measure_comm_split=True, trace_dir=str(root / "trace"))
    result = train(cfg, device="cpu")
    folder = result.recorder.folder
    path = resolve_journal_path(folder)
    return folder, path, read_journal(path), str(root)


def test_summary_tail_and_compare_equal_jax(run):
    folder, path, events, _ = run
    assert {"compile", "heartbeat", "telemetry", "epoch"} <= \
        {e["kind"] for e in events}
    assert_close(report.summarize(events), jreport.summarize(events))
    assert report.render_summary(events, source=path) == \
        jreport.render_summary(events, source=path)
    assert report.render_summary_markdown(events, source=path) == \
        jreport.render_summary_markdown(events, source=path)
    for n in (3, 50):
        assert report.render_tail(events, n=n) == \
            jreport.render_tail(events, n=n)
    sources = [folder, str(REPO / "BENCH_r05.json"),
               str(REPO / "benchmarks" / "measured_link_costs_ring8.json"),
               str(REPO / "MULTICHIP_r05.json"), str(REPO / "nowhere.json")]
    got, want = report.compare_sources(sources), \
        jreport.compare_sources(sources)
    assert_close(got, want)
    for md in (False, True):
        assert report.render_compare(*got, markdown=md) == \
            jreport.render_compare(*want, markdown=md)


def test_fleet_status_and_watch_equal_jax(run):
    folder = run[0]
    # a fixed watch clock a second after the newest heartbeat
    now = 1.0 + max(rec["t"] for recs in health.read_heartbeats(
        str(pathlib.Path(folder) / "health")).values() for rec in recs)
    got = health.fleet_status(folder, now=now)
    want = jhealth.fleet_status(folder, now=now)
    assert_close(got, want)
    assert got["rows"] and not got["flagged"]
    for md in (False, True):
        assert health.render_watch(got, markdown=md) == \
            jhealth.render_watch(want, markdown=md)
    assert health.fleet_verdict(folder, now=now)[0] == \
        jhealth.fleet_verdict(folder, now=now)[0] == 0
    # a day later every host missed its deadline, on both sides
    late = now + 86400.0
    assert health.fleet_verdict(folder, now=late)[0] == \
        jhealth.fleet_verdict(folder, now=late)[0] == 1
    assert health.fleet_verdict(run[3])[0] == \
        jhealth.fleet_verdict(run[3])[0] == 2


def test_timeline_equal_jax_and_valid(run):
    folder, path, events, _ = run
    got, want = timeline.timeline_for_run(folder), \
        jtimeline.timeline_for_run(folder)
    assert_close(got, want)
    assert timeline.validate_trace(got) == [] == \
        jtimeline.validate_trace(want)
    hb = health.read_heartbeats(str(pathlib.Path(folder) / "health"))
    assert_close(timeline.build_timeline(events, hb, source=path),
                 jtimeline.build_timeline(events, hb, source=path))
    assert timeline.render_timeline_summary(got) == \
        jtimeline.render_timeline_summary(want)
    broken = json.loads(json.dumps(got))
    broken["traceEvents"] = [e for e in broken["traceEvents"]
                             if (e.get("args") or {}).get("src")
                             != "journal:0"]
    assert timeline.validate_trace(broken) == \
        jtimeline.validate_trace(broken) != []


def test_attribution_and_critical_path_equal_jax(run):
    events = run[2]
    got, want = attribution.attribute_run(events), \
        jattr.attribute_run(events)
    assert_close(got, want)
    assert got["flags_check"]["consistent"]
    assert_close(attribution.critical_path_report(events),
                 jattr.critical_path_report(events))
    for md in (False, True):
        assert attribution.render_attribution(got, markdown=md) == \
            jattr.render_attribution(want, markdown=md)
    assert_close(attribution.link_costs_artifact(got),
                 jattr.link_costs_artifact(want))
    assert_close(attribution.attribution_event_fields(got),
                 jattr.attribution_event_fields(want))
    for mod in (attribution, jattr):
        with pytest.raises(ValueError, match="run_start"):
            mod.attribute_run([make_event("resume", 0.0, epoch=1)])


# ------------------------------------------- the planted-cost estimator

def planted(mod, theta, base=0.05, spe=4, epochs=12, noise=0.0, seed=0):
    """The JAX tests' synthetic journal: run_start and epoch events whose
    comm seconds are ``base + A·θ`` over the reconstructed design."""
    flags, _, _, _ = mod.reconstruct_schedule_arrays(RING8_CFG,
                                                      epochs * spe + 1)
    a = mod.design_matrix(flags, spe, range(epochs))
    y = base + a @ np.asarray(theta, np.float64)
    if noise:
        y = y + np.random.default_rng(seed).normal(0.0, noise, size=y.shape)
    events = [make_event("run_start", 0.0, config=dict(RING8_CFG),
                         predicted={"steps_per_epoch": spe})]
    for e in range(epochs):
        events.append(make_event(
            "epoch", float(e + 1), epoch=e, epoch_time=1.0,
            comp_time=max(1.0 - float(y[e]), 0.0), comm_time=float(y[e]),
            train_loss=1.0, disagreement=0.1))
    return events


RUNS = {
    "exact": dict(theta=[0.02, 0.06]),
    "noise": dict(theta=[0.03, 0.09], noise=1e-3, epochs=30),
    "two_chips": dict(theta=[0.02, 0.06]),
}
FITS = {
    "clamped": lambda: (np.random.default_rng(5).integers(
        2, 9, size=(12, 2)).astype(float), None),
    "identical": lambda: (np.tile([[2.0, 1.0]], (8, 1)), np.full(8, 0.3)),
    "zero": lambda: (np.array([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]]),
                     np.zeros(3)),
    "collinear": lambda: (np.array([[1., 1., 0.], [2., 2., 1.],
                                    [0., 0., 2.], [3., 3., 1.]]), None),
}


@pytest.mark.parametrize("case", sorted(RUNS))
def test_planted_runs_estimate_like_jax(case, tmp_path):
    kw = RUNS[case]
    chips = 2 if case == "two_chips" else 1
    got = attribution.attribute_run(planted(attribution, **kw),
                                    num_chips=chips)
    want = jattr.attribute_run(planted(jattr, **kw), num_chips=chips)
    assert_close(got, want, tol=1e-9)
    assert got["identifiable"] == [True, True]
    assert got["hop_check_vs_folded_plan"]
    assert got["per_matching_seconds"] == pytest.approx(kw["theta"],
                                                        rel=1e-2)
    artifact = attribution.link_costs_artifact(got)
    assert lint_link_costs_data(artifact, "t.json") == []
    out = tmp_path / "measured_link_costs.json"
    out.write_text(json.dumps(artifact))
    assert lint_plan_file(out) == ([], True)


@pytest.mark.parametrize("case", sorted(FITS))
def test_planted_fits_estimate_like_jax(case):
    a, y = FITS[case]()
    if y is None:
        theta = [3e-4, 2e-4] if a.shape[1] == 2 else [0.1, 0.2, 0.3]
        y = 0.05 + a @ np.array(theta)
        if case == "clamped":
            y = y + np.random.default_rng(5).normal(0, 0.01, len(y))
    got = attribution.estimate_matching_seconds(a, y)
    want = jattr.estimate_matching_seconds(a, y)
    assert_close(got, want, tol=1e-9)
    flags, _, _, _ = attribution.reconstruct_schedule_arrays(RING8_CFG, 9)
    jflags, _, _, _ = jattr.reconstruct_schedule_arrays(RING8_CFG, 9)
    assert np.array_equal(attribution.design_matrix(flags, 4, range(2)),
                          jattr.design_matrix(jflags, 4, range(2)))


# ------------------------------------------------------------ the CLI

BLOCKED_CLI = """
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


def test_obs_torch_runs_every_command_with_jax_blocked(run, tmp_path):
    folder, _, _, root = run
    trace = str(pathlib.Path(root) / "trace")
    commands = [
        ["summary", folder, "--md", str(tmp_path / "s.md")],
        ["tail", folder, "-n", "5"],
        ["drift", folder],
        ["compare", folder, str(REPO / "BENCH_r05.json")],
        ["roofline", "--chip", "cpu", "--workers", "8", "--topology",
         "ring", "--dim", "1000", "--backend", "both"],
        ["capacity", "--chip", "cpu", "--dim", "1000", "--workers", "8"],
        ["profile", trace],
        # a day's deadline: the verdict is the detectors', not the clock's
        ["watch", folder, "--once", "--deadline", "86400"],
        ["health", folder, "--once", "--deadline", "86400"],
        ["attribute", folder, "--out", str(tmp_path / "lc.json")],
        ["timeline", folder, "--out", str(tmp_path / "t.json")],
    ]
    out = subprocess.run(
        [sys.executable, "-c", BLOCKED_CLI, json.dumps(commands)], cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["leaked"] == []
    want = []
    for argv in commands:
        argv = [a.replace(str(tmp_path), str(tmp_path / "jax"))
                for a in argv]
        (tmp_path / "jax").mkdir(exist_ok=True)
        want.append(obs_tpu.main(argv))
    assert result["codes"] == want
    assert result["codes"][6] == 2  # a CPU capture: no device rows
    assert (tmp_path / "s.md").read_text().startswith("# Run journal")
    assert jtimeline.validate_trace(
        json.loads((tmp_path / "t.json").read_text())) == []
    if (tmp_path / "lc.json").exists():
        assert lint_plan_file(tmp_path / "lc.json")[0] == []
