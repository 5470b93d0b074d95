"""The planner's hooks in the port's ``train()`` against the JAX
package's, on the CPU: a plan artifact resolved at entry, the backend
that ``gossip_backend="auto"`` resolves to, and its ``backend`` event.

The run: the MLP on synthetic data, 8 workers, 2 epochs of 4 steps, the
schedule the artifact chose (ring-8, zoo graph 5, from a sweep of two
budgets).  The initial parameters are the JAX run's own (its per-worker
init and sync), loaded into the port as ``tests/test_torch_acceptance.py``
does.  Without a measurement ``auto`` resolves to ``dense`` on both sides;
with ``gossip_measured_vs_ceiling=0.9`` (or the same ratio read from a
file) to ``perm``.  The journals' ``backend`` events are equal, times
left out.

Tolerance of the epoch metrics, and why: both sides compute in float32,
and XLA and PyTorch sum the MLP's products (and the dense backend its
8-term mixing products) in other orders.  At this seed the two runs part
by one float32 ulp of epoch 1's loss (2.2794, where an ulp is 1.05e-7
relative), so the bar is 2.5e-7 relative: 2.5 ulps of a value near 2, as
``tests/test_torch_resilience.py`` holds its runs.
"""

import json
import os
import sys

import numpy as np
import pytest

from _torch_parity import load_into_port, to_numpy
from matcha_tpu.obs.journal import validate_event as jax_validate_event
from matcha_tpu.train import TrainConfig as JaxTrainConfig
from matcha_tpu.train import train as jax_train
from matcha_tpu_torch.obs.journal import read_journal, validate_event
from matcha_tpu_torch.parallel import LAUNCHES
from matcha_tpu_torch.plan import load_plan, save_plan, sweep
from matcha_tpu_torch.train import TrainConfig, train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 2.5e-7
COMMON = dict(model="mlp", dataset="synthetic",
              dataset_kwargs={"num_train": 512, "num_test": 64},
              graphid=None, topology="ring", num_workers=4, budget=0.9,
              seed=1,
              batch_size=16, epochs=2, lr=0.05, warmup=False,
              measure_comm_split=False, save=True, gossip_backend="auto")


@pytest.fixture(scope="module")
def plan_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("plan") / "plan.json")
    save_plan(sweep([{"graphid": 5}], [0.25, 0.5], seed=9001,
                    solver_iters=600), path)
    return path


@pytest.fixture(scope="module")
def jax_init(tmp_path_factory, plan_path):
    """The JAX run's initial parameters under the plan (its per-worker init
    and sync), shared by every pair below."""
    init = jax_train(JaxTrainConfig(
        **dict(COMMON, plan=plan_path, epochs=0, save=False), devices=1,
        telemetry=False, health=False)).state
    return to_numpy(init.params), to_numpy(init.batch_stats)


def _pair(root, plan_path, jax_init, name, **over):
    """The port's and the JAX ``train()`` on ``COMMON`` under the plan,
    from the JAX run's initial parameters; returns both results."""
    cfg = dict(COMMON, plan=plan_path, name=name, **over)
    ref = jax_train(JaxTrainConfig(**cfg, savePath=str(root / "jax"),
                                   devices=1, telemetry=False, health=False))
    params, stats = jax_init
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr("matcha_tpu_torch.train.state.init_workers",
                      lambda model, seed: load_into_port(model, params,
                                                         stats))
        port = train(TrainConfig(**cfg, savePath=str(root / "port"),
                                 sync_init=False), device="cpu")
    return port, ref


def _backend_event(result):
    events = read_journal(os.path.join(result.recorder.folder,
                                       "events.jsonl"))
    (event,) = [e for e in events if e["kind"] == "backend"]
    assert [e["kind"] for e in events[:2]] == ["run_start", "backend"]
    return {k: v for k, v in event.items() if k != "t"}


def _jax_backend_event(result):
    events = [json.loads(line) for line in
              open(os.path.join(result.recorder.folder, "events.jsonl"))]
    (event,) = [e for e in events if e["kind"] == "backend"]
    assert jax_validate_event(event) == []
    return {k: v for k, v in event.items() if k != "t"}


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


@pytest.fixture(scope="module")
def auto_runs(tmp_path_factory, plan_path, jax_init):
    return _pair(tmp_path_factory.mktemp("auto"), plan_path, jax_init,
                 "auto")


@pytest.fixture(scope="module")
def gated_runs(tmp_path_factory, plan_path, jax_init):
    before = LAUNCHES["perm_gossip_dbuf"]
    runs = _pair(tmp_path_factory.mktemp("gated"), plan_path, jax_init,
                 "gated", gossip_measured_vs_ceiling=0.9)
    assert LAUNCHES["perm_gossip_dbuf"] == before  # the CPU: plain version
    return runs


@pytest.mark.parametrize("runs,chosen", [("auto_runs", "dense"),
                                         ("gated_runs", "perm")])
def test_the_backend_event_equals_jax(request, runs, chosen):
    port, ref = request.getfixturevalue(runs)
    got, want = _backend_event(port), _jax_backend_event(ref)
    assert validate_event({**got, "t": 0.0}) == []
    assert got == want
    assert got["requested"] == "auto" and got["chosen"] == chosen


@pytest.mark.parametrize("runs", ["auto_runs", "gated_runs"])
def test_the_plan_set_the_schedule(request, plan_path, runs):
    port, ref = request.getfixturevalue(runs)
    chosen = load_plan(plan_path).chosen
    assert (port.schedule.num_workers, port.schedule.num_matchings) == \
        (chosen["num_workers"], len(chosen["probs"])) == (8, 2)
    assert port.schedule.alpha == pytest.approx(chosen["alpha"])
    np.testing.assert_allclose(port.schedule.probs, chosen["probs"],
                               atol=1e-9)
    assert np.array_equal(port.schedule.flags, np.asarray(ref.schedule.flags))


@pytest.mark.parametrize("runs", ["auto_runs", "gated_runs"])
@pytest.mark.parametrize("key", ["loss", "disagreement", "test_loss_mean"])
def test_epoch_metrics_match_jax(request, runs, key):
    port, ref = request.getfixturevalue(runs)
    assert len(port.history) == len(ref.history) == 2
    for got, want in zip(port.history, ref.history):
        assert np.isfinite(got[key])
        assert _rel(got[key], want[key]) <= REL, (key, got[key], want[key])


def test_the_measured_source_is_read_and_journaled(tmp_path):
    """``tests/test_staleness.py:555`` on the port: a fused ratio past the
    gate, read from a file, picks perm, with its provenance."""
    src = tmp_path / "bench_live.json"
    src.write_text(json.dumps({"record": {"backend": "fused", "mfu": 0.91}}))
    result = train(TrainConfig(**dict(
        COMMON, name="src", savePath=str(tmp_path), epochs=1,
        gossip_measured_source=str(src))), device="cpu")
    event = _backend_event(result)
    assert event["chosen"] == "perm"
    assert event["measured_vs_ceiling"] == pytest.approx(0.91)
    assert event["measured_source"]["path"] == str(src)
    bad = tmp_path / "perm.json"
    bad.write_text(json.dumps({"record": {"backend": "perm", "mfu": 0.95}}))
    with pytest.raises(ValueError, match="dense/fused"):
        train(TrainConfig(**dict(COMMON, name="bad", savePath=str(tmp_path),
                                 gossip_measured_source=str(bad))),
              device="cpu")


def test_an_explicit_backend_and_a_resume_journal_their_decision(tmp_path):
    cfg = dict(COMMON, name="ckpt", savePath=str(tmp_path),
               gossip_backend="gather", checkpoint_every=1)
    train(TrainConfig(**dict(cfg, epochs=1)), device="cpu")
    result = train(TrainConfig(**cfg), device="cpu",
                   resume_dir=str(tmp_path / "ckpt_ckpt"))
    events = read_journal(os.path.join(result.recorder.folder,
                                       "events.jsonl"))
    kinds = [e["kind"] for e in events]
    assert kinds[:2] == ["run_start", "backend"]
    assert kinds[kinds.index("resume") + 1] == "backend"
    for e in events:
        if e["kind"] == "backend":
            assert {k: e[k] for k in ("requested", "chosen", "reason")} == {
                "requested": "gather", "chosen": "gather",
                "reason": "explicit config; no selection ran"}
    # no gossip, no decision
    none = train(TrainConfig(**dict(COMMON, name="none", epochs=1,
                                    savePath=str(tmp_path),
                                    communicator="none")), device="cpu")
    assert "backend" not in [e["kind"] for e in none.recorder.events]


def test_the_cli_round_trip(tmp_path, capsys):
    """``tests/test_plan.py:300`` on the port's entry points: ``plan_torch.py
    sweep`` → ``train_torch.py --plan ... --save`` → ``plan_torch.py verify
    --run-dir``."""
    sys.path.insert(0, REPO)
    try:
        import plan_torch
        import train_torch
    finally:
        sys.path.remove(REPO)
    plan = str(tmp_path / "plan.json")
    assert plan_torch.main(["sweep", "--graphid", "5", "--budgets",
                            "0.25,0.5", "--solver-iters", "400",
                            "--out", plan]) == 0
    swept = json.loads(capsys.readouterr().out)
    assert swept["chosen_budget"] == load_plan(plan).chosen["budget"]
    train_torch.main(["--plan", plan, "--model", "mlp", "--dataset",
                      "synthetic", "--epoch", "3", "--bs", "16", "--lr",
                      "0.05", "--no-matcha", "--numworkers", "3",
                      "--name", "viaplan", "--save", "--savePath",
                      str(tmp_path / "runs"), "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3
    run_dir = str(tmp_path / "runs" / "viaplan_mlp")
    events = read_journal(os.path.join(run_dir, "events.jsonl"))
    assert events[0]["config"]["num_workers"] == 8  # the plan's, not 3
    assert events[1]["kind"] == "backend" and events[1]["chosen"] == "dense"
    code = plan_torch.main(["verify", "--plan", plan, "--run-dir", run_dir,
                            "--steps-per-epoch", "16"])
    report = json.loads(capsys.readouterr().out)
    assert code == (0 if report["consistent"] else 1)
    assert len(report["disagreement"]) == 3
    assert report["budget"] == load_plan(plan).chosen["budget"]
