"""The port's plan verifier, budget swap and elasticity scorer against the
JAX package's (``matcha_tpu/plan/verify.py``, ``matcha_tpu/plan/swap.py``,
``matcha_tpu/elastic/policy.py``), on the CPU.

Each function is the same numpy arithmetic on both sides, so the reports
are compared whole and exactly.  The inputs: the committed Recorder
fixture ``tests/fixtures/recorder_mini`` (read only), a run directory the
port's ``train()`` writes under a fault plan, the schedule of
``tests/test_serve.py``'s configuration, and the churn trace of
``tests/test_elastic.py``, with few trials and solver iterations.
"""

import json
import os

import numpy as np
import pytest

from matcha_tpu.elastic import load_membership_trace as jax_load_trace
from matcha_tpu.elastic.policy import \
    elasticity_artifact as jax_elasticity_artifact
from matcha_tpu.elastic.policy import \
    score_elasticity_policies as jax_score
from matcha_tpu.plan import sweep as jax_sweep
from matcha_tpu.plan import swap as jswap
from matcha_tpu.plan import verify as jverify
from matcha_tpu.topology import select_graph as jax_select_graph
from matcha_tpu.train import TrainConfig as JaxTrainConfig
from matcha_tpu.train.loop import build_schedule as jax_build_schedule
from matcha_tpu_torch import resilience as res
from matcha_tpu_torch.analysis import lint_plan_file
from matcha_tpu_torch.elastic import load_membership_trace
from matcha_tpu_torch.elastic.policy import (
    elasticity_artifact,
    score_elasticity_policies,
)
from matcha_tpu_torch.plan import (
    load_fault_ledger,
    load_recorder_disagreement,
    resolve_budget_swap,
    save_plan,
    sweep,
    verify_against_recorder,
    verify_plan_run,
)
from matcha_tpu_torch.topology import select_graph
from matcha_tpu_torch.train import TrainConfig, build_schedule, train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE_RUN = os.path.join(REPO, "tests", "fixtures", "recorder_mini",
                           "recorder-mini_mlp")


@pytest.fixture(scope="module")
def artifacts():
    """The plan the fixture run matches (graph 0, budget 0.5, seed 9001),
    swept by each package."""
    kw = dict(seed=9001, solver_iters=600)
    return (sweep([{"graphid": 0}], [0.5], **kw),
            jax_sweep([{"graphid": 0}], [0.5], **kw))


def test_load_recorder_disagreement_equals_jax():
    got = load_recorder_disagreement(FIXTURE_RUN)
    assert got.shape == (6,) and (got > 0).all()
    assert np.array_equal(got, jverify.load_recorder_disagreement(
        FIXTURE_RUN))
    for fn in (load_recorder_disagreement,
               jverify.load_recorder_disagreement):
        with pytest.raises(FileNotFoundError, match="disagreement"):
            fn(os.path.join(REPO, "tests"))


def test_verify_plan_run_equals_jax_on_the_fixture(artifacts):
    port, ref = artifacts
    got = verify_plan_run(port, FIXTURE_RUN, steps_per_epoch=4)
    assert got == jverify.verify_plan_run(ref, FIXTURE_RUN, 4)
    series = load_recorder_disagreement(FIXTURE_RUN)
    np.testing.assert_allclose(got["measured_epoch_factors"],
                               series[1:] / series[:-1], rtol=1e-12)
    assert got["floor"] > 0 and got["budget"] == 0.5
    assert 0.0 < got["predicted_epoch_factor"] < 1.0
    assert "faults" not in got
    assert verify_plan_run(port, FIXTURE_RUN, 4, rho=0.3) == \
        jverify.verify_plan_run(ref, FIXTURE_RUN, 4, rho=0.3)


@pytest.mark.parametrize("rho,factor", [(0.64, 0.8), (0.64, 1.2),
                                        (1.2, 0.9)])
def test_verify_against_recorder_equals_jax(rho, factor):
    bound = min(rho, 0.99) ** 2.0
    series = 1e-2 * min(factor * bound, 0.95) ** np.arange(8)
    got = verify_against_recorder(rho, series, 4)
    assert got == jverify.verify_against_recorder(rho, series, 4)
    assert got["consistent"] == (got["violations"] == 0)
    for fn in (verify_against_recorder, jverify.verify_against_recorder):
        with pytest.raises(ValueError, match="2 epochs"):
            fn(0.5, np.array([1.0]), 4)
        with pytest.raises(ValueError, match="floor_quantile"):
            fn(0.5, series, 4, floor_quantile=0.0)


@pytest.fixture(scope="module")
def faulted_run(tmp_path_factory, artifacts):
    """A port run of the fixture's schedule under a fault plan, saved."""
    root = tmp_path_factory.mktemp("faulted")
    plan = res.FaultPlan((res.FaultEvent("dead", 1, stop=3, worker=2),
                          res.FaultEvent("flaky_link", 0, drop_prob=0.2,
                                         seed=7)))
    result = train(TrainConfig(
        name="faulted", model="mlp", dataset="synthetic", num_workers=8,
        graphid=0, batch_size=16, epochs=3, lr=0.05, warmup=False,
        matcha=True, budget=0.5, seed=9001, save=True, savePath=str(root),
        measure_comm_split=False, fault_plan=plan, gossip_backend="perm",
        dataset_kwargs={"num_train": 256, "num_test": 32}), device="cpu")
    return result.recorder.folder


def test_load_fault_ledger_equals_jax_on_a_port_run(faulted_run, tmp_path):
    got = load_fault_ledger(faulted_run)
    assert got == jverify.load_fault_ledger(faulted_run)
    assert got["kind"] == "plan" and len(got["expected_alive"]) == 8
    assert min(got["expected_alive"]) < 1.0
    # the journal alone, as a run directory without faults.json has it
    journal_only = tmp_path / "journal_only"
    journal_only.mkdir()
    with open(os.path.join(faulted_run, "events.jsonl")) as f:
        (journal_only / "events.jsonl").write_text(f.read())
    assert load_fault_ledger(str(journal_only)) == \
        jverify.load_fault_ledger(str(journal_only))
    assert load_fault_ledger(str(tmp_path)) is None


def test_verify_plan_run_degrades_rho_like_jax(faulted_run, artifacts):
    port, ref = artifacts
    got = verify_plan_run(port, faulted_run, steps_per_epoch=2)
    assert got == jverify.verify_plan_run(ref, faulted_run, 2)
    assert got["faults"]["rho_fault_free"] == port.chosen["rho"]
    assert got["rho"] > port.chosen["rho"]


def test_merged_fault_ledgers_equal_jax(tmp_path):
    """A resumed run that changed its plan: elementwise minimum."""
    events = [{"kind": "plan", "name": "a", "expected_alive": [1.0, 0.5],
               "expected_link_up": [0.9], "events": [{"k": 1}]},
              {"kind": "plan", "name": "b", "expected_alive": [0.7, 1.0],
               "expected_link_up": [1.0], "events": [{"k": 2}],
               "recordtime": 5.0}]
    (tmp_path / "faults.json").write_text(json.dumps({"events": events}))
    got = load_fault_ledger(str(tmp_path))
    assert got == jverify.load_fault_ledger(str(tmp_path))
    assert got["expected_alive"] == [0.7, 0.5] and got["name"] == "a+b"


SERVE = dict(name="serve", model="mlp", dataset="synthetic",
             dataset_kwargs={"num_train": 256, "num_test": 32},
             num_workers=8, graphid=5, batch_size=8, epochs=3, lr=0.05,
             warmup=False, matcha=True, budget=0.5, seed=3, save=True,
             eval_every=0, checkpoint_every=1, measure_comm_split=False)


@pytest.mark.parametrize("budget", [0.25, 0.5, 0.9, 0.0])
def test_resolve_budget_swap_equals_jax(budget):
    """``tests/test_serve.py:129``: the swap's knobs, and the first moment
    they reproduce."""
    port = build_schedule(TrainConfig(**SERVE), 10)
    ref = jax_build_schedule(JaxTrainConfig(**SERVE), 10)
    got = resolve_budget_swap(port, budget, iters=600)
    want = jswap.resolve_budget_swap(ref, budget, iters=600)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k
    p_old = np.asarray(port.probs, np.float64)
    alive = p_old > 1e-9
    np.testing.assert_allclose((got["row_scale"] * p_old)[alive],
                               np.asarray(got["probs"])[alive], rtol=1e-12)
    assert got["unreachable"] >= 0


def test_resolve_budget_swap_refuses_like_jax():
    """``tests/test_serve.py:145``'s validation."""
    port = build_schedule(TrainConfig(**SERVE), 10)
    ref = jax_build_schedule(JaxTrainConfig(**SERVE), 10)
    for bad in (1.5, -0.1):
        messages = []
        for fn, sched in ((resolve_budget_swap, port),
                          (jswap.resolve_budget_swap, ref)):
            with pytest.raises(ValueError, match="budget") as err:
                fn(sched, bad)
            messages.append(str(err.value))
        assert messages[0] == messages[1]


TRACE = {
    "initial": ["w0", "w1", "w2", "w3", "w4", "w5", "w6"],
    "events": [
        {"kind": "leave", "epoch": 1, "worker": "w3"},
        {"kind": "join", "epoch": 2, "worker": "fresh"},
        {"kind": "rejoin", "epoch": 3, "worker": "w3"},
    ],
}


def test_elasticity_scorer_and_artifact_equal_jax(tmp_path):
    """``tests/test_elastic.py:495`` on the port, report for report."""
    kw = dict(seed=3, steps_per_epoch=6, trials=2, hysteresis=(0, 2),
              solver_iters=300)
    got = score_elasticity_policies(select_graph(5), 8, 0.5,
                                    load_membership_trace(dict(TRACE)), **kw)
    want = jax_score(jax_select_graph(5), 8, 0.5,
                     jax_load_trace(dict(TRACE)), **kw)
    assert got == want
    pols = got["policies"]
    assert len(pols) == 4
    assert pols == sorted(pols, key=lambda p: p["score"])
    art = elasticity_artifact(got, {"graphid": 5})
    assert art.to_json() == jax_elasticity_artifact(want,
                                                    {"graphid": 5}).to_json()
    path = tmp_path / "elasticity_plan.json"
    save_plan(art, str(path))
    violations, is_plan = lint_plan_file(str(path))
    assert is_plan and violations == []
    assert art.chosen["policy"]["replan"] in ("eager", "hysteresis-2")


def test_restore_equals_mean_without_rejoins():
    trace = load_membership_trace({
        "initial": ["a", "b", "c", "d", "e", "f"],
        "events": [{"kind": "join", "epoch": 1, "worker": "g"}]})
    report = score_elasticity_policies(
        select_graph(5), 8, 0.5, trace, seed=1, steps_per_epoch=4,
        trials=2, hysteresis=(0,), solver_iters=300)
    by_boot = {p["bootstrap"]: p["score"] for p in report["policies"]}
    assert by_boot["mean"] == pytest.approx(by_boot["restore"], rel=1e-12)
