"""The port's autotuner and plan artifact against the JAX package's
(``matcha_tpu/plan/autotune.py``, ``matcha_tpu/plan/artifact.py``), on the
CPU.

The sweep runs the same solvers (numpy copies) on the same inputs, so
the artifacts are compared key by key: exact wherever the value is an
integer, a string or a list of them, and within 1e-12 relative on the
floats (the solvers are the same code; the bar leaves room for nothing
but a reordered sum).  The artifact's format tag is shared, so a plan
written by either package loads in the other.
"""

import json
import math
import os

import pytest

from matcha_tpu.plan import apply_plan as jax_apply_plan
from matcha_tpu.plan import load_plan as jax_load_plan
from matcha_tpu.plan import sweep as jax_sweep
from matcha_tpu.train import TrainConfig as JaxTrainConfig
from matcha_tpu_torch.plan import (
    CostModel,
    PlanArtifact,
    apply_plan,
    load_plan,
    plan_candidate,
    resolve_topology,
    save_plan,
    sweep,
)
from matcha_tpu_torch.train import TrainConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLAN_RING16 = os.path.join(REPO, "benchmarks", "plan_ring16.json")
TOPOLOGIES = [{"graphid": 4}, {"topology": "ring", "num_workers": 12}]
BUDGETS = (0.25, 0.5, 0.75)
SWEEP = dict(seed=7, solver_iters=600, mc_trials=2, mc_steps=30)


@pytest.fixture(scope="module")
def sweeps():
    return (sweep(TOPOLOGIES, BUDGETS, **SWEEP),
            jax_sweep(TOPOLOGIES, BUDGETS, **SWEEP))


def assert_same_json(got, want, where="artifact"):
    """Key by key: exact on everything but floats, 1e-12 relative there."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), where
        for k in want:
            assert_same_json(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_json(g, w, f"{where}[{i}]")
    elif isinstance(want, float):
        assert isinstance(got, float), where
        assert got == pytest.approx(want, rel=1e-12, abs=0), where
    else:
        assert got == want and type(got) is type(want), where


def test_sweep_artifact_equals_jax_key_by_key(sweeps, tmp_path):
    port, ref = sweeps
    assert len(port.candidates) == len(TOPOLOGIES) * len(BUDGETS)
    assert_same_json(port.to_json(), ref.to_json())
    # the JSON as written, too
    save_plan(port, str(tmp_path / "port.json"))
    from matcha_tpu.plan import save_plan as jax_save_plan

    jax_save_plan(ref, str(tmp_path / "jax.json"))
    assert_same_json(json.loads((tmp_path / "port.json").read_text()),
                     json.loads((tmp_path / "jax.json").read_text()))


def test_sweep_ranks_best_first_with_its_own_evidence(sweeps):
    port, _ = sweeps
    scores = [c["predicted_seconds_to_target"] for c in port.candidates]
    finite = [s for s in scores if s is not None]
    assert finite == sorted(finite)
    assert port.chosen == port.candidates[0]
    for c in port.candidates:
        assert c["mc_trials"] == 2 and c["mc_steps"] == 30
        assert c["mc_empirical_rate"] <= c["rho"] * 1.02
        assert not math.isinf(c["rho"])


def test_a_port_artifact_loads_in_both_packages(sweeps, tmp_path):
    port, _ = sweeps
    path = str(tmp_path / "plan.json")
    save_plan(port, path)
    back = load_plan(path)
    assert back == port
    ref = jax_load_plan(path)
    assert (ref.chosen, ref.candidates, ref.cost_model, ref.format) == \
        (port.chosen, port.candidates, port.cost_model, port.format)
    with pytest.raises(ValueError, match="format"):
        PlanArtifact.from_json({"format": "bogus/9", "chosen": {},
                                "target_consensus": 1, "num_chips": 1})


def test_the_committed_plan_applies_alike():
    """``load_plan(benchmarks/plan_ring16.json)`` then ``apply_plan``: the
    same schedule fields on both sides."""
    port = apply_plan(TrainConfig(model="mlp", graphid=0, budget=0.9,
                                  seed=1), load_plan(PLAN_RING16))
    ref = jax_apply_plan(JaxTrainConfig(model="mlp", graphid=0, budget=0.9,
                                        seed=1), jax_load_plan(PLAN_RING16))
    fields = ("graphid", "topology", "num_workers", "matcha", "budget",
              "seed", "model")
    assert [getattr(port, f) for f in fields] == \
        [getattr(ref, f) for f in fields]
    assert port.graphid is None and port.topology == "ring"
    # through config.plan, as train() calls it; no plan leaves it alone
    cfg = TrainConfig(model="mlp", plan=PLAN_RING16)
    assert apply_plan(cfg).num_workers == ref.num_workers
    plain = TrainConfig(model="mlp")
    assert apply_plan(plain) is plain


@pytest.mark.parametrize("spec", TOPOLOGIES)
def test_resolve_topology_and_plan_candidate_equal(spec):
    from matcha_tpu.plan import plan_candidate as jax_plan_candidate
    from matcha_tpu.plan import resolve_topology as jax_resolve_topology

    dec, size, norm = resolve_topology(spec, 3)
    jdec, jsize, jnorm = jax_resolve_topology(spec, 3)
    assert ([sorted(m) for m in dec], size, norm) == \
        ([sorted(m) for m in jdec], jsize, jnorm)
    cm = CostModel(base_step_s=0.5, per_hop_s=2.0, source="hand")
    kw = dict(seed=3, num_chips=2, solver_iters=300, graph_spec=norm)
    got = plan_candidate(dec, size, 0.4, cost_model=cm, **kw)
    from matcha_tpu.plan import CostModel as JaxCostModel

    want = jax_plan_candidate(jdec, jsize, 0.4,
                              cost_model=JaxCostModel(**cm.to_json()), **kw)
    assert_same_json(got, want)


def test_empty_sweep_refuses():
    with pytest.raises(ValueError, match="empty sweep"):
        sweep([{"graphid": 5}], [], solver_iters=10)
