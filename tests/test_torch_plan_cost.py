"""The port's link-cost model and backend gate against the JAX package's
(``matcha_tpu/plan/cost.py``, ``matcha_tpu/parallel/gossip.py:319-410``,
``matcha_tpu/communicator/decen.py:43``), on the CPU.

Every function here is the same numpy arithmetic on both sides, so every
comparison is exact: the folded plan's hop ledger, the calibrated models,
the fleet wall-clock model, the loaders, and the decision record of
``gossip_backend="auto"`` (the gate's rule and constants are the JAX
package's, so the journaled record is the same on both sides).
"""

import json
import os

import numpy as np
import pytest

from matcha_tpu import topology as jtp
from matcha_tpu.communicator.decen import \
    resolve_gossip_backend as jax_resolve
from matcha_tpu.parallel.gossip import build_folded_plan as jax_folded
from matcha_tpu.plan import cost as jcost
from matcha_tpu.schedule import matcha_schedule as jax_matcha_schedule
from matcha_tpu_torch import topology as tp
from matcha_tpu_torch.communicator.decen import resolve_gossip_backend
from matcha_tpu_torch.parallel.folded import build_folded_plan
from matcha_tpu_torch.plan import cost as pcost
from matcha_tpu_torch.schedule import matcha_schedule

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINK_COSTS = os.path.join(REPO, "benchmarks", "measured_link_costs_ring8.json")
BUDGET_SWEEP = os.path.join(REPO, "benchmarks", "budget_sweep.json")
BENCH_LIVE = os.path.join(REPO, "benchmarks", "bench_live_r4.json")

GRAPHS = {
    "ring16": lambda: tp.decompose(tp.ring_graph(16), 16, seed=0),
    "hypercube16": lambda: tp.decompose(tp.hypercube_graph(16), 16, seed=0),
    "zoo4": lambda: tp.select_graph(4),
}


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("chips", [1, 2, 4, 8])
def test_folded_plan_hop_ledger_equals_jax(graph, chips):
    perms = tp.matchings_to_perms(GRAPHS[graph](), 16)
    got, want = build_folded_plan(perms, chips), jax_folded(perms, chips)
    assert got.hop_accounting() == want.hop_accounting()
    assert np.array_equal(got.matching_hop_units(), want.matching_hop_units())
    assert (got.num_chips, got.rows_per_chip, got.num_matchings,
            got.offsets_used) == (want.num_chips, want.rows_per_chip,
                                  want.num_matchings, want.offsets_used)
    for gm, wm in zip(got.matchings, want.matchings):
        for gp, wp in zip(gm, wm):
            assert gp.offset == wp.offset
            assert np.array_equal(gp.src_local, wp.src_local)
            assert np.array_equal(gp.mask, wp.mask)
    units = pcost.matching_comm_units(GRAPHS[graph](), 16, chips)
    assert np.array_equal(units, jcost.matching_comm_units(
        GRAPHS[graph](), 16, chips))


def test_folded_plan_refuses_an_uneven_fold():
    perms = tp.matchings_to_perms(GRAPHS["ring16"](), 16)
    with pytest.raises(ValueError, match="not divisible"):
        build_folded_plan(perms, 3)


def test_matching_hop_units_ring_hand_check():
    """``tests/test_plan.py:151``: ring-8 on 4 cards (2 rows a card): the
    even matching stays on its cards, the odd one crosses every boundary
    at offsets 1 and 3, one hop each; one card costs nothing."""
    units = pcost.matching_comm_units(tp.select_graph(5), 8, num_chips=4)
    np.testing.assert_allclose(units, [0.0, 2.0])
    for gid in range(6):
        u1 = pcost.matching_comm_units(tp.select_graph(gid),
                                       tp.graph_size(gid), 1)
        assert np.all(u1 == 0.0)


def test_hop_accounting_partitions_all_slots():
    """``tests/test_plan.py:165``: each matching's offset parts serve all N
    slots exactly once, at ``min(d, C − d)`` hops a part."""
    for gid, chips in ((0, 4), (2, 4), (3, 8)):
        size = tp.graph_size(gid)
        perms = tp.matchings_to_perms(tp.select_graph(gid), size)
        for parts in build_folded_plan(perms, chips).hop_accounting():
            assert sum(slots for (_, slots, _) in parts) == size
            for offset, _, hops in parts:
                assert hops == min(offset, chips - offset)


def test_expected_comm_units_equal():
    p = np.array([0.2, 0.7, 0.1])
    u = np.array([0.0, 2.0, 5.0])
    assert pcost.expected_comm_units(p, u) == jcost.expected_comm_units(p, u)
    for mod in (pcost, jcost):
        with pytest.raises(ValueError, match="unit costs"):
            mod.expected_comm_units(p, u[:2])


@pytest.mark.parametrize("samples", [
    [(0.0, 2.0), (1.0, 5.0), (2.0, 8.0)],
    [(0.0, 0.06), (0.0, 0.07)],
    [(0.0, 1.0), (1.0, 0.5)],
    [(0.5, 3.0), (1.5, 2.0), (4.0, 9.0), (2.0, 4.5)],
])
def test_calibrate_cost_model_equals_jax(samples):
    fit = {"note": "x"}
    got = pcost.calibrate_cost_model(samples, source="s", fit=fit)
    want = jcost.calibrate_cost_model(samples, source="s", fit=fit)
    assert got.to_json() == want.to_json()
    assert pcost.CostModel.from_json(got.to_json()) == got
    assert got.step_seconds(3.0) == want.step_seconds(3.0)
    for mod in (pcost, jcost):
        with pytest.raises(ValueError, match="at least one"):
            mod.calibrate_cost_model([])


def test_cost_model_from_measured_link_costs_equals_jax():
    for spe in (None, 4):
        got = pcost.CostModel.from_measured_link_costs(LINK_COSTS, spe)
        want = jcost.CostModel.from_measured_link_costs(LINK_COSTS, spe)
        assert got.to_json() == want.to_json()
    with open(LINK_COSTS) as f:
        data = json.load(f)
    assert pcost.CostModel.from_measured_link_costs(data).to_json() == \
        jcost.CostModel.from_measured_link_costs(data).to_json()
    blind = dict(data, per_matching=[dict(r, identifiable=False)
                                     for r in data["per_matching"]])
    for mod in (pcost, jcost):
        with pytest.raises(ValueError, match="no identifiable"):
            mod.CostModel.from_measured_link_costs(blind)
        with pytest.raises(ValueError, match="link_costs artifact"):
            mod.load_measured_link_costs({"format": "other/1"})


def test_load_measured_comm_times_equals_jax(tmp_path):
    assert pcost.load_measured_comm_times(BUDGET_SWEEP) == \
        jcost.load_measured_comm_times(BUDGET_SWEEP)
    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps({"runs": [{"algorithm": "dpsgd"}]}))
    for mod in (pcost, jcost):
        with pytest.raises(ValueError, match="no MATCHA runs"):
            mod.load_measured_comm_times(str(empty))


@pytest.mark.parametrize("kw", [
    dict(), dict(straggler=3, period=2, slowdown=8.0, seed=5),
    dict(base_s=0.25, jitter=0.0)])
def test_straggler_step_times_equal(kw):
    assert np.array_equal(pcost.straggler_step_times(6, 17, **kw),
                          jcost.straggler_step_times(6, 17, **kw))


@pytest.mark.parametrize("staleness,local_steps", [(1, 1), (2, 1), (4, 1),
                                                   (4, 2), (3, 5)])
def test_simulate_fleet_wallclock_equal(staleness, local_steps):
    t = pcost.straggler_step_times(8, 24, seed=2)
    got = pcost.simulate_fleet_wallclock(t, staleness, local_steps)
    assert got == jcost.simulate_fleet_wallclock(t, staleness, local_steps)
    if (staleness, local_steps) == (1, 1):
        # the same rounds summed in another order
        assert got["bounded_seconds"] == pytest.approx(
            got["barrier_seconds"], rel=1e-12)
    for mod in (pcost, jcost):
        with pytest.raises(ValueError, match="rounds, N"):
            mod.simulate_fleet_wallclock(t[0])


@pytest.mark.parametrize("n", [16, 256, 4095, 4096, 8192])
@pytest.mark.parametrize("measured", [None, 0.5, 0.85, 0.9])
@pytest.mark.parametrize("wire", ["f32", "bf16"])
@pytest.mark.parametrize("dim", [None, 273258])
def test_choose_gossip_backend_record_equals_jax(n, measured, wire, dim):
    kw = dict(dim=dim, wire_dtype=wire, budget=0.5, topology="t",
              measured_vs_ceiling=measured)
    got = pcost.choose_gossip_backend(n, 12, **kw)
    assert got == jcost.choose_gossip_backend(n, 12, **kw)
    forced = n >= pcost.PERM_FORCED_WORKERS
    gated = measured is not None and measured >= pcost.GOSSIP_BACKEND_GATE
    assert got["chosen"] == ("perm" if forced or gated else "dense")


def test_gate_constants_are_the_jax_rule():
    assert pcost.GOSSIP_BACKEND_GATE == jcost.GOSSIP_BACKEND_GATE == 0.85
    assert pcost.PERM_FORCED_WORKERS == jcost.PERM_FORCED_WORKERS == 4096
    for wire in (None, "bf16"):
        assert pcost.gossip_backend_entries(256, 8, 273258, wire) == \
            jcost.gossip_backend_entries(256, 8, 273258, wire)


def _load_both(path):
    out = []
    for mod in (pcost, jcost):
        try:
            out.append(mod.load_measured_vs_ceiling(str(path)))
        except ValueError as e:
            out.append(("ValueError", str(e)))
    return out


def test_load_measured_vs_ceiling_equals_jax(tmp_path):
    """``tests/test_staleness.py:531``'s shapes: a ``{"record": ...}``
    capture, a journal whose ``bench`` events carry roofline reports (the
    newest wins), a raw report, and a perm-only record (refused)."""
    got, want = _load_both(BENCH_LIVE)
    assert got == want and got[0] == pytest.approx(0.8634)
    assert got[1]["backend"] == "fused"
    journal = tmp_path / "events.jsonl"
    journal.write_text("\n".join([
        json.dumps({"kind": "bench", "record": {"roofline": {
            "backend": "dense", "measured_vs_ceiling": 0.5,
            "measured_vs_ceiling_backend": "dense"}}}),
        "not json",
        json.dumps({"kind": "epoch", "epoch": 0}),
        json.dumps({"kind": "bench", "record": {"roofline": {
            "backend": "dense", "measured_vs_ceiling": 0.88,
            "measured_vs_ceiling_backend": "dense"}}}),
    ]))
    got, want = _load_both(journal)
    assert got == want and got[0] == pytest.approx(0.88)
    raw = tmp_path / "roofline.json"
    raw.write_text(json.dumps({"measured_vs_ceiling": 0.53,
                               "measured_vs_ceiling_backend": "fused"}))
    got, want = _load_both(raw)
    assert got == want and got[0] == pytest.approx(0.53)
    perm = tmp_path / "perm.json"
    perm.write_text(json.dumps({"record": {"backend": "perm", "mfu": 0.4}}))
    got, want = _load_both(perm)
    assert got[0] == "ValueError" and got == want
    assert "dense/fused" in got[1]


def _schedules(n=8, budget=0.6):
    port = matcha_schedule(tp.decompose(tp.ring_graph(n), n, seed=0), n,
                           iterations=13, budget=budget, seed=0)
    ref = jax_matcha_schedule(jtp.decompose(jtp.ring_graph(n), n, seed=0), n,
                              iterations=13, budget=budget, seed=0)
    return port, ref


class _Mesh:
    def __init__(self, size):
        self.size = size


@pytest.mark.parametrize("kw", [
    dict(), dict(measured_vs_ceiling=0.91), dict(measured_vs_ceiling=0.5),
    dict(requested="fused"), dict(requested="perm"),
    dict(wire_dtype="bf16", dim=1031),
    dict(mesh=_Mesh(1)), dict(mesh=_Mesh(4))])
def test_resolve_gossip_backend_equals_jax(kw):
    """``tests/test_perm_backend.py:352`` on the port, record for record."""
    port, ref = _schedules()
    mesh = kw.pop("mesh", None)
    got = resolve_gossip_backend(port, mesh, **kw)
    assert got == jax_resolve(ref, mesh, **kw)
    if mesh is None and not kw:
        assert got["chosen"] == "dense" and "measured" in got["reason"]
        assert got["entries"]["perm"]["stream_bytes_per_step"] \
            < got["entries"]["fused"]["stream_bytes_per_step"]
    if kw == {"measured_vs_ceiling": 0.91}:
        assert got["chosen"] == "perm"
