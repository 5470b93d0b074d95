"""The port's resilience against the JAX package's, on the CPU: fault plans,
the self-healing step's primitives, the divergence detector, and
``train()`` under a fault plan and through a rollback.

* The compiled fault arrays of a plan with every event kind: bitwise
  (numpy on both sides, the same draws).  The JSON round trip, the
  expectations and ``without_nan_in`` likewise.
* ``degraded_solver_inputs``, ``degraded_contraction_rho``,
  ``masked_consensus_error`` and ``resolve_degraded_alpha``: 1e-12
  relative (the same numpy; α comes out of the same solver).
* ``heal_and_mask``, ``gossip_quarantined`` and ``begin_mix_quarantined``
  on perm, gather, dense and skip, on a state with a NaN row and an Inf
  row, a dead worker and a revival: within f32 rounding,
  ``2⁻²⁰·max(1, max|ref|)`` (a few ulps: the dense product sums in another
  order), and NaN/Inf exactly where JAX has them.  The port's perm backend
  is held to the JAX gather backend, whose arithmetic it has.
* The detector: a state whose CHOCO carry holds an Inf while its
  parameters are finite is flagged on the same rows as the JAX
  ``state_finite_rows``; ``train()`` calls that function at every epoch
  and raises on such a carry.
* ``train()`` under the chaos plan of ``tests/test_resilience.py:286``
  (MLP, 8 workers, graph 5, 3 epochs; epochs of 4 steps, the plan's steps
  scaled with them) and the rollback of :320, from the JAX run's own
  initial parameters: ``alive_workers``, ``healed`` and the fault events
  equal, loss, disagreement and test loss within ``REL`` relative
  (float32 on both sides, summed in other orders: see ``REL``).  The
  bounded budget of :334 raises.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import load_into_port, to_numpy
from matcha_tpu import resilience as jres
from matcha_tpu.resilience import runtime as jruntime
from matcha_tpu import topology as jtp
from matcha_tpu.communicator import make_decen as jax_make_decen
from matcha_tpu.plan import spectral as jax_spectral
from matcha_tpu.schedule import matcha_schedule as jax_matcha_schedule
from matcha_tpu.train import TrainConfig as JaxTrainConfig
from matcha_tpu.train import train as jax_train
from matcha_tpu_torch import resilience as res
from matcha_tpu_torch import topology as tp
from matcha_tpu_torch.communicator import make_decen
from matcha_tpu_torch.models import select_model
from matcha_tpu_torch.models.layers import init_workers
from matcha_tpu_torch.plan import spectral
from matcha_tpu_torch.resilience import runtime
from matcha_tpu_torch.schedule import matcha_schedule
from matcha_tpu_torch.train import (
    TrainConfig,
    TrainState,
    TrainingDiverged,
    loop,
    make_optimizer,
    train,
)

REPO = Path(__file__).resolve().parent.parent
N, D, GID = 8, 21, 5
JAX_SCHED = jax_matcha_schedule(jtp.select_graph(GID), N, iterations=20,
                                budget=0.75, seed=0)
SCHED = matcha_schedule(tp.select_graph(GID), N, iterations=20, budget=0.75,
                        seed=0)
M = SCHED.num_matchings
EVERY_KIND = [
    dict(kind="dead", worker=2, start=5, stop=9),
    dict(kind="straggler", worker=4, start=0, stop=8, period=4),
    dict(kind="nan", worker=1, start=7),
    dict(kind="nan", worker=6, start=12, stop=15),
    dict(kind="link_down", matching=0, start=3, stop=6),
    dict(kind="link_down", start=16, stop=17),
    dict(kind="flaky_link", start=10, stop=20, drop_prob=0.5, seed=1),
    dict(kind="flaky_link", matching=1, start=0, drop_prob=0.3, seed=4),
]
FAULT_ARRAYS = ("alive", "revive", "nan_inject", "link_up", "dead_alive")
REL12 = 1e-12


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module (see test_torch_overlap.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want))
                 / max(float(np.max(np.abs(want))), 1e-300))


# ------------------------------------------------------------- fault plans

def _plans():
    events = [dict(e) for e in EVERY_KIND]
    return (res.FaultPlan(tuple(res.FaultEvent(**e) for e in events),
                          name="every"),
            jres.FaultPlan(tuple(jres.FaultEvent(**e) for e in events),
                           name="every"))


def test_compiled_fault_arrays_bitwise_like_jax():
    plan, jplan = _plans()
    got, want = plan.compile(20, N, M), jplan.compile(20, N, M)
    for name in FAULT_ARRAYS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert got.any_faults() and want.any_faults()
    assert np.array_equal(got.expected_alive(), want.expected_alive())
    assert np.array_equal(got.expected_link_up(), want.expected_link_up())
    for name in FAULT_ARRAYS:
        assert np.array_equal(getattr(got.without_nan_in(12, 14), name),
                              getattr(want.without_nan_in(12, 14), name))
    assert plan.to_json() == jplan.to_json()


def test_fault_plan_json_and_refusals_like_jax(tmp_path):
    plan, jplan = _plans()
    path = tmp_path / "plan.json"
    path.write_text(__import__("json").dumps(jplan.to_json()))
    assert res.load_fault_plan(str(path)) == plan
    assert res.load_fault_plan(plan.to_json()) == plan
    assert res.load_fault_plan(list(plan.events)).events == plan.events
    for bad in (dict(kind="meteor", start=0), dict(kind="dead", start=0),
                dict(kind="nan", worker=1, start=5, stop=5),
                dict(kind="straggler", worker=1, start=0, period=1),
                dict(kind="flaky_link", start=0, drop_prob=1.5)):
        with pytest.raises(ValueError):
            jres.FaultEvent(**bad)
        with pytest.raises(ValueError):
            res.FaultEvent(**bad)
    with pytest.raises(ValueError, match="out of range"):
        res.FaultPlan((res.FaultEvent("dead", 0, worker=N),)).compile(4, N, M)


# ------------------------------------------------------- the degraded solve

ALIVES = {"full": None, "dead3": [1, 1, 1, 0, 1, 1, 1, 1],
          "fractions": [1, 0.5, 1, 0.75, 1, 0, 1, 0.9]}


@pytest.mark.parametrize("link_up", [None, 0.8, "per_matching"])
@pytest.mark.parametrize("alive", list(ALIVES))
def test_degraded_solver_inputs_match_jax(alive, link_up):
    worker_alive = ALIVES[alive]
    up = (np.linspace(0.5, 1.0, SCHED.num_matchings)
          if link_up == "per_matching" else link_up)
    Ls, p = spectral.degraded_solver_inputs(SCHED.laplacians(), SCHED.probs,
                                            worker_alive, up)
    jLs, jp = jax_spectral.degraded_solver_inputs(
        JAX_SCHED.laplacians(), JAX_SCHED.probs, worker_alive, up)
    assert Ls.shape == jLs.shape
    assert rel_err(Ls, jLs) <= REL12 and rel_err(p, jp) <= REL12
    rho = spectral.degraded_contraction_rho(
        SCHED.laplacians(), SCHED.probs, SCHED.alpha, worker_alive, up)
    jrho = jax_spectral.degraded_contraction_rho(
        JAX_SCHED.laplacians(), JAX_SCHED.probs, JAX_SCHED.alpha,
        worker_alive, up)
    assert rel_err(rho, jrho) <= REL12


def test_masked_consensus_error_matches_jax():
    x = np.random.default_rng(0).normal(size=(N, D))
    for alive in ([1] * N, ALIVES["dead3"], [1] + [0] * (N - 1)):
        assert rel_err(spectral.masked_consensus_error(x, alive),
                       jax_spectral.masked_consensus_error(x, alive)) <= REL12


@pytest.mark.parametrize("member", [None, "dead3"])
def test_resolve_degraded_alpha_matches_jax(member):
    plan, jplan = _plans()
    worker_alive = None if member is None else ALIVES[member]
    got = res.resolve_degraded_alpha(SCHED, plan.compile(20, N, M),
                                     worker_alive=worker_alive)
    want = jres.resolve_degraded_alpha(JAX_SCHED, jplan.compile(20, N, M),
                                       worker_alive=worker_alive)
    for a, b in zip(got, want):
        assert rel_err(a, b) <= REL12


# ------------------------------------------------- the step's primitives

def _poisoned(seed=0):
    """``[N, D]`` with a NaN row (2) and a row holding an Inf (5)."""
    x = np.random.default_rng(seed).normal(size=(N, D)).astype(np.float32)
    x[2] = np.nan
    x[5, 3] = np.inf
    return x


ALIVE_T = np.array([1, 1, 1, 1, 0, 1, 1, 1], np.float32)  # worker 4 dead
REVIVE_T = np.array([0, 0, 0, 0, 0, 0, 1, 0], np.float32)  # 6 revives


def bar(want) -> float:
    finite = np.abs(np.asarray(want))[np.isfinite(want)]
    return 2.0 ** -20 * max(1.0, float(finite.max(initial=0.0)))


def same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=bar(want),
                               equal_nan=True)


@pytest.mark.parametrize("revive", [False, True], ids=["no-revival",
                                                       "revival"])
def test_heal_and_mask_matches_jax(revive):
    x = _poisoned()
    r = REVIVE_T if revive else np.zeros(N, np.float32)
    got = res.heal_and_mask(torch.from_numpy(x), torch.from_numpy(ALIVE_T),
                            torch.from_numpy(r))
    want = jres.heal_and_mask(jnp.asarray(x), jnp.asarray(ALIVE_T),
                              jnp.asarray(r))
    for g, w in zip(got, want):
        same(g, w)
    # rows 2 and 5 (alive, not finite) and the revival are healed
    assert got[2].tolist() == [0, 0, 1, 0, 0, 1, float(revive), 0]


def test_heal_without_quorum_keeps_the_poison_like_jax():
    x = np.full((4, 3), np.nan, np.float32)
    got = res.heal_and_mask(torch.from_numpy(x), torch.ones(4),
                            torch.zeros(4))
    want = jres.heal_and_mask(jnp.asarray(x), jnp.ones(4), jnp.zeros(4))
    for g, w in zip(got, want):
        same(g, w)
    assert float(got[2].sum()) == 0 and not torch.isfinite(got[0]).any()


def _comms(backend):
    """(port communicator, JAX communicator): perm held to JAX gather."""
    port = make_decen(SCHED, backend, device="cpu")
    jax_backend = "gather" if backend == "perm" else backend
    return port, jax_make_decen(JAX_SCHED, backend=jax_backend)


def _healed_input():
    x = _poisoned()
    # a NaN row that stays quarantined: worker 4 is dead and not finite
    x[4] = np.nan
    flat, ok, _, gate = res.heal_and_mask(
        torch.from_numpy(x), torch.from_numpy(ALIVE_T),
        torch.zeros(N))
    return flat, ok, gate


@pytest.mark.parametrize("two_phase", [False, True],
                         ids=["gossip_quarantined", "begin_mix_quarantined"])
@pytest.mark.parametrize("backend", ["perm", "gather", "dense", "skip"])
def test_quarantined_gossip_matches_jax(backend, two_phase):
    comm, jcomm = _comms(backend)
    flat, ok, gate = _healed_input()
    assert not torch.isfinite(flat[4]).all()  # the dead NaN row stays
    row = SCHED.flags[1].astype(np.float32)
    flags = torch.as_tensor(row, device=comm.flags_device(flat.device))
    if two_phase:
        got, _ = res.begin_mix_quarantined(comm.begin_mix, flat, (), flags,
                                           ok, gate=gate)
        want, _ = jruntime.begin_mix_quarantined(
            jcomm.begin_mix, jnp.asarray(flat.numpy()), (), jnp.asarray(row),
            jnp.asarray(ok.numpy()), gate=jnp.asarray(gate.numpy()))
        assert not got[4].any()  # the quarantined row's delta is zero
    else:
        got, _ = res.gossip_quarantined(comm.step, flat, (), flags, ok,
                                        gate=gate)
        want, _ = jres.gossip_quarantined(
            jcomm.step, jnp.asarray(flat.numpy()), (), jnp.asarray(row),
            jnp.asarray(ok.numpy()), gate=jnp.asarray(gate.numpy()))
        # the poison stays in its own row, visible to the detector, and
        # reaches no survivor
        assert torch.isnan(got[4]).all()
        assert torch.isfinite(got[[0, 1, 2, 3, 5, 6, 7]]).all()
    same(got, want)


def test_row_masks_match_jax():
    x = _poisoned()
    inject = np.array([0, 1, 0, 0, 0, 0, 1, 0], np.float32)
    same(res.inject_nan_rows(torch.from_numpy(x), torch.from_numpy(inject)),
         jres.inject_nan_rows(jnp.asarray(x), jnp.asarray(inject)))
    same(res.finite_rows(torch.from_numpy(x)),
         jres.finite_rows(jnp.asarray(x)))
    keep = np.array([1, 1, 0, 1, 1, 0, 1, 1], np.float32)
    carry = {"x_hat": torch.from_numpy(x.copy()),
             "key": torch.arange(16, dtype=torch.uint8)}
    res.mask_worker_rows(carry, torch.from_numpy(keep), N)
    want = jres.mask_worker_rows({"x_hat": jnp.asarray(x)}, jnp.asarray(keep),
                                 N)
    same(carry["x_hat"], want["x_hat"])
    assert torch.equal(carry["key"], torch.arange(16, dtype=torch.uint8))
    stats = np.abs(np.random.default_rng(1).normal(size=(N, 5))).astype(
        np.float32)
    stats[2] = np.nan
    healed = np.eye(N, dtype=np.float32)[2]
    donors = ALIVE_T * (1 - healed)
    got = torch.from_numpy(stats.copy())
    res.heal_worker_stat_rows([got], torch.from_numpy(healed),
                              torch.from_numpy(donors), N)
    same(got, jres.heal_worker_stat_rows(
        {"var": jnp.asarray(stats)}, jnp.asarray(healed),
        jnp.asarray(donors), N)["var"])


# ----------------------------------------------------------- the detector

def _choco_state():
    """A port state and its JAX twin: 4 workers, finite parameters and
    momentum, a CHOCO carry whose ``x̂`` holds an Inf in row 1, a NaN in
    ``s`` row 3, and a stochastic compressor's ``uint8`` generator state."""
    model = select_model("mlp", "synthetic", num_workers=4,
                         input_shape=(32,))
    init_workers(model, 0)
    opt = make_optimizer(lambda t: 0.1).init(model.parameters())
    dim = sum(p[0].numel() for p in model.parameters())
    x_hat, s = torch.zeros(4, dim), torch.zeros(4, dim)
    x_hat[1, 7] = float("inf")
    s[3, 0] = float("nan")
    carry = {"x_hat": x_hat, "s": s,
             "key": torch.Generator().manual_seed(0).get_state()}
    state = TrainState(model=model, optimizer=opt, comm_carry=carry, step=3)
    jstate = {"params": {k: jnp.asarray(v.detach().numpy())
                         for k, v in model.named_parameters()},
              "comm_carry": {"x_hat": jnp.asarray(x_hat.numpy()),
                             "s": jnp.asarray(s.numpy()),
                             "key": jax.random.PRNGKey(0)},
              "step": jnp.asarray(3, jnp.int32)}
    return state, jstate


def test_detector_sees_the_carry_per_worker_like_jax():
    state, jstate = _choco_state()
    got = res.state_finite_rows(state, 4)
    want = np.asarray(jres.state_finite_rows(jstate, 4))
    assert got.dtype == torch.bool and got.shape == (4,)
    assert got.tolist() == want.tolist() == [True, False, True, False]
    assert all(bool(torch.isfinite(p).all())
               for p in state.model.parameters())
    # a momentum buffer without a worker axis would AND into every row;
    # a global Inf poisons them all
    state.comm_carry["scale"] = torch.tensor(float("inf"))
    assert not res.state_finite_rows(state, 4).any()


def _carry_poisoning_select(select, at_call):
    """``select_communicator`` whose CHOCO step writes an Inf into the
    carry's ``x̂`` row 2 at its ``at_call``-th call (after that step: the
    parameters stay finite through the epoch)."""
    calls = [0]

    def wrapped(*args, **kwargs):
        comm = select(*args, **kwargs)

        def step(flat, carry, flags_t, alive=None):
            out, carry = comm.step(flat, carry, flags_t, alive)
            calls[0] += 1
            if calls[0] == at_call:
                carry = dict(carry, x_hat=carry["x_hat"].clone())
                carry["x_hat"][2, 0] = float("inf")
            return out, carry

        return dataclasses.replace(comm, step=step)

    return wrapped


def test_train_halts_on_a_non_finite_carry(monkeypatch):
    cfg = TrainConfig(model="mlp", dataset="synthetic", num_workers=N,
                      graphid=GID, batch_size=16, epochs=2, lr=0.1,
                      warmup=False, communicator="choco", seed=3,
                      dataset_kwargs={"num_train": 256, "num_test": 32},
                      measure_comm_split=False)
    seen = []

    def detector(state, num_workers):
        rows = runtime.state_finite_rows(state, num_workers)
        seen.append(rows.clone())
        return rows

    monkeypatch.setattr(loop, "state_finite_rows", detector)
    monkeypatch.setattr(loop, "select_communicator", _carry_poisoning_select(
        loop.select_communicator, at_call=2))
    with pytest.raises(TrainingDiverged, match="comm carry"):
        train(cfg, device="cpu")
    # epoch 0 (2 steps) ends with the poisoned carry: one read, row 2 bad
    assert len(seen) == 1
    assert seen[0].tolist() == [True, True, False] + [True] * (N - 3)
    assert loop.state_finite_rows is detector
    monkeypatch.undo()
    assert loop.state_finite_rows is runtime.state_finite_rows


# ----------------------------------------------------- train() against JAX

# tests/test_resilience.py's BASE with a quarter of its training set:
# epochs of 4 steps instead of 16, the plans' steps scaled with them
BASE = dict(name="res", model="mlp", dataset="synthetic", num_workers=N,
            graphid=GID, batch_size=16, epochs=3, lr=0.1, warmup=False,
            matcha=True, budget=0.75, seed=3, save=False, eval_every=1,
            measure_comm_split=False,
            dataset_kwargs={"num_train": 512, "num_test": 128})
CHAOS = [dict(kind="dead", worker=3, start=4, stop=8),
         dict(kind="nan", worker=5, start=5),
         dict(kind="flaky_link", start=0, drop_prob=0.2, seed=7)]
ALL_NAN = [dict(kind="nan", worker=w, start=5) for w in range(N)]
# float32 on both sides: the epoch means come out at most one float32 ulp
# apart (1.1e-7 relative at this seed; the two sum in other orders), so
# the bar is 2.5 ulps of a value near 2
REL = 3e-7


@pytest.fixture(scope="module")
def jax_init():
    init = jax_train(JaxTrainConfig(**{**BASE, "epochs": 0},
                                    telemetry=False, health=False)).state
    return to_numpy(init.params), to_numpy(init.batch_stats)


def train_pair(jax_init, events, **over):
    """The port's and the JAX ``train()`` on ``BASE`` with the fault plan
    ``events`` and ``over``, from the JAX run's initial parameters (JAX on
    its gather backend, the port on perm)."""
    ref = jax_train(JaxTrainConfig(
        **BASE, **over, gossip_backend="gather", telemetry=False,
        health=False,
        fault_plan=jres.FaultPlan(tuple(jres.FaultEvent(**e)
                                        for e in events))))
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr("matcha_tpu_torch.train.state.init_workers",
                      lambda model, seed: load_into_port(model, *jax_init))
        port = train(TrainConfig(
            **BASE, **over, gossip_backend="perm", sync_init=False,
            fault_plan=res.FaultPlan(tuple(res.FaultEvent(**e)
                                           for e in events))),
            device="cpu")
    return port, ref


def check_pair(port, ref):
    assert [h["epoch"] for h in port.history] == \
        [h["epoch"] for h in ref.history]
    for got, want in zip(port.history, ref.history):
        assert set(got) == set(want)
        assert got["alive_workers"] == want["alive_workers"]
        assert got["healed"] == want["healed"]
        for key in ("loss", "disagreement", "test_loss_mean"):
            assert np.isfinite(got[key])
            assert rel_err(got[key], want[key]) <= REL, (key, got[key],
                                                         want[key])
    strip = lambda f: {k: v for k, v in f.items()
                       if k not in ("recordtime", "predicted")}
    assert [strip(f) for f in port.recorder.faults] == \
        [strip(f) for f in ref.recorder.faults]


@pytest.fixture(scope="module")
def chaos_pair(jax_init):
    return train_pair(jax_init, CHAOS)


def test_chaos_train_matches_jax(chaos_pair):
    port, ref = chaos_pair
    check_pair(port, ref)
    assert port.history[1]["alive_workers"] == 7.0
    assert port.history[-1]["alive_workers"] == 8.0
    kinds = [f["kind"] for f in port.recorder.faults]
    assert "plan" in kinds and "healed" in kinds


def test_chaos_eval_leaves_nan_gaps(chaos_pair):
    port, ref = chaos_pair
    got = np.asarray(port.recorder.data["tacc"][1])
    want = np.asarray(ref.recorder.data["tacc"][1])
    assert np.isnan(got[3]) and np.isnan(want[3])
    assert np.isfinite(np.delete(got, 3)).all()
    assert np.isfinite(port.history[1]["test_acc_mean"])


def test_rollback_train_matches_jax(jax_init):
    port, ref = train_pair(jax_init, ALL_NAN, max_recoveries=2)
    check_pair(port, ref)
    events = {f["kind"]: f for f in port.recorder.faults}
    assert events["rollback"]["epoch"] == 1
    assert events["rollback"]["lr_scale"] == 0.5
    assert np.isfinite(port.history[-1]["loss"])


def test_recovery_budget_is_bounded():
    plan = res.FaultPlan(tuple(res.FaultEvent("nan", 0, stop=10 ** 6,
                                              worker=w) for w in range(N)))
    cfg = TrainConfig(**{**BASE, "epochs": 2}, fault_plan=plan,
                      max_recoveries=1, gossip_backend="perm")
    with pytest.raises(TrainingDiverged, match="recoveries exhausted"):
        train(cfg, device="cpu")


# ---------------------------------------------------------- config and CLI

def test_config_takes_resilience_and_refuses_live_membership():
    plan = res.FaultPlan(())
    cfg = TrainConfig(fault_plan=plan, max_recoveries=2,
                      membership_trace={"events": []})
    assert cfg.max_recoveries == 2
    with pytest.raises(NotImplementedError, match="membership_live"):
        TrainConfig(membership_live="runs/health")
    for bad in (dict(max_recoveries=-1),
                dict(max_recoveries=1, halt_on_divergence=False),
                dict(recovery_lr_backoff=0.0),
                dict(communicator="none", fault_plan={"events": []}),
                dict(communicator="none", membership_trace={"events": []})):
        with pytest.raises(ValueError):
            JaxTrainConfig(**bad)
        with pytest.raises(ValueError):
            TrainConfig(**bad)


def test_cli_parses_the_resilience_flags():
    sys.path.insert(0, str(REPO))
    try:
        import train_torch
    finally:
        sys.path.remove(str(REPO))
    cfg, device = train_torch.parse_args(
        ["--fault-plan", "plan.json", "--max-recoveries", "2",
         "--recovery-lr-backoff", "0.25", "--membership-trace", "trace.json",
         "--membership-hysteresis", "1", "--membership-bootstrap", "restore",
         "--device", "cpu"])
    assert (cfg.fault_plan, cfg.max_recoveries, cfg.recovery_lr_backoff,
            cfg.membership_trace, cfg.membership_hysteresis,
            cfg.membership_bootstrap, device) == (
        "plan.json", 2, 0.25, "trace.json", 1, "restore", "cpu")
    cfg, _ = train_torch.parse_args([])
    assert (cfg.fault_plan, cfg.max_recoveries, cfg.membership_trace) == \
        (None, 0, None)
    with pytest.raises(SystemExit):
        train_torch.parse_args(["--membership-bootstrap", "zero"])
