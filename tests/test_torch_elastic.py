"""The port's elastic membership against the JAX package's, on the CPU.

* ``ElasticController``: ``advance``, ``replay_to`` and
  ``reconcile_restored`` over a leave/join/rejoin trace with hysteresis 1,
  under both bootstrap policies: equal views, transitions, α and scale
  (the same numpy on both sides; α within 1e-12 relative).
* ``Schedule.refold_for``: 1e-12 relative.
* One training step with a fault plan and a membership (a vacant slot, a
  dead worker that revives, a NaN emitter, α scaled by 0.8) against the
  JAX ``make_train_step`` on the MLP, in float64 as
  ``tests/test_torch_train.py`` runs the slice (the gossip in float32 on
  both sides): parameters and momentum within 1e-6 absolute, loss and
  disagreement within 1e-6, ``healed`` and ``alive_workers`` equal; the
  vacant slot's rows bitwise their values before the step.
* The boundary surgery (``make_bootstrap_fn``) against the JAX one: f32
  rounding.
* ``train()`` through a membership trace against the JAX ``train()``
  (MLP, 8 workers, graph 5, 3 epochs of 4 steps, from the JAX run's
  initial parameters): ``alive_workers`` equal, loss, disagreement and
  test loss within 3e-7 relative (2.5 float32 ulps; the two sum in other
  orders), the ``membership`` events' masks, α and scale equal.
* A run resumed from the checkpoint written at the shrink is bitwise the
  uninterrupted run, eagerly and with a staleness-2 ring (ring included),
  and the membership sidecar sits beside the checkpoint.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import flatten_like_port, load_into_port, to_numpy
from matcha_tpu import data as jdata
from matcha_tpu import elastic as jel
from matcha_tpu import resilience as jres
from matcha_tpu import topology as jtp
from matcha_tpu.communicator import make_decen as jax_make_decen
from matcha_tpu.elastic.runtime import make_bootstrap_fn as jax_bootstrap_fn
from matcha_tpu.elastic.runtime import membership_arrays as jax_membership
from matcha_tpu.models import select_model as jax_select_model
from matcha_tpu.ops import WorkerFlattener as JaxWorkerFlattener
from matcha_tpu.schedule import matcha_schedule as jax_matcha_schedule
from matcha_tpu.train import TrainConfig as JaxTrainConfig
from matcha_tpu.train import train as jax_train
from matcha_tpu.train.lr import make_lr_schedule as jax_make_lr_schedule
from matcha_tpu.train.state import TrainState as JaxTrainState
from matcha_tpu.train.state import init_train_state as jax_init_train_state
from matcha_tpu.train.state import make_optimizer as jax_make_optimizer
from matcha_tpu.train.state import make_train_step as jax_make_train_step
from matcha_tpu_torch import elastic as el
from matcha_tpu_torch import resilience as res
from matcha_tpu_torch import topology as tp
from matcha_tpu_torch.communicator import make_decen
from matcha_tpu_torch.models import select_model
from matcha_tpu_torch.ops import WorkerFlattener
from matcha_tpu_torch.schedule import matcha_schedule
from matcha_tpu_torch.train import (
    TrainConfig,
    TrainState,
    make_lr_schedule,
    make_optimizer,
    make_train_step,
    train,
)
from matcha_tpu_torch.train.checkpoint import (
    CHECKPOINT_FILE,
    load_membership_sidecar,
)

N, GID, SEED = 8, 5, 3
REL12 = 1e-12
JAX_SCHED = jax_matcha_schedule(jtp.select_graph(GID), N, iterations=40,
                                budget=0.5, seed=SEED)
SCHED = matcha_schedule(tp.select_graph(GID), N, iterations=40, budget=0.5,
                        seed=SEED)
# leave, a fresh join into the spare slot, the leaver's rejoin, a second
# leave, each change one epoch apart (hysteresis 1 defers folds)
CONTROLLER_TRACE = {
    "initial": ["w0", "w1", "w2", "w3", "w4", "w5", "w6"],
    "events": [{"kind": "leave", "epoch": 1, "worker": "w3"},
               {"kind": "join", "epoch": 2, "worker": "fresh"},
               {"kind": "rejoin", "epoch": 3, "worker": "w3"},
               {"kind": "leave", "epoch": 5, "worker": "w1"}],
}


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


# ------------------------------------------------------------ the host half

def _same_transition(got, want):
    assert (got is None) == (want is None)
    if got is None:
        return
    for name in ("old_alive", "new_alive", "joined", "restored"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
    assert (got.epoch, got.trigger, got.replanned) == \
        (want.epoch, want.trigger, want.replanned)
    assert rel_err(got.alpha, want.alpha) <= REL12
    assert rel_err(got.alpha_scale, want.alpha_scale) <= REL12
    assert (got.rho is None) == (want.rho is None)
    if got.rho is not None:
        assert rel_err(got.rho, want.rho) <= REL12


@pytest.mark.parametrize("bootstrap", ["mean", "restore"])
def test_controller_matches_jax(bootstrap):
    ctl = el.ElasticController(el.load_membership_trace(CONTROLLER_TRACE), N,
                               hysteresis=1, bootstrap=bootstrap)
    jctl = jel.ElasticController(jel.load_membership_trace(CONTROLLER_TRACE),
                                 N, hysteresis=1, bootstrap=bootstrap)
    saved = {}
    for epoch in range(7):
        _same_transition(ctl.advance(epoch, SCHED),
                         jctl.advance(epoch, JAX_SCHED))
        assert ctl.view.to_json() == jctl.view.to_json()
        assert np.array_equal(ctl.alive_mask(), jctl.alive_mask())
        saved[epoch] = ctl.view.to_json()
        # idempotent per epoch, as a rollback's retry needs
        assert ctl.advance(epoch, SCHED) is None
    # a resumed controller replays to the same state
    for start in (2, 4, 6):
        r = el.ElasticController(el.load_membership_trace(CONTROLLER_TRACE),
                                 N, hysteresis=1, bootstrap=bootstrap)
        jr = jel.ElasticController(
            jel.load_membership_trace(CONTROLLER_TRACE), N, hysteresis=1,
            bootstrap=bootstrap)
        got, want = r.replay_to(start, SCHED), jr.replay_to(start, JAX_SCHED)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same_transition(g, w)
        assert (r.alpha is None) == (jr.alpha is None)
        if r.alpha is not None:
            assert rel_err(r.alpha, jr.alpha) <= REL12
        assert rel_err(r.alpha_scale, jr.alpha_scale) <= REL12
        # and maps each earlier boundary's rows onto its occupancy
        for epoch, view in saved.items():
            for a, b in zip(r.reconcile_restored(view),
                            jr.reconcile_restored(view)):
                assert np.array_equal(a, b)
        for a, b in zip(r.reconcile_restored(None),
                        jr.reconcile_restored(None)):
            assert np.array_equal(a, b)


def test_views_refuse_like_jax():
    for events in ([{"kind": "leave", "epoch": 0, "worker": "w9"}],
                   [{"kind": "join", "epoch": 0, "worker": "w0"}],
                   [{"kind": "join", "epoch": 0, "worker": "x"}]):
        trace = {"events": events}
        with pytest.raises(ValueError):
            jel.ElasticController(jel.load_membership_trace(trace),
                                  N).advance(0, JAX_SCHED)
        with pytest.raises(ValueError):
            el.ElasticController(el.load_membership_trace(trace),
                                 N).advance(0, SCHED)
    with pytest.raises(ValueError, match="pool_size"):
        el.ElasticController(el.load_membership_trace({"events": []}),
                             N).reconcile_restored(
            el.MembershipView.full(4).to_json())


@pytest.mark.parametrize("mask", ["full", "one_out", "three_out", "two_left"])
def test_refold_for_matches_jax(mask):
    alive = {"full": np.ones(N), "one_out": np.eye(N)[3] == 0,
             "three_out": np.array([1, 0, 1, 0, 1, 1, 0, 1]),
             "two_left": np.eye(N)[0] + np.eye(N)[4]}[mask]
    got = SCHED.refold_for(np.asarray(alive, np.float32))
    want = JAX_SCHED.refold_for(np.asarray(alive, np.float32))
    for a, b in zip(got, want):
        assert rel_err(a, b) <= REL12


# --------------------------------------------- one step against make_train_step

STEPS, B = 3, 4
STEP_PLAN = [dict(kind="dead", worker=4, start=0, stop=2),
             dict(kind="nan", worker=1, start=1)]
MEMBER = np.array([1, 1, 1, 1, 1, 1, 0, 1], np.float32)  # slot 6 vacant
ALPHA_SCALE = 0.8
TOL = dict(rtol=0, atol=1e-6)


def _batches():
    ds = jdata.synthetic_classification(num_train=256, num_test=32,
                                        seed=SEED)
    parts = jdata.partition_indices(256, N, seed=SEED)
    loader = jdata.WorkerBatches(ds.x_train, ds.y_train, parts, B,
                                 seed=SEED)
    return [b for _, b in zip(range(STEPS), loader.epoch(0))], ds


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


@pytest.fixture(scope="module")
def jax_step_run():
    batches, ds = _batches()
    with jax.enable_x64(True):
        comm = jax_make_decen(JAX_SCHED, backend="gather")
        lr = jax_make_lr_schedule(0.1, 8, warmup=False)
        opt = jax_make_optimizer(lr, 0.9, 5e-4, True)
        model = jax_select_model("mlp", "synthetic", num_classes=10,
                                 dtype=jnp.float64)
        state, _ = jax_init_train_state(model, ds.x_train.shape[1:], N, opt,
                                        comm, seed=0)
        params = _f64(state.params)
        state = state.replace(params=params, opt_state=opt.init(params),
                              membership=jax_membership(MEMBER, ALPHA_SCALE))
        init = to_numpy(params)
        faults = jres.FaultPlan(tuple(jres.FaultEvent(**e)
                                      for e in STEP_PLAN)).compile(
            JAX_SCHED.iterations, N, JAX_SCHED.num_matchings)
        step = jax_make_train_step(model, opt, comm,
                                   JaxWorkerFlattener(params),
                                   JAX_SCHED.flags, lr_schedule=lr,
                                   faults=faults, elastic=True)
        metrics = []
        for xb, yb in batches:
            state, m = step(state, jnp.asarray(xb, jnp.float64),
                            jnp.asarray(yb))
            metrics.append({k: float(v) for k, v in m.items()})
        trace = next(to_numpy(leaf.trace) for leaf in
                     jax.tree_util.tree_leaves(
                         state.opt_state,
                         is_leaf=lambda s: hasattr(s, "trace"))
                     if hasattr(leaf, "trace"))
        return {"batches": batches, "init": init,
                "params": to_numpy(state.params), "momentum": trace,
                "metrics": metrics}


@pytest.fixture(scope="module", params=["perm", "gather"])
def port_step_run(request, jax_step_run):
    comm = make_decen(SCHED, request.param, device="cpu")
    lr = make_lr_schedule(0.1, 8, warmup=False)
    opt = make_optimizer(lr, 0.9, 5e-4, True)
    model = select_model("mlp", "synthetic", num_workers=N,
                         input_shape=(28, 28, 1))
    load_into_port(model, jax_step_run["init"], {}).to(torch.float64)
    state = TrainState(model=model, optimizer=opt.init(model.parameters()),
                       comm_carry=(), step=0,
                       membership=el.membership_arrays(MEMBER, ALPHA_SCALE))
    flattener = WorkerFlattener(state.params)
    before = flattener.flatten(state.params)[6].clone()
    faults = res.FaultPlan(tuple(res.FaultEvent(**e)
                                 for e in STEP_PLAN)).compile(
        SCHED.iterations, N, SCHED.num_matchings)
    step = make_train_step(opt, comm, flattener, SCHED.flags, lr,
                           faults=faults, elastic=True)
    metrics = []
    for xb, yb in jax_step_run["batches"]:
        state, m = step(state, torch.from_numpy(xb).to(torch.float64),
                        torch.from_numpy(yb).long())
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics, before, flattener


def test_faulted_elastic_step_params_match_jax(jax_step_run, port_step_run):
    state, _, before, flattener = port_step_run
    want = flatten_like_port(jax_step_run["params"])
    for name, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], **TOL,
                                   err_msg=name)
    # the vacant slot is frozen bitwise; the others moved
    after = flattener.flatten(state.params)
    assert torch.equal(after[6], before)
    assert torch.isfinite(after).all()


def test_faulted_elastic_step_momentum_matches_jax(jax_step_run,
                                                   port_step_run):
    state, _, _, _ = port_step_run
    want = flatten_like_port(jax_step_run["momentum"])
    for name, p in state.model.named_parameters():
        buf = state.optimizer.state[p]["momentum_buffer"]
        np.testing.assert_allclose(buf.numpy(), want[name], **TOL,
                                   err_msg=name)
        assert not buf[6].any()  # frozen at its (zero) start


def test_faulted_elastic_step_metrics_match_jax(jax_step_run, port_step_run):
    _, metrics, _, _ = port_step_run
    for got, want in zip(metrics, jax_step_run["metrics"]):
        assert set(got) == set(want)
        for key in ("healed", "alive_workers", "active_matchings"):
            assert got[key] == want[key], key
        for key in ("loss", "disagreement", "accuracy"):
            assert abs(got[key] - want[key]) <= TOL["atol"], key
    # step 1: workers 4 (dead) and 6 (vacant) out, worker 1's NaN healed;
    # step 2: worker 4 revives
    assert [m["alive_workers"] for m in metrics] == [6.0, 6.0, 7.0]
    assert [m["healed"] for m in metrics] == [0.0, 1.0, 1.0]


# ----------------------------------------------------- the boundary surgery

def test_bootstrap_matches_jax():
    rng = np.random.default_rng(4)
    model = select_model("mlp", "synthetic", num_workers=N,
                         input_shape=(4,))
    params = {k: rng.normal(size=tuple(v.shape)).astype(np.float32)
              for k, v in model.named_parameters()}
    params["fc1.bias"][5] = np.nan  # a restored row that rotted
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in params.items()})
    opt = make_optimizer(lambda t: 0.1).init(model.parameters())
    for p in model.parameters():
        opt.state[p]["momentum_buffer"] = torch.ones_like(p)
    carry = {"x_hat": torch.ones(N, 3), "s": torch.ones(N, 3)}
    state = TrainState(model=model, optimizer=opt, comm_carry=carry, step=0,
                       mix_pending=torch.ones(N, 3))
    flattener = WorkerFlattener(state.params)
    joined = np.eye(N, dtype=np.float32)[2]
    restored = np.eye(N, dtype=np.float32)[5] + np.eye(N,
                                                       dtype=np.float32)[7]
    donors = np.array([1, 1, 0, 1, 0, 0, 1, 0], np.float32)
    el.make_bootstrap_fn(flattener, N)(state, joined, restored, donors)

    jparams = {"p": {k: jnp.asarray(v) for k, v in params.items()}}
    jstate = JaxTrainState(
        params=jparams, batch_stats={}, opt_state=jparams,
        comm_carry={"x_hat": jnp.ones((N, 3)), "s": jnp.ones((N, 3))},
        step=jnp.zeros((), jnp.int32), mix_pending=jnp.ones((N, 3)))
    out = jax_bootstrap_fn(JaxWorkerFlattener(jparams), N)(
        jstate, jnp.asarray(joined), jnp.asarray(restored),
        jnp.asarray(donors))
    for name, p in model.named_parameters():
        want = np.asarray(out.params["p"][name])
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=0,
                                   atol=2.0 ** -21, err_msg=name)
    # rows 2, 5 and 7 entered: momentum, carry and pending reset
    touched = joined + restored
    for buf in list(res.runtime.momentum_buffers(opt)) + [
            carry["x_hat"], carry["s"], state.mix_pending]:
        rows = buf.reshape(N, -1)
        assert not rows[touched > 0].any() and rows[touched == 0].all()


# -------------------------------------------------- train() through a trace

TRACE = {
    "initial": ["w0", "w1", "w2", "w3", "w4", "w5", "w6"],
    "events": [{"kind": "leave", "epoch": 1, "worker": "w3"},
               {"kind": "join", "epoch": 2, "worker": "fresh"},
               {"kind": "rejoin", "epoch": 2, "worker": "w3"}],
}
BASE = dict(name="elastic", model="mlp", dataset="synthetic",
            dataset_kwargs={"num_train": 256, "num_test": 32},
            num_workers=N, graphid=GID, batch_size=8, epochs=3, lr=0.05,
            warmup=False, matcha=True, budget=0.5, seed=SEED, eval_every=1,
            measure_comm_split=False, gossip_backend="perm")
REL = 3e-7


@pytest.fixture(scope="module")
def churn_pair(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("churn")
    jcfg = dict(BASE, savePath=str(tmp / "jax"), gossip_backend="gather",
                telemetry=False, health=False)
    ref = jax_train(JaxTrainConfig(**jcfg, membership_trace=dict(TRACE),
                                   membership_bootstrap="restore"))
    init = jax_train(JaxTrainConfig(**{**jcfg, "epochs": 0})).state
    params, stats = to_numpy(init.params), to_numpy(init.batch_stats)
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr("matcha_tpu_torch.train.state.init_workers",
                      lambda model, seed: load_into_port(model, params,
                                                         stats))
        port = train(TrainConfig(**BASE, savePath=str(tmp / "port"),
                                 sync_init=False,
                                 membership_trace=dict(TRACE),
                                 membership_bootstrap="restore", save=True),
                     device="cpu")
    return port, ref


def test_churn_train_matches_jax(churn_pair):
    port, ref = churn_pair
    assert [h["alive_workers"] for h in port.history] == \
        [h["alive_workers"] for h in ref.history] == [7.0, 6.0, 8.0]
    for got, want in zip(port.history, ref.history):
        assert set(got) == set(want)
        for key in ("loss", "disagreement", "test_loss_mean"):
            assert rel_err(got[key], want[key]) <= REL, (key, got[key],
                                                         want[key])
    got = [e for e in port.recorder.events if e["kind"] == "membership"]
    want = [e for e in ref.recorder.events if e["kind"] == "membership"]
    assert len(got) == len(want) == 3  # the partial start, 1 and 2
    for g, w in zip(got, want):
        for key in ("epoch", "old_alive", "new_alive", "trigger",
                    "replanned"):
            assert g[key] == w[key], key
        for key in ("alpha", "alpha_scale"):
            assert rel_err(g[key], w[key]) <= REL12
    # the evaluation's gap: the vacant slot 7 in epoch 0, slot 3 in 1
    tacc = port.recorder.data["tacc"]
    assert np.isnan(tacc[0][7]) and np.isnan(tacc[1][3])
    assert np.isfinite(tacc[2]).all()


def _state_tensors(state):
    out = {f"p.{k}": v.detach().clone() for k, v in
           state.model.named_parameters()}
    out.update({f"m.{id(p)}": state.optimizer.state[p]["momentum_buffer"]
                .clone() for p in state.model.parameters()})
    if isinstance(state.mix_pending, torch.Tensor):
        out["mix_pending"] = state.mix_pending.clone()
    return out


@pytest.mark.parametrize("pipeline", [{}, {"overlap": "1step",
                                           "staleness": 2}],
                         ids=["eager", "staleness2"])
def test_resume_through_the_shrink_is_bitwise(tmp_path, pipeline):
    cfg = dict(BASE, **pipeline, savePath=str(tmp_path), name="full",
               membership_trace=dict(TRACE), checkpoint_every=1)
    full = train(TrainConfig(**cfg), device="cpu")
    ckpt = str(tmp_path / "full_ckpt")
    side = load_membership_sidecar(ckpt, 1)
    assert side["view"]["occupants"][3] is None  # w3 left at epoch 1
    assert side["view"]["owners"][3] == "w3"
    assert side["alpha"] > 0 and side["alpha_scale"] > 0
    assert sorted(f for f in os.listdir(ckpt) if f.startswith("member")) == \
        [f"membership-{e}.json" for e in range(3)]
    if pipeline:
        ring1 = torch.load(os.path.join(ckpt, "1", CHECKPOINT_FILE),
                           weights_only=True)["mix_pending"]
        assert ring1.shape[1] == 2 and ring1.any()
    # resume from the checkpoint written at the shrink (end of epoch 1)
    shrink = tmp_path / "at_shrink"
    os.makedirs(shrink / "1")
    for f in ("digest-1.json", "schedule-1.json", "membership-1.json"):
        (shrink / f).write_bytes((tmp_path / "full_ckpt" / f).read_bytes())
    (shrink / "1" / CHECKPOINT_FILE).write_bytes(
        (tmp_path / "full_ckpt" / "1" / CHECKPOINT_FILE).read_bytes())
    resumed = train(TrainConfig(**dict(cfg, name="resumed",
                                       checkpoint_every=0)),
                    resume_dir=str(shrink), device="cpu")
    assert [h["epoch"] for h in resumed.history] == [2]
    want, got = _state_tensors(full.state), _state_tensors(resumed.state)
    assert set(want) != set() and len(want) == len(got)
    for (k, a), b in zip(want.items(), got.values()):
        assert torch.equal(a, b), k
    assert resumed.history[0]["loss"] == full.history[2]["loss"]


def test_membership_live_stays_refused():
    with pytest.raises(NotImplementedError, match="membership_live"):
        TrainConfig(membership_live="runs/health")
    with pytest.raises(ValueError, match="mutually exclusive"):
        TrainConfig(membership_live="runs/health",
                    membership_trace={"events": []})
    assert json.loads(json.dumps(el.load_membership_trace(TRACE).to_json())) \
        == jel.load_membership_trace(TRACE).to_json()
