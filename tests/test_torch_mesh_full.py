"""Every ``TrainConfig`` feature on a worker mesh.

The port's mesh here is ``["cpu"] * C``: C virtual cards, as the JAX
tests' devices are 8 forced host devices (``tests/conftest.py``).

* The one-tensor backends over a mesh (``perm``, ``dense``, ``fused``,
  ``gather`` and CHOCO's batched form, gathered onto card 0 for each
  call): ``step``, ``run`` and the masked ``run`` bitwise the one-card
  communicator's for C = 2 and 4, f32 and bf16 wires; ``run_pipelined``
  and ``run_overlapped`` on a ``WorkerBlocks`` (K = 1, 2, 3, with and
  without a survivor mask) bitwise the one-tensor chains.
* The folded heal: ``heal_and_mask`` on a ``WorkerBlocks`` against the
  one-tensor function (masks equal, rows within f32 rounding: the donors'
  mean sums per card first) with a NaN row, a revival, no donors and every
  row dead; the folded batch-norm heal and the (re)join bootstrap the
  same way.
* ``train(devices=4)`` against the JAX ``train(devices=4,
  gossip_backend="shard_map")`` from the JAX run's initial parameters, at
  the mesh's bar (``tests/test_torch_mesh.py``: 1e-4 relative), with
  ``alive_workers``, ``healed`` and the fault records equal.  Each JAX
  run costs seconds of compilation, so the features share three runs:
  the one-step pipeline under ``tests/test_torch_resilience.py``'s chaos
  plan (the port on ``perm``), the staleness-2 ring through
  ``tests/test_torch_elastic.py``'s membership trace (the port on
  ``shard_map``), and the all-NaN plan with one rollback.
* Against the port's one-card run of the same config: the first of those
  (``perm`` on the mesh, K1's plain version here, the pipeline and a
  fault plan), and ``membership_live``.
  The pipelined cases' ``telemetry`` counts (the ring's consumed ages and
  dropped deltas over every card) equal JAX's.
* Resume on the mesh: the staleness-2 run cut after epoch 1 (the ring
  full, a slot vacant) and resumed ends bitwise where the uninterrupted
  run does; a ring saved from 2 virtual cards (the one-card format)
  restores into one card and into 4 virtual cards, eagerly, at one step
  and at staleness 2 and 3, the two bitwise alike.
"""

import dataclasses
import os
import shutil
import time

import jax
import numpy as np
import pytest
import torch

from _torch_parity import load_into_port, to_numpy
from matcha_tpu import resilience as jres
from matcha_tpu.train import TrainConfig as JaxTrainConfig
from matcha_tpu.train import train as jax_train
from matcha_tpu_torch import topology as tp
from matcha_tpu_torch.communicator import make_choco, make_decen
from matcha_tpu_torch.elastic import make_bootstrap_fn
from matcha_tpu_torch.models import select_model
from matcha_tpu_torch.obs import health
from matcha_tpu_torch.parallel import (
    WorkerBlocks,
    gather_workers,
    masked_mean_rows,
    shard_workers,
    worker_mesh,
)
from matcha_tpu_torch.resilience.runtime import (
    heal_and_mask,
    heal_folded_stat_rows,
    heal_worker_stat_rows,
)
from matcha_tpu_torch.schedule import fixed_schedule
from matcha_tpu_torch.train import TrainConfig, train
from matcha_tpu_torch.train.state import (
    MeshTrainState,
    init_mesh_train_state,
    init_train_state,
    make_optimizer,
)

REL = 1e-4
N = 8
BASE = dict(model="mlp", dataset="synthetic", num_workers=N, graphid=5,
            batch_size=16, epochs=3, lr=0.1, warmup=False, matcha=True,
            budget=0.75, seed=3, save=False, eval_every=1,
            measure_comm_split=False, telemetry=False, health=False,
            dataset_kwargs={"num_train": 512, "num_test": 128,
                            "shape": (4, 4, 1)})
CHAOS = [dict(kind="dead", worker=3, start=4, stop=8),
         dict(kind="nan", worker=5, start=5),
         dict(kind="flaky_link", start=0, drop_prob=0.2, seed=7)]
ALL_NAN = [dict(kind="nan", worker=w, start=5) for w in range(N)]
TRACE = {
    "initial": ["w0", "w1", "w2", "w3", "w4", "w5", "w6"],
    "events": [{"kind": "leave", "epoch": 1, "worker": "w3"},
               {"kind": "join", "epoch": 2, "worker": "fresh"},
               {"kind": "rejoin", "epoch": 2, "worker": "w3"}],
}
# (name, config fields, the port's backend on the mesh); the pipelined
# cases count their telemetry (the ring's consumed ages and dropped
# deltas, the healed rows' dropped deltas)
CASES = (
    ("overlap_chaos", dict(overlap="1step", fault_plan=CHAOS,
                           telemetry=True), "perm"),
    ("staleness2_trace", dict(overlap="1step", staleness=2,
                              membership_trace=TRACE,
                              membership_bootstrap="restore",
                              telemetry=True), "shard_map"),
    ("rollback", dict(fault_plan=ALL_NAN, max_recoveries=1, epochs=2),
     "shard_map"),
)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the small products gain nothing from more, and
    beside five other test processes more threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cpu_mesh(cards):
    return worker_mesh(devices=["cpu"] * cards)


def rel(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def random_state(n, d, seed=0):
    return torch.as_tensor(np.random.default_rng(seed).normal(
        size=(n, d)).astype(np.float32))


def bernoulli(steps=6, seed=5):
    return fixed_schedule(tp.select_graph(5), N, iterations=steps,
                          budget=0.6, mode="bernoulli", seed=seed)


# ------------------------------------------ the one-tensor backends, folded

def make_comm(kind, sched, wire, mesh=None):
    if kind == "choco":
        return make_choco(sched, ratio=0.5, wire_dtype=wire, device="cpu",
                          mesh=mesh)
    return make_decen(sched, kind, device="cpu", mesh=mesh,
                      wire_dtype=wire)


def same(got, want) -> bool:
    """``got`` (folded where ``want`` has worker rows) bitwise ``want``."""
    if isinstance(want, dict):
        return set(got) == set(want) and all(same(got[k], want[k])
                                              for k in want)
    if isinstance(want, tuple) and not want:
        return got == ()
    return torch.equal(gather_workers(got), want)


@pytest.mark.parametrize("wire", [None, "bf16"], ids=["f32", "bf16"])
@pytest.mark.parametrize("cards", [2, 4])
@pytest.mark.parametrize("kind", ["perm", "dense", "fused", "gather",
                                  "choco"])
def test_one_tensor_backend_on_a_mesh_is_bitwise_one_card(kind, cards,
                                                          wire):
    sched = bernoulli()
    mesh = cpu_mesh(cards)
    one, folded = make_comm(kind, sched, wire), make_comm(kind, sched, wire,
                                                          mesh)
    assert folded.name == one.name
    x = random_state(N, 37, seed=cards)
    xs = shard_workers(x, mesh)
    row = torch.as_tensor(sched.flags[0], dtype=torch.float32)
    want, want_carry = one.step(x, one.init(x), row)
    got, got_carry = folded.step(xs, folded.init(xs), row)
    assert isinstance(got, WorkerBlocks) and len(got) == cards
    assert [str(b.device) for b in got] == ["cpu"] * cards
    assert same(got, want) and same(got_carry, want_carry)
    flags = np.asarray(sched.flags, np.float32)
    alive = torch.ones(N)
    alive[[2, 5]] = 0.0
    for mask in (None, alive):
        want, want_carry = one.run(x, flags, alive=mask)
        got, got_carry = folded.run(xs, flags, alive=mask)
        assert same(got, want) and same(got_carry, want_carry), mask


@pytest.mark.parametrize("masked", [False, True], ids=["all", "alive"])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_pipelined_chains_on_a_mesh_are_bitwise_one_tensor(k, masked):
    """The folded backend against the gather oracle and the folded perm
    against perm: the drained chain, the visible state and every ring
    slot; at K = 1 ``run_overlapped`` too."""
    sched = bernoulli(steps=7, seed=k)
    mesh = cpu_mesh(4)
    x = random_state(N, 21, seed=k)
    alive = None
    if masked:
        alive = torch.ones(N)
        alive[[1, 6]] = 0.0
    for one, folded in ((make_decen(sched, "gather", device="cpu"),
                         make_decen(sched, "shard_map", mesh=mesh)),
                        (make_decen(sched, "perm", device="cpu"),
                         make_decen(sched, "perm", mesh=mesh))):
        xs = shard_workers(x, mesh)
        want, _ = one.run_pipelined(x, sched.flags, alive=alive, staleness=k)
        got, _ = folded.run_pipelined(xs, sched.flags, alive=alive,
                                      staleness=k)
        assert torch.equal(gather_workers(got), want)
        want_x, _, want_ring = one.run_pipelined(
            x, sched.flags, alive=alive, staleness=k, drain=False)
        got_x, _, got_ring = folded.run_pipelined(
            xs, sched.flags, alive=alive, staleness=k, drain=False)
        assert torch.equal(gather_workers(got_x), want_x)
        assert len(got_ring) == k
        for slot in range(k):
            assert torch.equal(gather_workers(got_ring[slot]),
                               want_ring[slot])
        if k == 1:
            want, _ = one.run_overlapped(x, sched.flags, alive=alive)
            got, _ = folded.run_overlapped(xs, sched.flags, alive=alive)
            assert torch.equal(gather_workers(got), want)


# ------------------------------------------------------------ the folded heal

HEAL_CASES = {
    # alive_t, revive_t, rows made NaN
    "nan_row": ([1] * 8, [0] * 8, [5]),
    "revival": ([1] * 8, [0, 0, 1, 0, 0, 0, 0, 0], []),
    "no_donors": ([0, 0, 0, 1, 0, 0, 0, 0], [0] * 8, [3]),
    "all_dead": ([0] * 8, [0] * 8, [0, 4]),
}


@pytest.mark.parametrize("cards", [2, 4])
@pytest.mark.parametrize("case", list(HEAL_CASES))
def test_folded_heal_is_heal_and_mask(case, cards):
    alive_t, revive_t, nan_rows = HEAL_CASES[case]
    alive_t = torch.tensor(alive_t, dtype=torch.float32)
    revive_t = torch.tensor(revive_t, dtype=torch.float32)
    x = random_state(N, 33, seed=7)
    x[nan_rows] = float("nan")
    want = heal_and_mask(x, alive_t, revive_t)
    got = heal_and_mask(shard_workers(x, cpu_mesh(cards)), alive_t,
                        revive_t)
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g, w)
    torch.testing.assert_close(gather_workers(got[0]), want[0], rtol=1e-6,
                               atol=1e-7, equal_nan=True)
    if case == "revival":
        assert want[2].tolist() == revive_t.tolist()
    if case in ("no_donors", "all_dead"):
        assert not want[2].any()  # no donor, no heal


def small_states(cards, staleness=1):
    """A ResNet-8 over 8 workers on one card and folded on ``cards``
    virtual cards from the same inits, each with a momentum buffer of ones
    and pending deltas of ones (``staleness`` > 1: the ring), and the two
    flatteners (one card's ``[N, D]``, a mesh card's ``[L, D]``)."""
    def model(rows):
        return select_model("resnet8", "synthetic_image", num_workers=rows,
                            input_shape=(8, 8, 3))

    opt = make_optimizer(lambda step: 0.1)
    sched = bernoulli()
    comm = make_decen(sched, "gather", device="cpu")
    one, flattener = init_train_state(model(N), N, opt, comm, seed=1,
                                      device="cpu", overlap="1step",
                                      staleness=staleness)
    mesh = cpu_mesh(cards)
    folded, card_flattener = init_mesh_train_state(
        model(N), N, opt, make_decen(sched, "shard_map", mesh=mesh), mesh,
        model, seed=1, overlap="1step", staleness=staleness)
    rows = N // cards
    for lo, state in [(0, one)] + [(c * rows, card) for c, card in
                                   enumerate(folded.cards)]:
        with torch.no_grad():
            for i, b in enumerate(state.model.buffers()):
                if b.is_floating_point():
                    worker = torch.arange(lo, lo + b.shape[0],
                                          dtype=b.dtype)
                    b.add_(worker.reshape((-1,) + (1,) * (b.ndim - 1))
                           * (i + 1))
        for p in state.model.parameters():
            state.optimizer.state[p]["momentum_buffer"] = torch.ones_like(p)
        state.mix_pending.fill_(1.0)
    return one, folded, flattener, card_flattener


def whole(state, fn):
    """``fn(card)`` of every card concatenated in worker order."""
    cards = state.cards if isinstance(state, MeshTrainState) else [state]
    return torch.cat([fn(card) for card in cards])


def flat_params(card):
    return torch.cat([p.detach().reshape(p.shape[0], -1)
                      for p in card.model.parameters()], dim=1)


def flat_buffers(card):
    return torch.cat([b.reshape(b.shape[0], -1) for b in card.model.buffers()
                      if b.is_floating_point()], dim=1)


def flat_momentum(card):
    return torch.cat([card.optimizer.state[p]["momentum_buffer"].reshape(
        p.shape[0], -1) for p in card.model.parameters()], dim=1)


@pytest.mark.parametrize("cards", [2, 4])
def test_folded_bootstrap_is_the_one_card_bootstrap(cards):
    """Slot 2 joins, slot 6 is restored with a NaN row (so it takes the
    mean too), slot 7 is restored finite: the parameters and batch-norm
    statistics within f32 rounding of the one-card bootstrap, the momentum
    and the pending deltas of the three slots reset."""
    one, folded, flattener, card_flattener = small_states(cards)
    for state in (one, folded.cards[-1]):
        with torch.no_grad():
            next(state.model.parameters())[-2].fill_(float("nan"))
    joined = np.zeros(N, np.float32)
    joined[2] = 1.0
    restored = np.zeros(N, np.float32)
    restored[[6, 7]] = 1.0
    donors = 1.0 - joined - restored
    make_bootstrap_fn(flattener, N)(one, joined, restored, donors)
    make_bootstrap_fn(card_flattener, N)(folded, joined, restored, donors)
    for fn in (flat_params, flat_buffers):
        torch.testing.assert_close(whole(folded, fn), whole(one, fn),
                                   rtol=1e-6, atol=1e-7)
    assert torch.isfinite(whole(folded, flat_params)).all()
    for fn in (flat_momentum, lambda c: c.mix_pending):
        got = whole(folded, fn)
        assert torch.equal(got, whole(one, fn))
        assert not got[[2, 6, 7]].any() and got[[0, 1, 3, 4, 5]].all()


@pytest.mark.parametrize("overlap,staleness", [
    ("off", 1), ("1step", 1), ("1step", 2), ("1step", 3)],
    ids=["eager", "1step", "same_ring", "deeper_ring"])
def test_a_ring_checkpoint_restores_into_any_depth_on_any_c(
        tmp_path, overlap, staleness):
    """A staleness-2 state on 2 virtual cards, its ring random, saved at
    cursor 5 in the one-card format, restored into one card and into 4
    virtual cards and reconciled with each run's depth: the two agree
    bitwise (parameters with the drained deltas, the primed pipeline, the
    ages rebuilt from the cursor); the payload is the one card's."""
    from matcha_tpu_torch.train.checkpoint import (
        restore_checkpoint,
        save_checkpoint,
    )
    from matcha_tpu_torch.train.loop import _reconcile_mix_pending

    _, saved, _, _ = small_states(2, staleness=2)
    ring = torch.as_tensor(np.random.default_rng(0).normal(
        size=(N,) + tuple(saved.cards[0].mix_pending.shape[1:])),
        dtype=torch.float32)
    saved.mix_pending = shard_workers(ring, saved.mesh)
    saved.step = 5
    save_checkpoint(str(tmp_path), saved, 0)
    payload = torch.load(tmp_path / "0" / "state.pt", weights_only=True)
    assert torch.equal(payload["mix_pending"], ring)
    one, folded, flattener, card_flattener = small_states(4, staleness)
    comm = make_decen(bernoulli(), "gather", device="cpu")
    if overlap == "off":
        for state in (one, folded):
            state.mix_pending, state.mix_ages = (), ()
    for state, flat in ((one, flattener), (folded, card_flattener)):
        state, _ = restore_checkpoint(str(tmp_path), state)
        _reconcile_mix_pending(state, overlap, comm, flat, N,
                               staleness=staleness)
    assert torch.equal(whole(folded, flat_params), whole(one, flat_params))
    if overlap == "off":
        assert folded.mix_pending == () and one.mix_pending == ()
        return
    assert torch.equal(gather_workers(folded.mix_pending), one.mix_pending)
    if staleness == 1:
        assert folded.mix_ages == () and one.mix_ages == ()
    else:
        assert torch.equal(gather_workers(folded.mix_ages), one.mix_ages)
    if staleness == 2:  # the same depth goes on with the saved ring
        assert torch.equal(one.mix_pending, ring)
        # slot 0 holds the delta issued at step 4, slot 1 at step 3
        assert one.mix_ages[0].tolist() == [1, 2]
    else:  # drained into the parameters, a fresh pipeline primed
        assert not one.mix_pending.any()


def test_folded_stat_heal_is_the_one_card_heal():
    one, folded, _, _ = small_states(4)
    healed = torch.tensor([0, 1, 0, 0, 0, 0, 1, 0], dtype=torch.float32)
    donors = torch.tensor([1, 0, 1, 1, 0, 1, 0, 1], dtype=torch.float32)
    heal_worker_stat_rows(list(one.model.buffers()), healed, donors, N)
    heal_folded_stat_rows([list(c.model.buffers()) for c in folded.cards],
                          healed, donors, N // 4)
    torch.testing.assert_close(whole(folded, flat_buffers),
                               whole(one, flat_buffers), rtol=1e-6,
                               atol=1e-7)
    mean = masked_mean_rows(whole(one, flat_buffers), donors)
    torch.testing.assert_close(whole(folded, flat_buffers)[1], mean)


# ------------------------------------------------------- train() against JAX

def jax_config(over):
    over = dict(over)
    if "fault_plan" in over:
        over["fault_plan"] = jres.FaultPlan(tuple(
            jres.FaultEvent(**e) for e in over["fault_plan"]))
    return over


def port_config(over):
    over = dict(over)
    if "fault_plan" in over:
        over["fault_plan"] = {"events": over["fault_plan"]}
    return over


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """For each case: the JAX ``train()`` on 4 of its devices with
    ``shard_map``, the port's on 4 virtual cards (the first also on one
    card), from the JAX run's initial parameters; the staleness-2 run
    saves a checkpoint every epoch and is resumed from its epoch-1
    generation."""
    if jax.device_count() < 4:
        pytest.skip("needs the forced JAX devices (see conftest)")
    root = tmp_path_factory.mktemp("meshfull")
    init = jax_train(JaxTrainConfig(**{**BASE, "epochs": 0})).state
    params, stats = to_numpy(init.params), to_numpy(init.batch_stats)
    out = {}
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr("matcha_tpu_torch.train.state.init_workers",
                      lambda model, seed: load_into_port(model, params,
                                                         stats))
        for name, over, backend in CASES:
            ref = jax_train(JaxTrainConfig(**{**BASE, **jax_config(over)},
                                           devices=4,
                                           gossip_backend="shard_map"))
            cfg = TrainConfig(**{**BASE, **port_config(over)}, name=name,
                              sync_init=False, gossip_backend=backend,
                              savePath=str(root))
            if name == "staleness2_trace":
                cfg = dataclasses.replace(cfg, save=True, checkpoint_every=1)
            mesh = train(dataclasses.replace(cfg, devices=4), device="cpu")
            out[name] = {"jax": ref, "mesh": mesh, "cfg": cfg}
        first = CASES[0][0]
        out[first]["one"] = train(out[first]["cfg"], device="cpu")
        # the staleness-2 run's epoch-1 generation, resumed alone
        cfg = out["staleness2_trace"]["cfg"]
        ckpt, cut = str(root / f"{cfg.name}_ckpt"), str(root / "cut_ckpt")
        shutil.copytree(os.path.join(ckpt, "1"), os.path.join(cut, "1"))
        for side in ("digest-1.json", "schedule-1.json",
                     "membership-1.json"):
            shutil.copy(os.path.join(ckpt, side), cut)
        out["resumed"] = train(dataclasses.replace(
            cfg, devices=4, checkpoint_every=0, name="cut"),
            resume_dir=cut, device="cpu")
    return out


def fault_records(result):
    """The fault ledger without its clock, the floats rounded."""
    return [{k: (round(v, 4) if isinstance(v, float) else v)
             for k, v in e.items() if k not in ("recordtime", "reason",
                                                "path")}
            for e in result.recorder.faults]


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_train_on_the_mesh_matches_jax(runs, name):
    port, ref = runs[name]["mesh"], runs[name]["jax"]
    assert isinstance(port.state, MeshTrainState)
    assert [h["epoch"] for h in port.history] == \
        [h["epoch"] for h in ref.history]
    for got, want in zip(port.history, ref.history):
        assert set(got) == set(want)
        for key in ("loss", "disagreement", "test_loss_mean"):
            assert np.isfinite(got[key])
            assert rel(got[key], want[key]) <= REL, (key, got[key],
                                                     want[key])
        for key in ("alive_workers", "healed"):
            assert got.get(key) == want.get(key), key
    assert fault_records(port) == fault_records(ref)


EXACT = ("steps", "matchings_mean", "wire_bytes", "alive_mean", "alive_min",
         "stale_steps", "stale_dropped", "stale_age_hist", "healed")


@pytest.mark.parametrize("name", ["overlap_chaos", "staleness2_trace"])
def test_pipeline_telemetry_on_the_mesh_matches_jax(runs, name):
    """The ``telemetry`` events of the pipelined cases: the counts (the
    ring's consumed ages and dropped deltas over every card, the heals,
    the alive rows) equal to JAX's, the rest within ``REL``."""
    port, ref = runs[name]["mesh"], runs[name]["jax"]
    got, want = ([e for e in r.recorder.events if e["kind"] == "telemetry"]
                 for r in (port, ref))
    assert len(got) == len(want) == 3
    assert any(e["stale_dropped"] for e in got)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key, value in w.items():
            if key in EXACT:
                assert g[key] == value, key
            elif key != "t" and isinstance(value, (int, float)):
                assert rel(g[key], value) <= REL, (key, g[key], value)


def test_the_cases_exercise_their_features(runs):
    """What each case is there for happened, in both packages: the chaos
    plan healed and quarantined, the trace shrank and grew the pool, the
    all-NaN plan rolled back once."""
    chaos = runs["overlap_chaos"]["mesh"].history
    assert [h["healed"] for h in chaos] == [0.0, 0.25, 0.25]
    assert [h["alive_workers"] for h in chaos] == [8.0, 7.0, 8.0]
    trace = runs["staleness2_trace"]["mesh"].history
    assert [h["alive_workers"] for h in trace] == [7.0, 6.0, 8.0]
    kinds = [e["kind"] for e in runs["rollback"]["mesh"].recorder.faults]
    assert kinds.count("rollback") == 1
    for name in ("overlap_chaos", "staleness2_trace"):
        state = runs[name]["mesh"].state
        # train() drained the pipeline: nothing left in flight
        assert not gather_workers(state.mix_pending).any()


def test_perm_on_the_mesh_against_one_card(runs):
    """The one-step pipeline under the chaos plan with ``perm``: on 4
    virtual cards (K1 on the gathered stack) and on one card."""
    mesh, one = runs["overlap_chaos"]["mesh"], runs["overlap_chaos"]["one"]
    for got, want in zip(mesh.history, one.history, strict=True):
        for key in ("loss", "disagreement", "test_loss_mean"):
            assert rel(got[key], want[key]) <= REL, key
        assert got["healed"] == want["healed"]
        assert got["alive_workers"] == want["alive_workers"]
    assert fault_records(mesh) == fault_records(one)
    rows = whole(mesh.state, flat_params)
    torch.testing.assert_close(rows, whole(one.state, flat_params),
                               rtol=REL, atol=1e-6)


def test_resume_through_the_ring_and_the_shrink_is_bitwise(runs):
    """Cut after epoch 1 (the staleness-2 ring full, w3's slot vacant) and
    resumed from that generation in the one-card format: epoch 2 (the
    join and the rejoin's bootstrap) ends bitwise where the uninterrupted
    run does, parameters, batch-norm buffers, momentum, and the drained
    pipeline."""
    whole_run, resumed = runs["staleness2_trace"]["mesh"], runs["resumed"]
    assert [h["epoch"] for h in resumed.history] == [2]
    assert resumed.state.step == whole_run.state.step
    for a, b in zip(whole_run.state.cards, resumed.state.cards):
        for (key, p), (_, q) in zip(a.model.state_dict().items(),
                                    b.model.state_dict().items()):
            assert torch.equal(p, q), key
        for p, q in zip(a.model.parameters(), b.model.parameters()):
            assert torch.equal(a.optimizer.state[p]["momentum_buffer"],
                               b.optimizer.state[q]["momentum_buffer"])
        assert torch.equal(a.mix_pending, b.mix_pending)
    payload = torch.load(os.path.join(
        str(whole_run.recorder.folder).rsplit("/", 1)[0],
        "staleness2_trace_ckpt", "1", "state.pt"), weights_only=True)
    dim = whole(whole_run.state, flat_params).shape[1]
    assert tuple(payload["mix_pending"].shape) == (N, 2, dim)


# ---------------------------------------------------- membership_live

def write_beat(health_dir, t, workers, epoch):
    os.makedirs(health_dir, exist_ok=True)
    event = {"v": 3, "kind": "heartbeat", "t": float(t), "host": "host0",
             "epoch": epoch, "step": (epoch + 1) * 4, "step_time": 0.1,
             "step_time_ewma": 0.1, "comp_time": 0.3, "comm_time": 0.1,
             "peak_bytes": None,
             "workers": {w: {"slot": i, "participation": 1.0,
                             "disagreement": 0.0}
                         for i, w in enumerate(workers)}}
    with open(health.heartbeat_path(health_dir, "host0"), "a") as f:
        f.write(__import__("json").dumps(event) + "\n")


def test_membership_live_on_the_mesh_against_one_card(tmp_path):
    """w3's newest heartbeat is gone: both runs drop its slot at epoch 0,
    with the same ``membership`` event and the same alive counts, and the
    mesh's epochs within ``REL`` of one card's."""
    hdir = str(tmp_path / "fleet_health")
    now = time.time()
    write_beat(hdir, now - 3600.0, [f"w{i}" for i in range(N)], 0)
    write_beat(hdir, now, [f"w{i}" for i in range(N) if i != 3], 1)
    cfg = TrainConfig(**{**BASE, "epochs": 2, "save": True, "dataset_kwargs":
                         {"num_train": 256, "num_test": 32}}, name="live",
                      savePath=str(tmp_path), membership_live=hdir,
                      membership_deadline=60.0)
    mesh = train(dataclasses.replace(cfg, devices=4, name="live_mesh"),
                 device="cpu")
    one = train(cfg, device="cpu")
    assert isinstance(mesh.state, MeshTrainState)
    events = [[e for e in r.recorder.events if e["kind"] == "membership"]
              for r in (mesh, one)]
    assert len(events[0]) == len(events[1]) == 1
    for key in ("epoch", "old_alive", "new_alive", "trigger", "alpha"):
        assert events[0][0][key] == events[1][0][key], key
    for got, want in zip(mesh.history, one.history, strict=True):
        assert got["alive_workers"] == want["alive_workers"] == 7.0
        for key in ("loss", "disagreement", "test_loss_mean"):
            assert rel(got[key], want[key]) <= REL, key
