"""The worker mesh against the JAX package on its 8 forced CPU devices.

The port's mesh folds N workers card-major onto C devices (worker
``g = c·L + l`` on card c as row l); here the C cards are virtual, C
copies of the CPU, as the JAX tests' devices are 8 forced host devices
(``tests/conftest.py``).  The same numpy inputs go through the JAX
package's ``shard_map`` backend and the port's folded executor at the
shapes of the JAX tests cited on each test, at JAX's bar of rtol 1e-5 /
atol 1e-6 unless stated: the port's folded step is the gather oracle's
arithmetic, while XLA may fuse the JAX body otherwise.  Where a test needs
only random activations, its flags are the fixed schedule's Bernoulli
draws at the cited budget, which cost no MATCHA solve.  Within the port
the folded result is bitwise the same for every C: the parts of a
matching partition each card's rows, so each row's partner is gathered
whole and no sum depends on the fold.

``train()`` on a mesh of 4 against the JAX ``train()`` with ``devices=4``
and ``gossip_backend="shard_map"``, at the acceptance run's bars and
configuration (``tests/test_torch_acceptance.py``: MLP, digits, graph 5,
8 workers, the JAX run's initial parameters carried by ``convert.py``).
"""

import dataclasses
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import load_into_port, to_numpy
from matcha_tpu import topology as jtp
from matcha_tpu.communicator import make_decen as jax_make_decen
from matcha_tpu.parallel import shard_map_gossip_fn as jax_shard_map_fn
from matcha_tpu.parallel import shard_workers as jax_shard_workers
from matcha_tpu.parallel import worker_mesh as jax_worker_mesh
from matcha_tpu.schedule import fixed_schedule, matcha_schedule
from matcha_tpu.train import TrainConfig as JaxTrainConfig
from matcha_tpu.train import train as jax_train
from matcha_tpu_torch.chaos.campaign import _trial_config
from matcha_tpu_torch.communicator import make_decen
from matcha_tpu_torch.obs.journal import read_journal
from matcha_tpu_torch.parallel import (
    WorkerBlocks,
    fold_dims,
    gather_workers,
    replicated,
    shard_map_gossip_fn,
    shard_workers,
    worker_deviation_rows,
    worker_disagreement,
    worker_mesh,
)
from matcha_tpu_torch.train import TrainConfig, train
from matcha_tpu_torch.train.loop import TrainingDiverged, _resolve_mesh
from matcha_tpu_torch.train.state import (
    MeshTrainState,
    _folded_deviation,
    make_optimizer,
    make_train_step,
)

REPO = pathlib.Path(__file__).resolve().parents[1]

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: its small products gain nothing
    from more when the file runs alone, and in a full run beside five other
    test processes more threads only contend for the cores.  Restored
    after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def random_state(n, d, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def cpu_mesh(cards):
    return worker_mesh(devices=["cpu"] * cards)


def port_fold(x, mesh):
    return shard_workers(torch.as_tensor(x), mesh)


def need_8_devices():
    if jax.device_count() < 8:
        pytest.skip("needs the 8 forced JAX devices (see conftest)")
    return jax_worker_mesh(8)


def bernoulli(decomposed, size, iterations, budget, seed):
    return fixed_schedule(decomposed, size, iterations=iterations,
                          budget=budget, mode="bernoulli", seed=seed)


def host_weights(sched, t):
    return np.float32(sched.alpha) * np.asarray(sched.flags[t], np.float32)


# ------------------------------------------------------------- the executor

@pytest.mark.parametrize("gid,size", [(0, 8), (5, 8), (2, 16), (3, 16)])
def test_executor_matches_jax_shard_map(gid, size):
    """``tests/test_gossip.py:140``: 8 cards, zoo graphs, three steps."""
    jmesh = need_8_devices()
    sched = bernoulli(jtp.select_graph(gid), size, 10, 0.6, 5)
    x = random_state(size, 29, seed=gid + 10)
    jfn = jax.jit(jax_shard_map_fn(sched.perms, jmesh))
    xs = jax_shard_workers(jnp.asarray(x), jmesh)
    mesh = cpu_mesh(8)
    fn = shard_map_gossip_fn(sched.perms, mesh)
    for t in [0, 2, 9]:
        w = host_weights(sched, t)
        want = np.asarray(jfn(xs, jnp.asarray(w)))
        got = gather_workers(fn(port_fold(x, mesh), torch.as_tensor(w)))
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_executor_folded_256_workers():
    """``tests/test_gossip.py:154``: 256 workers on 8 cards, 32 rows each,
    at that test's bar of 1e-4."""
    jmesh = need_8_devices()
    n = 256
    dec = jtp.decompose(jtp.make_graph("geometric", n, seed=0), n, seed=0)
    sched = fixed_schedule(dec, n, iterations=3)
    x = random_state(n, 17, seed=9)
    w = host_weights(sched, 0)
    want = np.asarray(jax.jit(jax_shard_map_fn(sched.perms, jmesh))(
        jax_shard_workers(jnp.asarray(x), jmesh), jnp.asarray(w)))
    mesh = cpu_mesh(8)
    got = gather_workers(shard_map_gossip_fn(sched.perms, mesh)(
        port_fold(x, mesh), torch.as_tensor(w)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_alive_and_bf16_wire_against_the_gather_backend():
    """``tests/test_overlap.py:177``: the one-step pipeline drains to the
    eager chain on the mesh, and the bf16 folded exchange under a survivor
    mask matches the port's gather backend (and the JAX body) — the two
    executors quantize at the same boundary by construction."""
    jmesh = need_8_devices()
    n = 16
    sched = bernoulli(jtp.select_graph(2), n, 8, 0.5, 1)
    x0 = np.random.default_rng(4).normal(size=(n, 19)).astype(np.float32)
    mesh = cpu_mesh(8)
    comm = make_decen(sched, "shard_map", mesh=mesh)
    eager, _ = comm.run(port_fold(x0, mesh), sched.flags)
    over, _ = comm.run_overlapped(port_fold(x0, mesh), sched.flags)
    assert isinstance(eager, WorkerBlocks) and isinstance(over, WorkerBlocks)
    np.testing.assert_allclose(gather_workers(over).numpy(),
                               gather_workers(eager).numpy(),
                               rtol=RTOL, atol=ATOL)

    alive = np.ones(n, np.float32)
    alive[[3, 11]] = 0.0
    wired = make_decen(sched, "shard_map", mesh=mesh, wire_dtype="bf16")
    gathered = make_decen(sched, "gather", device="cpu", wire_dtype="bf16")
    a, _ = wired.run(port_fold(x0, mesh), sched.flags[:4], alive=alive)
    b, _ = gathered.run(torch.as_tensor(x0), sched.flags[:4], alive=alive)
    np.testing.assert_allclose(gather_workers(a).numpy(), b.numpy(),
                               rtol=RTOL, atol=ATOL)
    jfn = jax.jit(jax_shard_map_fn(sched.perms, jmesh, wire_dtype="bf16"))
    w = host_weights(sched, 1)
    want = np.asarray(jfn(jax_shard_workers(jnp.asarray(x0), jmesh),
                          jnp.asarray(w), jnp.asarray(alive)))
    got = gather_workers(shard_map_gossip_fn(
        sched.perms, mesh, wire_dtype="bf16")(
            port_fold(x0, mesh), torch.as_tensor(w), torch.as_tensor(alive)))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_skip_matches_shard_map_with_an_inactive_step():
    """``tests/test_gossip.py:293``: 64 workers on 8 cards, one step with
    every matching inactive; skip against the masked folded plan, and the
    port's skip against the JAX package's."""
    jmesh = need_8_devices()
    n = 64
    sched = bernoulli(jtp.decompose(jtp.make_graph("geometric", n, seed=3),
                                    n, seed=0), n, 12, 0.3, 5)
    flags = np.asarray(sched.flags).copy()
    flags[5] = 0
    x0 = random_state(n, 9, seed=7)
    mesh = cpu_mesh(8)
    skip = make_decen(sched, "skip", mesh=mesh)
    assert skip.name == "decen[skip]" and skip.host_flags
    a, _ = skip.run(port_fold(x0, mesh), flags)
    b, _ = make_decen(sched, "shard_map", mesh=mesh).run(
        port_fold(x0, mesh), flags)
    np.testing.assert_allclose(gather_workers(a).numpy(),
                               gather_workers(b).numpy(),
                               rtol=RTOL, atol=ATOL)
    xs = jax_shard_workers(jnp.asarray(x0), jmesh)
    want, _ = jax.jit(jax_make_decen(sched, mesh=jmesh,
                                     backend="skip").run)(xs, flags)
    np.testing.assert_allclose(gather_workers(a).numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    # the inactive step itself moves nothing and returns the blocks
    blocks = port_fold(x0, mesh)
    out, _ = skip.step(blocks, (), torch.as_tensor(flags[5]))
    assert all(o is b for o, b in zip(out, blocks))


def test_make_decen_shard_map_run_matches_jax():
    """``tests/test_communicator.py:69``: a 12-step chain through the
    communicator on 8 cards."""
    jmesh = need_8_devices()
    sched = matcha_schedule(jtp.select_graph(2), 16, iterations=12,
                            budget=0.5, seed=1)
    x0 = random_state(16, 19, seed=4)
    comm = jax_make_decen(sched, mesh=jmesh, backend="shard_map")
    want, _ = jax.jit(comm.run)(jax_shard_workers(jnp.asarray(x0), jmesh),
                                sched.flags)
    mesh = cpu_mesh(8)
    port = make_decen(sched, "shard_map", mesh=mesh)
    assert port.name == "decen[shard_map]"
    got, carry = port.run(port_fold(x0, mesh), sched.flags)
    assert carry == ()
    np.testing.assert_allclose(gather_workers(got).numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("skip", [False, True])
def test_the_fold_changes_no_bit(skip):
    """C ∈ {1, 2, 4, 8} with ``wire_dtype=None``: the same bits, with and
    without a survivor mask, and the gather oracle's bits (its skipping
    twin's with ``skip``)."""
    n = 16
    sched = bernoulli(jtp.select_graph(4), n, 6, 0.5, 3)
    x0 = random_state(n, 31, seed=2)
    alive = np.ones(n, np.float32)
    alive[5] = 0.0
    oracle = make_decen(sched, "skip" if skip else "gather", device="cpu")
    for mask in (None, alive):
        want, _ = oracle.run(torch.as_tensor(x0), sched.flags, alive=mask)
        for cards in (1, 2, 4, 8):
            mesh = cpu_mesh(cards)
            fn = shard_map_gossip_fn(sched.perms, mesh, skip=skip)
            x = port_fold(x0, mesh)
            for t in range(sched.flags.shape[0]):
                w = torch.as_tensor(host_weights(sched, t))
                x = fn(x, w) if mask is None else fn(x, w,
                                                     torch.as_tensor(mask))
            assert torch.equal(gather_workers(x), want), (cards, mask)


def test_shard_and_gather_round_trip_and_the_fold_error():
    """``tests/test_gossip.py:235``: worker rows fold, scalars and
    generators stay single, and a leading dim the mesh does not divide is
    a loud error."""
    mesh = cpu_mesh(4)
    gen = torch.Generator().manual_seed(0)
    tree = {"x": torch.as_tensor(random_state(8, 5)), "step": torch.tensor(3),
            "key": gen, "nested": [torch.arange(16.0).reshape(8, 2)]}
    folded = shard_workers(tree, mesh)
    assert isinstance(folded["x"], WorkerBlocks) and len(folded["x"]) == 4
    assert [tuple(b.shape) for b in folded["x"]] == [(2, 5)] * 4
    assert folded["step"] is tree["step"] and folded["key"] is gen
    back = gather_workers(folded)
    assert torch.equal(back["x"], tree["x"])
    assert torch.equal(back["nested"][0], tree["nested"][0])
    assert fold_dims(8, mesh) == (4, 2)
    assert replicated(torch.ones(3), cpu_mesh(2))[0].shape == (3,)
    with pytest.raises(ValueError, match="divisible"):
        shard_workers({"x": torch.zeros(6, 4)}, mesh)


def test_a_cuda_mesh_that_is_not_there_raises(monkeypatch):
    """A mesh never runs on the CPU in place of missing cards."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"cuda:3.*\['cuda:0'\]"):
        worker_mesh(devices=["cuda:0", "cuda:3"])
    assert worker_mesh(devices=["cuda:0"] * 4).devices == (
        torch.device("cuda", 0),) * 4


# ------------------------------------------------------------- train()

CONFIG = dict(model="mlp", dataset="digits", graphid=5, num_workers=8,
              matcha=False, epochs=2, batch_size=16, lr=0.1, warmup=False,
              seed=0, telemetry=False, health=False)
REL = 1e-4
ONE_EXAMPLE = 1.0 / 360


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX run on 4 of its devices; the port's on 4 virtual cards,
    uninterrupted (``auto``, journaled) and resumed from its epoch-0
    checkpoint (``shard_map``); all from the JAX run's initial weights."""
    if jax.device_count() < 4:
        pytest.skip("needs the forced JAX devices (see conftest)")
    ref = jax_train(JaxTrainConfig(**CONFIG, devices=4,
                                   gossip_backend="shard_map"))
    init = jax_train(JaxTrainConfig(**{**CONFIG, "epochs": 0})).state
    params, stats = to_numpy(init.params), to_numpy(init.batch_stats)
    root = str(tmp_path_factory.mktemp("mesh"))
    port = TrainConfig(**CONFIG, sync_init=False, devices=4, savePath=root)
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr("matcha_tpu_torch.train.state.init_workers",
                      lambda model, seed: load_into_port(model, params,
                                                         stats))
        whole = train(dataclasses.replace(port, gossip_backend="auto",
                                          save=True, name="whole"),
                      device="cpu")
        train(dataclasses.replace(port, gossip_backend="shard_map", epochs=1,
                                  checkpoint_every=1, name="cut"),
              device="cpu")
        resumed = train(dataclasses.replace(port, gossip_backend="shard_map",
                                            name="cut"),
                        resume_dir=f"{root}/cut_ckpt", device="cpu")
    return whole, resumed, ref


def test_train_on_the_mesh_journals_shard_map(runs):
    whole, _, _ = runs
    assert isinstance(whole.state, MeshTrainState)
    assert len(whole.state.cards) == 4
    assert [c.model.num_workers for c in whole.state.cards] == [2] * 4
    # the comm-split timer ran the folded chain
    assert all(h["comm_time"] > 0 for h in whole.history)
    events = read_journal(f"{whole.recorder.folder}/events.jsonl")
    backend = [e for e in events if e["kind"] == "backend"]
    assert [(e["requested"], e["chosen"]) for e in backend] == [
        ("auto", "shard_map")]


@pytest.mark.parametrize("key", ["loss", "disagreement", "test_loss_mean"])
def test_epoch_metrics_within_1e4_of_jax(runs, key):
    whole, _, ref = runs
    ref = ref.history
    assert [h["epoch"] for h in whole.history] == [0, 1]
    for got, want in zip(whole.history, ref):
        assert set(got) == set(want)
        assert np.isfinite(got[key])
        rel = abs(got[key] - want[key]) / max(abs(want[key]), 1e-12)
        assert rel <= REL, (key, got[key], want[key])


def test_test_accuracy_within_one_example_of_jax(runs):
    whole, _, ref = runs
    for got, want in zip(whole.history, ref.history):
        assert abs(got["test_acc_mean"] - want["test_acc_mean"]) \
            <= ONE_EXAMPLE
    # the Recorder's per-worker series, gathered in worker order
    got = np.asarray(whole.recorder.data["tacc"], np.float64)
    want = np.asarray(ref.recorder.data["tacc"], np.float64)
    assert got.shape == want.shape == (2, 8)
    assert np.abs(got - want).max() <= ONE_EXAMPLE


def test_resume_on_the_mesh_is_bitwise(runs):
    """The run resumed from its epoch-0 checkpoint (saved gathered,
    folded back onto 4 cards) ends bitwise where the uninterrupted one
    does: parameters, batch-norm buffers and momentum of every card."""
    whole, resumed, _ = runs
    assert [h["epoch"] for h in resumed.history] == [1]
    assert resumed.state.step == whole.state.step
    for a, b in zip(whole.state.cards, resumed.state.cards):
        for (name, p), (_, q) in zip(a.model.state_dict().items(),
                                     b.model.state_dict().items()):
            assert torch.equal(p, q), name
        for p, q in zip(a.model.parameters(), b.model.parameters()):
            assert torch.equal(a.optimizer.state[p]["momentum_buffer"],
                               b.optimizer.state[q]["momentum_buffer"])


# ------------------------------------------------------------- the rules

def test_mesh_resolution_keeps_jax_answers():
    """One device, or a fold that C does not divide: no mesh.  A sequence
    of devices is the mesh, and ``devices`` must match it."""
    cfg = TrainConfig(**CONFIG)
    assert _resolve_mesh(cfg, "cpu") == (torch.device("cpu"), None)
    assert _resolve_mesh(dataclasses.replace(cfg, devices=3), "cpu")[1] \
        is None
    assert _resolve_mesh(cfg, ["cpu"])[1] is None
    dev, mesh = _resolve_mesh(dataclasses.replace(cfg, devices=4), "cpu")
    assert dev == torch.device("cpu") and mesh.size == 4
    assert _resolve_mesh(cfg, ["cpu"] * 2)[1].shape == {"workers": 2}
    with pytest.raises(ValueError, match="devices=4"):
        _resolve_mesh(dataclasses.replace(cfg, devices=4), ["cpu"] * 2)


def test_devices_none_is_one_card_however_many_are_visible(monkeypatch):
    """``devices=None`` is every visible card, as in JAX, wherever the
    card count divides the workers: with 4 cards visible, 8 workers fold
    onto the 4 cards (``device`` None or ``"cuda"``, any backend) and 6
    stay on one card.  One card stays one card however many are visible
    when it is asked for by its index (``"cuda:0"``, as chip_smoke's
    one-card phases ask) or by ``devices=1`` (the serve and chaos
    lifetimes chip_smoke runs); the CPU is one device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    every = tuple(torch.device("cuda", i) for i in range(4))
    for cfg in (TrainConfig(**CONFIG),
                TrainConfig(**CONFIG, gossip_backend="perm")):
        for device in (None, "cuda"):
            dev, mesh = _resolve_mesh(cfg, device)
            assert dev == every[0] and mesh.devices == every, (cfg, device)
    assert _resolve_mesh(TrainConfig(**{**CONFIG, "num_workers": 6,
                                        "graphid": None}), None)[1] is None
    for cfg, device in ((TrainConfig(**CONFIG), "cuda:0"),
                        (TrainConfig(**CONFIG, devices=1), None),
                        (TrainConfig(**_trial_config("unused", 2),
                                     devices=1), "cuda")):
        dev, mesh = _resolve_mesh(cfg, device)
        assert dev.type == "cuda" and mesh is None, (cfg, device)
    assert _resolve_mesh(TrainConfig(**CONFIG), "cpu") == (
        torch.device("cpu"), None)
    dev, mesh = _resolve_mesh(TrainConfig(**CONFIG, devices=2), "cuda")
    assert mesh.devices == every[:2]


@pytest.mark.parametrize("cards", [2, 4, 8])
def test_folded_disagreement_is_the_gathered_stacks(cards):
    """The mesh step's disagreement and deviation rows, from per-card
    partials, are ``worker_deviation`` of the gathered stack up to the
    order of its sums."""
    x = torch.as_tensor(np.random.default_rng(cards).standard_normal(
        (16, 301)), dtype=torch.float32)
    rows, got = _folded_deviation(shard_workers(x, cpu_mesh(cards)),
                                  torch.device("cpu"))
    torch.testing.assert_close(got, worker_disagreement(x), rtol=RTOL,
                               atol=ATOL)
    torch.testing.assert_close(rows, worker_deviation_rows(x), rtol=RTOL,
                               atol=ATOL)


def test_a_card_step_takes_no_option_of_the_mix():
    """The one-card step without a communicator (each card's part of the
    mesh step) refuses the options that act on the mix."""
    from matcha_tpu_torch.ops import WorkerFlattener

    flat = WorkerFlattener({"w": torch.zeros(2, 3)})
    opt = make_optimizer(lambda step: 0.1)
    for kw in (dict(overlap="1step"), dict(local_steps=2),
               dict(elastic=True), dict(control=True)):
        with pytest.raises(ValueError, match="without a communicator"):
            make_train_step(opt, None, flat, np.ones((2, 1)), **kw)


def test_the_cli_folds_onto_every_visible_card_for_shard_map(monkeypatch):
    """``train_torch.py`` leaves ``devices`` at None for every backend, so
    that ``train()`` folds onto every visible card on the card (shard_map
    or any other backend) and runs on one device with ``--device cpu``."""
    sys.path.insert(0, str(REPO))
    try:
        import train_torch
    finally:
        sys.path.remove(str(REPO))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    for backend in ("shard_map", "auto", "perm"):
        cfg, device = train_torch.parse_args(
            ["--backend", backend, "--numworkers", "8", "--graphid", "5"])
        assert cfg.devices is None and device == "cuda"
        assert _resolve_mesh(cfg, device)[1].size == 4
    cfg, device = train_torch.parse_args(
        ["--backend", "shard_map", "--device", "cpu"])
    assert cfg.devices is None and _resolve_mesh(cfg, device)[1] is None


def test_train_halts_on_divergence_on_the_mesh():
    """The divergence detector reads every card's rows."""
    cfg = TrainConfig(**{**CONFIG, "epochs": 1, "lr": 1e30}, devices=4,
                      gossip_backend="shard_map")
    with pytest.raises(TrainingDiverged):
        train(cfg, device="cpu")


def test_one_tensor_backends_refuse_a_mesh():
    """``shard_map`` refuses to run without a mesh; a one-tensor backend
    takes a mesh (``tests/test_torch_mesh_full.py`` holds it to one
    card)."""
    sched = bernoulli(jtp.select_graph(5), 8, 2, 0.5, 0)
    with pytest.raises(ValueError, match="needs a mesh"):
        make_decen(sched, "shard_map", device="cpu")
    # a mesh of one device: skip is the one-tensor skip, as in JAX
    assert not isinstance(make_decen(sched, "skip", mesh=cpu_mesh(1)).step(
        torch.zeros(8, 3), (), torch.zeros(sched.num_matchings))[0],
        WorkerBlocks)
