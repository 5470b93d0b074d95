"""The default run and every communicator on a worker mesh.

``train(..., devices=4)`` with the JAX package's defaults (telemetry and
health on) against the JAX ``train()`` on 4 of its forced host devices
(``tests/conftest.py``), from the JAX run's initial parameters: the
``telemetry`` events and the heartbeats' per-worker fields within
``TEL_REL`` (the counts exact), the same drift epochs and the same event
kinds, the host-time anomalies aside (``HOST_TIME_CAUSES``: a verdict of
the wall clock).  The port's mesh is ``["cpu"] * C``: C virtual cards.

CHOCO's ``shard_map`` backend with ``top_k`` bitwise the port's batched
CHOCO for C = 1, 2, 4, 8 at 8×21 and 64×1031 (each row's arithmetic is
the batched form's), and within the JAX test's rtol 1e-5 of the JAX
``shard_map`` backend; ``random_k`` held to JAX's contracts
(``tests/test_communicator.py:224``: reproducible, the consensus
contracts, the key advances) and resumable bitwise.  ``centralized`` on a
mesh within 1e-6 of the inputs' scale of one card (the sum runs in
another order).  Through ``train()``: CHOCO, ``centralized`` and
``local_steps=2`` on the mesh against one card (``RUN_REL``, the
acceptance bar), a CHOCO checkpoint in the one-card format resumed
bitwise, identity knobs bitwise the unsupervised mesh run and a budget
and cadence swap against the same swap on one card, and one ``trace_dir``
epoch whose phases carry the step's ranges.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from _torch_parity import load_into_port, to_numpy
from matcha_tpu import topology as jtp
from matcha_tpu.communicator import make_choco as jax_make_choco
from matcha_tpu.parallel import shard_workers as jax_shard_workers
from matcha_tpu.parallel import worker_mesh as jax_worker_mesh
from matcha_tpu.schedule import fixed_schedule as jax_fixed_schedule
from matcha_tpu.train import TrainConfig as JaxTrainConfig
from matcha_tpu.train import train as jax_train
from matcha_tpu_torch import serve
from matcha_tpu_torch import topology as tp
from matcha_tpu_torch.communicator import make_centralized, make_choco
from matcha_tpu_torch.communicator.choco import folded_message_bytes
from matcha_tpu_torch.obs import journal, xprof
from matcha_tpu_torch.ops import WorkerFlattener, top_k_ratio_size
from matcha_tpu_torch.parallel import (
    WorkerBlocks,
    gather_workers,
    shard_workers,
    worker_disagreement,
    worker_mesh,
)
from matcha_tpu_torch.schedule import fixed_schedule
from matcha_tpu_torch.train import TrainConfig, build_dataset, train
from matcha_tpu_torch.train.state import MeshTrainState

TEL_REL = 1e-5
RUN_REL = 1e-4
EXACT = ("steps", "matchings_mean", "wire_bytes", "alive_mean", "alive_min",
         "stale_steps", "stale_dropped", "stale_age_hist", "quantized_values",
         "healed")
HOST_TIME_CAUSES = ("step_time_spike", "comm_time_spike")
CARDS = (1, 2, 4, 8)

# ring-8 MATCHA on the small synthetic set: 4 steps an epoch
BASE = dict(model="mlp", dataset="synthetic",
            dataset_kwargs={"num_train": 256, "num_test": 32},
            num_workers=8, graphid=5, batch_size=8, epochs=3, lr=0.05,
            warmup=False, matcha=True, budget=0.5, seed=3, save=True,
            eval_every=1, measure_comm_split=False)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the small products gain nothing from more, and
    beside five other test processes more threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b))
                 / max(float(np.max(np.abs(b))), 1e-300))


def cpu_mesh(cards):
    return worker_mesh(devices=["cpu"] * cards)


def random_state(n, d, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def events_of(result):
    return journal.read_journal(os.path.join(result.recorder.folder,
                                             "events.jsonl"))


def of_kind(events, kind):
    return [e for e in events if e["kind"] == kind]


def off_clock(events):
    return [e for e in events if not (e["kind"] == "anomaly"
                                      and e["cause"] in HOST_TIME_CAUSES)]


def flat_rows(result) -> torch.Tensor:
    """Every worker's parameters, ``[N, D]`` in worker order, from a
    one-card or a mesh state."""
    state = result.state
    cards = state.cards if isinstance(state, MeshTrainState) else [state]
    return torch.cat([torch.cat([p.detach().reshape(p.shape[0], -1)
                                 for p in card.model.parameters()], dim=1)
                      for card in cards])


def assert_runs_agree(got, want, bar=RUN_REL,
                      keys=("loss", "disagreement", "test_loss_mean")):
    assert [h["epoch"] for h in got.history] == \
        [h["epoch"] for h in want.history]
    for a, b in zip(got.history, want.history):
        for key in keys:
            assert np.isfinite(a[key])
            assert rel(a[key], b[key]) <= bar, (a["epoch"], key, a[key],
                                                b[key])


# ------------------------------------------------ the default run vs JAX

@pytest.fixture(scope="module")
def tel_pair(tmp_path_factory):
    """The JAX ``train()`` on 4 of its devices with its defaults
    (telemetry, health), and the port's on 4 virtual cards, from the JAX
    run's initial parameters."""
    if jax.device_count() < 4:
        pytest.skip("needs the forced JAX devices (see conftest)")
    root = tmp_path_factory.mktemp("telmesh")
    cfg = dict(BASE, name="tel", sync_init=False)
    init = jax_train(JaxTrainConfig(**{**cfg, "epochs": 0, "save": False},
                                    devices=1, telemetry=False,
                                    health=False)).state
    params, stats = to_numpy(init.params), to_numpy(init.batch_stats)
    ref = jax_train(JaxTrainConfig(**cfg, savePath=str(root / "jax"),
                                   devices=4))
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr("matcha_tpu_torch.train.state.init_workers",
                      lambda model, seed: load_into_port(model, params,
                                                         stats))
        port = train(TrainConfig(**cfg, savePath=str(root / "port"),
                                 devices=4), device="cpu")
    return port, ref


def test_mesh_journals_what_jax_mesh_journals(tel_pair):
    port, ref = tel_pair
    assert isinstance(port.state, MeshTrainState)
    got, want = events_of(port), journal.read_journal(
        os.path.join(ref.recorder.folder, "events.jsonl"))
    assert all(journal.validate_event(e) == [] for e in got)
    assert [e["kind"] for e in off_clock(got)] == \
        [e["kind"] for e in off_clock(want)]
    assert [e["label"] for e in of_kind(got, "compile")] == \
        [e["label"] for e in of_kind(want, "compile")]
    assert [e["epoch"] for e in of_kind(got, "drift")] == \
        [e["epoch"] for e in of_kind(want, "drift")]
    assert of_kind(off_clock(got), "anomaly") == \
        of_kind(off_clock(want), "anomaly")
    (backend,) = of_kind(got, "backend")
    assert backend["chosen"] == "shard_map"


def test_mesh_telemetry_within_tel_rel_of_jax(tel_pair):
    port, ref = tel_pair
    got = of_kind(events_of(port), "telemetry")
    want = of_kind(journal.read_journal(
        os.path.join(ref.recorder.folder, "events.jsonl")), "telemetry")
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        g = {k: v for k, v in g.items() if k != "t"}
        w = {k: v for k, v in w.items() if k != "t"}
        assert set(g) == set(w)
        for key, value in w.items():
            if key in EXACT:
                assert g[key] == value or (np.isnan(g[key])
                                           and np.isnan(value)), key
            elif isinstance(value, (int, float, list)):
                assert rel(g[key], value) <= TEL_REL, (key, g[key], value)
            else:
                assert g[key] == value, key


def test_mesh_heartbeats_within_tel_rel_of_jax(tel_pair):
    """The heartbeat's ``workers`` map (each worker's slot, participation
    and deviation rows gathered in worker order), and ``peak_bytes``, the
    cost ledger's largest footprint so far."""
    port, ref = tel_pair
    events = events_of(port)
    got = of_kind(events, "heartbeat")
    want = of_kind(journal.read_journal(
        os.path.join(ref.recorder.folder, "events.jsonl")), "heartbeat")
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert (g["host"], g["epoch"], g["step"], g["steps"]) == \
            (w["host"], w["epoch"], w["step"], w["steps"])
        seen = events[:events.index(g)]
        assert g["peak_bytes"] == max(e["peak_bytes"]
                                      for e in of_kind(seen, "compile"))
        assert set(g["workers"]) == set(w["workers"]) == {
            f"w{i}" for i in range(8)}
        for wid, stats in w["workers"].items():
            mine = g["workers"][wid]
            assert (mine["slot"], mine["participation"]) == \
                (stats["slot"], stats["participation"])
            assert rel(mine["disagreement"], stats["disagreement"]) \
                <= TEL_REL, wid


# ------------------------------------------------------ CHOCO's executor

def _choco_pair(n, d, cards, compressor="top_k", ratio=0.7, wire=None,
                seed=0):
    dec = (tp.select_graph(5) if n == 8 else
           tp.decompose(tp.make_graph("geometric", n, seed=1), n, seed=0))
    sched = fixed_schedule(dec, n, iterations=12, budget=0.6,
                           mode="bernoulli", seed=seed)
    kw = dict(ratio=ratio, consensus_lr=0.3, compressor=compressor, seed=4,
              wire_dtype=wire)
    return (sched, make_choco(sched, device="cpu", **kw),
            make_choco(sched, backend="shard_map", mesh=cpu_mesh(cards),
                       **kw))


@pytest.mark.parametrize("n,d", [(8, 21), (64, 1031)], ids=["8x21",
                                                           "64x1031"])
def test_choco_shard_map_is_bitwise_the_batched_form(n, d):
    """``top_k`` for C = 1, 2, 4, 8: a 10-step chain (one row all
    inactive), with and without a survivor mask and with a bf16 wire; the
    carry too, folded like the state."""
    x0 = torch.from_numpy(random_state(n, d, seed=n))
    alive = torch.ones(n)
    alive[[1, n - 3]] = 0.0
    for wire, mask in ((None, None), (None, alive), ("bf16", None)):
        for cards in CARDS:
            sched, batched, folded = _choco_pair(n, d, cards, wire=wire)
            flags = np.asarray(sched.flags[:10]).copy()
            flags[3] = 0.0
            want, wcarry = batched.run(x0, flags, alive=mask)
            got, gcarry = folded.run(shard_workers(x0, cpu_mesh(cards)),
                                     flags, alive=mask)
            assert isinstance(got, WorkerBlocks) and len(got) == cards
            assert torch.equal(gather_workers(got), want), (wire, cards)
            for key in ("x_hat", "s"):
                assert torch.equal(gather_workers(gcarry[key]),
                                   wcarry[key]), (key, cards)


def test_choco_shard_map_matches_jax_shard_map():
    """``tests/test_communicator.py:138``: the JAX ``shard_map`` CHOCO on 8
    devices, 12 steps at 16×19, at its rtol of 1e-5."""
    if jax.device_count() < 8:
        pytest.skip("needs the 8 forced JAX devices (see conftest)")
    n = 16
    jsched = jax_fixed_schedule(jtp.decompose(jtp.make_graph("ring", n), n,
                                              seed=0), n, iterations=12)
    sched = fixed_schedule(tp.decompose(tp.make_graph("ring", n), n, seed=0),
                           n, iterations=12)
    assert np.array_equal(jsched.flags, sched.flags)
    x0 = random_state(n, 19, seed=2)
    jmesh = jax_worker_mesh(8)
    jcomm = jax_make_choco(jsched, ratio=0.5, consensus_lr=0.3, mesh=jmesh,
                           backend="shard_map")
    want, _ = jax.jit(jcomm.run)(jax_shard_workers(x0, jmesh), jsched.flags)
    comm = make_choco(sched, ratio=0.5, consensus_lr=0.3,
                      backend="shard_map", mesh=cpu_mesh(8))
    got, _ = comm.run(shard_workers(torch.from_numpy(x0), cpu_mesh(8)),
                      sched.flags)
    np.testing.assert_allclose(gather_workers(got).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-6)


def test_choco_stochastic_contracts_on_the_mesh():
    """``random_k`` on 4 and 8 cards, after JAX's contract: the carried
    key advances, a chain is reproducible, and 300 steps contract the
    disagreement tenfold; the first step keeps exactly k coordinates a
    row; each card draws its own stream (C = 4 and 8 differ), and C = 1
    is the batched form bitwise."""
    n, d = 16, 13
    sched = fixed_schedule(tp.decompose(tp.make_graph("ring", n), n, seed=0),
                           n, iterations=300)
    x0 = torch.from_numpy(random_state(n, d, seed=2))
    runs = {}
    for cards in (1, 4, 8):
        comm = make_choco(sched, ratio=0.5, consensus_lr=0.3,
                          compressor="random_k", seed=3, backend="shard_map",
                          mesh=cpu_mesh(cards))
        xs = shard_workers(x0, cpu_mesh(cards))
        carry0 = comm.init(xs)
        assert "key" in carry0
        kept = gather_workers(comm.step(xs, carry0, torch.ones(
            sched.num_matchings))[1]["x_hat"]) != 0
        assert kept.sum(dim=1).tolist() == [top_k_ratio_size(d, 0.5)] * n
        got, carry = comm.run(xs, sched.flags)
        again, _ = comm.run(xs, sched.flags)
        assert torch.equal(gather_workers(got), gather_workers(again))
        assert not torch.equal(carry["key"], carry0["key"])
        assert float(worker_disagreement(gather_workers(got))) \
            < 0.1 * float(worker_disagreement(x0))
        runs[cards] = gather_workers(got)
    assert not torch.equal(runs[4], runs[8])
    batched = make_choco(sched, ratio=0.5, consensus_lr=0.3,
                         compressor="random_k", seed=3, device="cpu")
    assert torch.equal(batched.run(x0, sched.flags)[0], runs[1])


def test_choco_stochastic_chain_resumes_bitwise():
    """``run`` over a flag stream split in two, the carry (generator state
    included) handed across, is the whole stream's run bit for bit."""
    n = 16
    sched = fixed_schedule(tp.decompose(tp.make_graph("ring", n), n, seed=0),
                           n, iterations=20)
    mesh = cpu_mesh(4)
    comm = make_choco(sched, ratio=0.5, compressor="top_k_q8", seed=9,
                      backend="shard_map", mesh=mesh)
    xs = shard_workers(torch.from_numpy(random_state(n, 11, seed=5)), mesh)
    whole, wcarry = comm.run(xs, sched.flags)
    half, hcarry = comm.run(xs, sched.flags[:7])
    rest, rcarry = comm.run(half, sched.flags[7:], hcarry)
    assert torch.equal(gather_workers(rest), gather_workers(whole))
    assert torch.equal(rcarry["key"], wcarry["key"])


def test_choco_encode_probe_and_message_bytes_on_the_mesh():
    """The folded encode probe is the batched one card by card; the
    message bytes count one ``[L, k]`` value and index block from each
    other card a partner sits on (none at C = 1)."""
    sched, batched, folded = _choco_pair(8, 21, 4)
    x = torch.from_numpy(random_state(8, 21, seed=1))
    mesh = cpu_mesh(4)
    probe = folded.encode_probe(shard_workers(x, mesh),
                                shard_workers(torch.zeros_like(x), mesh))
    assert torch.equal(gather_workers(probe),
                       batched.encode_probe(x, torch.zeros_like(x)))
    assert folded_message_bytes(sched, 1, 21, 0.7) == 0
    k = top_k_ratio_size(21, 0.7)
    # ring-8 on 4 cards of 2: each card's rows meet its two neighbour cards
    assert folded_message_bytes(sched, 4, 21, 0.7) == 4 * 2 * 2 * k * 8
    assert folded_message_bytes(sched, 4, 21, 0.7, "bf16") == \
        4 * 2 * 2 * k * 6


# ------------------------------------------------------------ centralized

@pytest.mark.parametrize("cards", CARDS)
def test_centralized_on_the_mesh_within_f32_rounding_of_one_card(cards):
    """The folded mean against one card's, with a survivor mask and a bf16
    wire (quarantined rows keep their unquantized values)."""
    x = torch.from_numpy(random_state(16, 301, seed=cards))
    alive = torch.ones(16)
    alive[[0, 9]] = 0.0
    scale = float(x.abs().max())
    for wire in (None, "bf16"):
        comm = make_centralized(wire_dtype=wire)
        for mask in (None, alive):
            want, _ = comm.step(x, (), None, *(() if mask is None
                                               else (mask,)))
            got, _ = comm.step(shard_workers(x, cpu_mesh(cards)), (), None,
                               *(() if mask is None else (mask,)))
            got = gather_workers(got)
            assert float((got - want).abs().max()) <= 1e-6 * scale
            if mask is not None:
                dead = mask == 0
                assert torch.equal(got[dead], x[dead])


# ------------------------------------------------------ train() on a mesh

@pytest.fixture(scope="module")
def mesh_root(tmp_path_factory):
    return tmp_path_factory.mktemp("meshruns")


def pair(root, name, **over):
    """The port's ``train()`` on 4 virtual cards and on one card."""
    cfg = TrainConfig(**{**BASE, **over}, name=name, savePath=str(root))
    mesh = train(dataclasses.replace(cfg, devices=4, name=f"{name}_mesh"),
                 device="cpu")
    one = train(cfg, device="cpu")
    return mesh, one


@pytest.mark.parametrize("over", [
    dict(communicator="choco", compress_ratio=0.7, epochs=2,
         measure_comm_split=True),
    dict(communicator="centralized"),
    dict(local_steps=2),
], ids=["choco", "centralized", "local_steps"])
def test_train_on_the_mesh_against_one_card(mesh_root, over):
    name = "_".join(str(v) for v in over.values()).replace(".", "")
    epochs = over.get("epochs", BASE["epochs"])
    mesh, one = pair(mesh_root, name, **over)
    assert isinstance(mesh.state, MeshTrainState)
    if over.get("communicator") == "centralized":
        # every row is the mean: the disagreement is rounding on both
        assert_runs_agree(mesh, one, keys=("loss", "test_loss_mean"))
        assert all(h["disagreement"] <= 1e-8
                   for h in mesh.history + one.history)
    else:
        assert_runs_agree(mesh, one)
    assert len(mesh.history) == epochs
    got, want = of_kind(events_of(mesh), "telemetry"), \
        of_kind(events_of(one), "telemetry")
    assert [(e["steps"], e["matchings_mean"], e["wire_bytes"])
            for e in got] == \
        [(e["steps"], e["matchings_mean"], e["wire_bytes"]) for e in want]
    if "local_steps" in over:
        # every other step exchanges: half the schedule's matchings
        assert got[0]["matchings_mean"] < float(np.mean(
            np.asarray(mesh.schedule.flags[:4]).sum(axis=1)))


def test_choco_checkpoint_on_the_mesh_resumes_bitwise(mesh_root):
    """CHOCO with ``random_k`` on 4 virtual cards, 2 epochs, against the
    same run cut after epoch 0 and resumed: parameters, momentum and the
    folded carry bitwise, the generator state equal.  The checkpoint
    holds the one-card format: ``[N, D]`` ``x̂`` and ``s``."""
    cfg = TrainConfig(**{**BASE, "epochs": 2}, communicator="choco",
                      compressor="random_k", compress_ratio=0.7, devices=4,
                      savePath=str(mesh_root))
    whole = train(dataclasses.replace(cfg, name="rk_whole"), device="cpu")
    train(dataclasses.replace(cfg, name="rk_cut", epochs=1,
                              checkpoint_every=1), device="cpu")
    payload = torch.load(os.path.join(mesh_root, "rk_cut_ckpt", "0",
                                      "state.pt"), weights_only=True)
    dim = flat_rows(whole).shape[1]
    assert tuple(payload["comm_carry"]["x_hat"].shape) == (8, dim)
    assert tuple(payload["comm_carry"]["s"].shape) == (8, dim)
    resumed = train(dataclasses.replace(cfg, name="rk_cut"),
                    resume_dir=str(mesh_root / "rk_cut_ckpt"), device="cpu")
    assert [h["epoch"] for h in resumed.history] == [1]
    assert torch.equal(flat_rows(resumed), flat_rows(whole))
    for key in ("x_hat", "s"):
        assert torch.equal(gather_workers(resumed.state.comm_carry[key]),
                           gather_workers(whole.state.comm_carry[key]))
    assert torch.equal(resumed.state.comm_carry["key"],
                       whole.state.comm_carry["key"])
    for a, b in zip(whole.state.cards, resumed.state.cards):
        for p, q in zip(a.model.parameters(), b.model.parameters()):
            assert torch.equal(a.optimizer.state[p]["momentum_buffer"],
                               b.optimizer.state[q]["momentum_buffer"])


def test_identity_knobs_on_the_mesh_are_bitwise_unsupervised(mesh_root):
    cfg = TrainConfig(**{**BASE, "epochs": 2}, devices=4,
                      savePath=str(mesh_root))
    plain = train(dataclasses.replace(cfg, name="id_plain"), device="cpu")
    harness = serve.TrainerHarness({})
    sup = train(dataclasses.replace(cfg, name="id_sup"), device="cpu",
                boundary_hook=harness.on_boundary)
    assert isinstance(sup.state.control, serve.ControlKnobs)
    assert torch.equal(flat_rows(plain), flat_rows(sup))
    rows = lambda r: [(h["loss"], h["disagreement"], h["accuracy"])
                      for h in r.history]
    assert rows(plain) == rows(sup)


def _swap_hook(harness, control):
    """A budget swap (0.25) before epoch 1 and a cadence swap
    (``local_steps=2``) before epoch 2, then ``harness``."""
    def hook(seam):
        if seam.epoch == 1:
            serve.write_control(control, {"version": 1, "budget": 0.25})
        elif seam.epoch == 2:
            serve.write_control(control, {"version": 2, "local_steps": 2})
        harness.on_boundary(seam)

    return hook


def test_swaps_on_the_mesh_against_one_card(mesh_root):
    """The same control documents through a mesh run and a one-card run:
    the same knobs journaled, the epochs within the acceptance bar, the
    telemetry's counts equal (the swapped budget and the cadence)."""
    runs = {}
    for label, devices in (("one", None), ("mesh", 4)):
        root = mesh_root / f"swap_{label}"
        control = str(root / "control.json")
        cfg = TrainConfig(**BASE, devices=devices, name=f"swap_{label}",
                          savePath=str(root))
        runs[label] = train(cfg, device="cpu", boundary_hook=_swap_hook(
            serve.TrainerHarness({"control_path": control,
                                  "serving_dir": str(root / "serving"),
                                  "promote_every": 1}), control))
    mesh, one = runs["mesh"], runs["one"]
    assert_runs_agree(mesh, one)
    # the promotions read the consensus of every card's rows
    promos = lambda r: of_kind(events_of(r), "promotion")
    assert [e["epoch"] for e in promos(mesh)] == [1, 2]
    for a, b in zip(promos(mesh), promos(one), strict=True):
        assert a["action"] == b["action"]
        assert rel(a["test_loss"], b["test_loss"]) <= RUN_REL
    strip = lambda e: (e["action"], e["applied"], e["epoch"], e["fields"])
    assert [strip(e) for e in of_kind(events_of(mesh), "control")] == \
        [strip(e) for e in of_kind(events_of(one), "control")]
    counts = lambda r: [(e["steps"], e["matchings_mean"], e["wire_bytes"])
                        for e in of_kind(events_of(r), "telemetry")]
    assert counts(mesh) == counts(one)
    assert mesh.state.control.local_every == 2
    assert torch.equal(mesh.state.control.row_scale,
                       one.state.control.row_scale)


def test_consensus_snapshot_reads_every_card(mesh_root):
    """The promotion's consensus arrays and metrics of a mesh state are
    the one-card functions' on the gathered state, to f32 rounding."""
    cfg = TrainConfig(**{**BASE, "epochs": 1, "save": False}, devices=4)
    mesh = train(cfg, device="cpu")
    one = train(dataclasses.replace(cfg, devices=None), device="cpu")
    state, flattener = mesh.state, WorkerFlattener(
        mesh.state.cards[0].params)
    # the one-card state, loaded with the mesh's rows
    with torch.no_grad():
        for name, p in one.state.model.named_parameters():
            p.copy_(torch.cat([dict(c.model.named_parameters())[name]
                               for c in state.cards]))
        for name, b in one.state.model.named_buffers():
            b.copy_(torch.cat([dict(c.model.named_buffers())[name]
                               for c in state.cards]))
    got = serve.snapshot_consensus(state, flattener)
    want = serve.snapshot_consensus(one.state,
                                    WorkerFlattener(one.state.params))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6,
                                   atol=1e-7)
    data = build_dataset(cfg)
    x, y = data.x_test, data.y_test
    a = serve.consensus_metrics(state, x, y)
    b = serve.consensus_metrics(one.state, x, y)
    assert rel(a["test_loss"], b["test_loss"]) <= 1e-5
    assert a["test_acc"] == b["test_acc"]


def test_trace_dir_epoch_on_a_cpu_mesh(mesh_root):
    """One profiler window over the mesh's epoch: the step's ranges are on
    its host timeline (``comm/step`` around the folded mix), the traced
    run is bitwise the untraced one, and the CPU capture has no device
    rows to attribute."""
    trace_dir = str(mesh_root / "trace")
    cfg = TrainConfig(**{**BASE, "epochs": 1, "save": False}, devices=4,
                      trace_dir=trace_dir)
    traced = train(cfg, device="cpu")
    plain = train(dataclasses.replace(cfg, trace_dir=None), device="cpu")
    assert torch.equal(flat_rows(traced), flat_rows(plain))
    events = xprof.load_trace_events(xprof.find_trace_file(trace_dir))
    names = {e.get("name") for e in events
             if e.get("cat") == "user_annotation"}
    assert {"comm/step", "matcha/fwd_bwd", "matcha/sgd"} <= names
    with pytest.raises(xprof.TraceParseError, match="no device rows"):
        xprof.profile_report(trace_dir)


def _row(corr, ts, dur, device, phase_range=None):
    """A kernel on ``device`` launched at ``ts`` (host) inside a range."""
    host_ts = 100.0 * corr
    rows = [{"ph": "X", "cat": "kernel", "name": f"k{corr}", "pid": device,
             "tid": 7, "ts": ts, "dur": dur,
             "args": {"correlation": corr, "device": device}},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
             "pid": 99, "tid": 1, "ts": host_ts + 2.0, "dur": 1.0,
             "args": {"correlation": corr}}]
    if phase_range:
        rows.append({"ph": "X", "cat": "user_annotation",
                     "name": phase_range, "pid": 99, "tid": 1,
                     "ts": host_ts, "dur": 10.0})
    return rows


def test_profile_sums_cards_and_splits_them():
    """Two cards whose exchanges run at the same wall time: the report
    sums their device seconds (a union would count one), each card's
    overlap is its own, and ``per_device`` splits rows and seconds."""
    events = (_row(1, 1000.0, 10.0, 0, "comm/step")
              + _row(2, 1000.0, 10.0, 1, "comm/step")
              + _row(3, 1005.0, 10.0, 0, "matcha/fwd_bwd")
              + _row(4, 1100.0, 20.0, 1, "matcha/sgd"))
    rep = xprof.overlap_report(events)
    assert rep["rows"] == {"comm": 2, "comp": 2, "other": 0}
    assert rep["comm_seconds"] == pytest.approx(20e-6, abs=1e-12)
    assert rep["comp_seconds"] == pytest.approx(30e-6, abs=1e-12)
    assert rep["overlap_seconds"] == pytest.approx(5e-6, abs=1e-12)
    assert rep["overlap_fraction"] == pytest.approx(0.25)
    assert set(rep["per_device"]) == {"0", "1"}
    assert rep["per_device"]["0"]["overlap_seconds"] == \
        pytest.approx(5e-6, abs=1e-12)
    assert rep["per_device"]["1"]["rows"] == {"comm": 1, "comp": 1,
                                              "other": 0}
    assert rep["per_device"]["1"]["overlap_seconds"] == 0.0
