"""The worker mesh across processes (``parallel/multihost.py`` of the port)
against the JAX package's ``parallel/multihost.py``, its two-process smoke
(``tests/test_multihost.py``, ``tests/_multihost_child.py``) and the
port's one-process folded runs.

Every cross-process case shares one module-scoped launch of
``python -m matcha_tpu_torch.probes.multihost_smoke``: 2 processes × 2 CPU
cards (C = 4), gloo, a FileStore under ``tmp_path``, the ``tiny``
profile (``[8, 37]`` on zoo graph 5 and ``[16, 64]`` on zoo graph 4,
fixed Bernoulli schedules at budget 0.5), with a hard limit of 60 s past
which the processes are killed.  The processes write their cards' rows
to npz files; this process compares them, so no child imports JAX.

Bars, and why:

* Across processes against the one-process folded run of the same fold
  (4 CPU cards in one process): bitwise.  The exchange moves each block's
  wire image byte for byte, and the means sum the per-card partials in
  card order, so no arithmetic differs.  ``perm`` and ``fused`` against
  the one-card communicator: bitwise (their plain versions on the CPU).
* The decen chains against JAX's ``make_decen(..., backend="shard_map")``
  on 4 of conftest's forced CPU devices and against the dense ``W_t``
  chain in float64: ``rtol=1e-5, atol=1e-6``, the bars of
  ``_multihost_child.py`` (XLA may fuse the JAX body otherwise).
* CHOCO against JAX's CHOCO ``shard_map``: ``tests/test_torch_choco.py``'s
  chained bar, ``rtol=0, atol=1e-5`` (a few f32 steps of ulps on values of
  order 1; the selected coordinates agree at these seeds).
"""

import json
import os
import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matcha_tpu import topology as jtp
from matcha_tpu.communicator import make_choco as jax_make_choco
from matcha_tpu.communicator import make_decen as jax_make_decen
from matcha_tpu.parallel import dcn_aware_worker_order as jax_dcn_order
from matcha_tpu.parallel import initialize_multihost as jax_initialize
from matcha_tpu.parallel import shard_workers as jax_shard_workers
from matcha_tpu.parallel import worker_mesh as jax_worker_mesh
from matcha_tpu.schedule import fixed_schedule as jax_fixed_schedule
from matcha_tpu_torch.communicator import make_decen
from matcha_tpu_torch.parallel import (
    MeshDevice,
    WorkerBlocks,
    WorkerMesh,
    dcn_aware_worker_order,
    folded_allreduce_mean,
    gather_workers,
    global_worker_mesh,
    initialize_multihost,
    masked_mean_rows,
    shard_workers,
    split_like,
    worker_mesh,
)
from matcha_tpu_torch.parallel.gossip import _card_tables
from matcha_tpu_torch.parallel.folded import build_folded_plan
from matcha_tpu_torch.probes import multihost_smoke as smoke

LIMIT = 60.0
RTOL, ATOL = 1e-5, 1e-6
CARDS = 4
CASES = {case.label: case for case in smoke.TINY}
DECEN = ("shard_map", "skip", "alive", "bf16_wire")


# ------------------------------------------------------------ the launch

@pytest.fixture(scope="module")
def launch(tmp_path_factory):
    """The one two-process run every cross-process case reads: exit
    codes, wall seconds, each rank's record and rows (by card)."""
    out = str(tmp_path_factory.mktemp("multihost"))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    t0 = time.monotonic()
    rcs = smoke.wait_all(smoke.spawn(
        2, out, ["--profile", "tiny", "--device", "cpu", "--cards", "2",
                 "--save-rows", "--reps", "1", "--timeout", "50"],
        env=env),
        LIMIT)
    elapsed = time.monotonic() - t0
    logs = []
    for rank in range(2):
        with open(os.path.join(out, f"rank{rank}.log")) as f:
            logs.append(f.read()[-3000:])
    records, rows = [], {}
    for rank in range(2):
        path = os.path.join(out, f"rank{rank}.json")
        if os.path.exists(path):
            with open(path) as f:
                records.append(json.load(f))
            with np.load(os.path.join(out, f"rank{rank}.npz")) as z:
                cards = z["cards"].tolist()
                for key in z.files:
                    if key != "cards":
                        for c, block in zip(cards, z[key]):
                            rows.setdefault(key, {})[c] = block
    check = None
    if os.path.exists(os.path.join(out, "check.json")):
        with open(os.path.join(out, "check.json")) as f:
            check = json.load(f)
    return {"rcs": rcs, "elapsed": elapsed, "logs": logs,
            "records": records, "rows": rows, "check": check}


def ran(launch):
    assert launch["rcs"] == [0, 0], (launch["rcs"], launch["logs"])
    return launch


def across(launch, key) -> np.ndarray:
    """The ``[N, D]`` rows of one result, both ranks' cards in order."""
    by_card = ran(launch)["rows"][key]
    assert sorted(by_card) == list(range(CARDS))
    return np.concatenate([by_card[c] for c in range(CARDS)])


_ONE = {}


def one_process(label):
    """The one-process folded run of every scenario of a case (4 CPU
    cards in this process), once per module."""
    if label not in _ONE:
        case = CASES[label]
        sched = smoke.case_schedule(case)
        got = smoke.run_case(worker_mesh(devices=["cpu"] * CARDS), case,
                             sched)
        _ONE[label] = (sched, {name: {k: gather_workers(v)
                                      for k, v in res.items()}
                               for name, res in got.items()})
    return _ONE[label]


def test_two_processes_within_the_limit(launch):
    """Both processes exit 0 inside the hard limit, and the first one's own
    check (every result gathered and held bitwise to the one-process run
    and, for perm and fused, the one-card call) passed."""
    ran(launch)
    assert launch["elapsed"] < LIMIT
    assert launch["check"]["ok"] is True
    bitwise = launch["check"]["cases"]
    assert set(bitwise) == set(CASES)
    assert all(all(v["bitwise"].values()) for v in bitwise.values())


def test_global_mesh_spans_both_processes(launch):
    """``global_worker_mesh`` over 2 processes of 2 CPU cards: one list
    on both, in rank order, each process holding its own two cards; the
    entries' ``(process_index, id)`` as ``dcn_aware_worker_order`` reads
    them; the group initialized over gloo."""
    records = ran(launch)["records"]
    for rank, rec in enumerate(records):
        assert rec["rank"] == rank and rec["world"] == 2
        assert rec["backend"] == "gloo"
        assert rec["devices"] == ["cpu"] * CARDS
        assert rec["ranks"] == [0, 0, 1, 1]
        assert rec["cards"] == [2 * rank, 2 * rank + 1]
        assert rec["entries"] == [[0, 0], [0, 1], [1, 2], [1, 3]]
        assert rec["spawn_to_group_seconds"] > 0
        for entry in rec["cases"].values():
            assert entry["bytes_sent"] > 0 and entry["messages_sent"] > 0
            assert entry["launches"] == {}  # the CPU: plain versions
            timed = entry["timings"]
            assert set(timed) == {f"{k}_{m}" for k in (
                "shard_map_step", "choco_step", "perm_step")
                for m in ("ms", "bytes_sent")}
            assert all(v > 0 for v in timed.values())


@pytest.mark.parametrize("label", sorted(CASES))
@pytest.mark.parametrize("scenario", smoke.TINY[0].scenarios)
def test_across_processes_is_bitwise_one_process(launch, label, scenario):
    """Each scenario's every result across 2 processes bitwise the same
    fold run in one process."""
    _, want = one_process(label)
    for key, tensor in want[scenario].items():
        got = across(launch, f"{label}/{scenario}/{key}")
        assert np.array_equal(got, tensor.to(torch.float32).numpy()), key


def jax_schedule(case):
    sched = jax_fixed_schedule(jtp.select_graph(int(case.graph[3:])),
                               case.workers, max(case.steps, 8), budget=0.5,
                               mode="bernoulli", seed=case.seed)
    return sched


def dense_oracle(sched, x0, flags, alive=None):
    """The ``W_t`` chain in float64, the Laplacians masked by the
    survivors (``masked_laplacians``' rule)."""
    n = x0.shape[0]
    perms = np.asarray(sched.perms)
    want = x0.astype(np.float64)
    a = np.ones(n) if alive is None else np.asarray(alive, np.float64)
    for t in range(flags.shape[0]):
        w = np.eye(n)
        for j in range(perms.shape[0]):
            weight = float(sched.alpha) * float(flags[t, j])
            for i in range(n):
                p = perms[j, i]
                if p != i:
                    gate = a[i] * a[p]
                    w[i, i] -= weight * gate
                    w[i, p] += weight * gate
        want = w @ want
    return want


@pytest.mark.parametrize("label", sorted(CASES))
@pytest.mark.parametrize("scenario", DECEN)
def test_decen_chains_match_jax_shard_map_and_the_dense_oracle(
        launch, label, scenario):
    """The folded chains across processes against JAX's ``shard_map``
    backend on 4 forced devices (the same flags: ``skip`` with its
    inactive step, the survivor mask, the bf16 wire) and, on an f32 wire,
    against the float64 dense chain."""
    if jax.device_count() < CARDS:
        pytest.skip("needs 4 forced JAX devices (see conftest)")
    case = CASES[label]
    sched, _ = one_process(label)
    jsched = jax_schedule(case)
    assert np.array_equal(np.asarray(jsched.flags), np.asarray(sched.flags))
    x0 = smoke.case_state(case, "cpu").numpy()
    flags = np.asarray(sched.flags[:case.steps], np.float32)
    if scenario == "skip":
        flags = smoke.skip_flags(flags)
    alive = (smoke.case_alive(case).numpy() if scenario == "alive"
             else None)
    got = across(launch, f"{label}/{scenario}/x")
    jmesh = jax_worker_mesh(CARDS)
    comm = jax_make_decen(jsched, mesh=jmesh, backend="shard_map",
                          wire_dtype="bf16" if scenario == "bf16_wire"
                          else None)
    want, _ = jax.jit(comm.run)(
        jax_shard_workers(jnp.asarray(x0), jmesh), jnp.asarray(flags),
        alive=None if alive is None else jnp.asarray(alive))
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    if scenario != "bf16_wire":
        np.testing.assert_allclose(got, dense_oracle(sched, x0, flags,
                                                     alive),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("label", sorted(CASES))
@pytest.mark.parametrize("name,key", [("perm", "step"), ("perm", "run"),
                                      ("fused", "run")])
def test_one_tensor_backends_bitwise_one_tensor(launch, label, name, key):
    """``perm`` and ``fused`` across processes (the state gathered onto
    the first card's process, the plain versions on the CPU) bitwise the
    one-card communicator on the ``[N, D]`` tensor."""
    case = CASES[label]
    sched, _ = one_process(label)
    x = smoke.case_state(case, "cpu")
    flags = np.asarray(sched.flags[:case.steps], np.float32)
    if name == "perm":
        comm = make_decen(sched, "perm", device="cpu")
        want = (comm.step(x, (), torch.as_tensor(flags[0]))[0]
                if key == "step" else comm.run(x, flags)[0])
    else:
        want = make_decen(sched, "fused", device="cpu",
                          compute_dtype=torch.bfloat16).run(x, flags)[0]
    assert np.array_equal(across(launch, f"{label}/{name}/{key}"),
                          want.numpy())


@pytest.mark.parametrize("label", sorted(CASES))
def test_choco_matches_jax_shard_map(launch, label):
    """CHOCO's folded backend across processes (its top-k messages moved
    between them) against JAX's CHOCO ``shard_map`` on 4 forced devices:
    one step from the zero carry and the 4-step run, state and carry."""
    if jax.device_count() < CARDS:
        pytest.skip("needs 4 forced JAX devices (see conftest)")
    case = CASES[label]
    jsched = jax_schedule(case)
    x0 = smoke.case_state(case, "cpu").numpy()
    jmesh = jax_worker_mesh(CARDS)
    comm = jax_make_choco(jsched, ratio=case.choco_ratio,
                          consensus_lr=case.consensus_lr, mesh=jmesh,
                          backend="shard_map")
    xs = jax_shard_workers(jnp.asarray(x0), jmesh)
    flags = jnp.asarray(np.asarray(jsched.flags[:4], np.float32))
    step, carry = jax.jit(comm.step)(xs, comm.init(xs), flags[0])
    run, rcarry = jax.jit(comm.run)(xs, flags)
    for key, want in (("step_x", step), ("step_x_hat", carry["x_hat"]),
                      ("step_s", carry["s"]), ("run_x", run),
                      ("run_x_hat", rcarry["x_hat"]),
                      ("run_s", rcarry["s"])):
        np.testing.assert_allclose(across(launch, f"{label}/choco/{key}"),
                                   np.asarray(want), rtol=0, atol=1e-5,
                                   err_msg=key)


@pytest.mark.parametrize("label", sorted(CASES))
def test_centralized_bitwise_the_folded_mean(launch, label):
    """``centralized`` across processes (every process sums the 4 cards'
    column sums in card order) bitwise the one-process
    ``folded_allreduce_mean``, plain and masked."""
    case = CASES[label]
    mesh = worker_mesh(devices=["cpu"] * CARDS)
    xs = shard_workers(smoke.case_state(case, "cpu"), mesh)
    mean = gather_workers(folded_allreduce_mean(xs))
    masked = gather_workers(folded_allreduce_mean(xs, smoke.case_alive(case)))
    assert np.array_equal(across(launch, f"{label}/centralized/mean"),
                          mean.numpy())
    assert np.array_equal(across(launch, f"{label}/centralized/masked"),
                          masked.numpy())


def test_another_schedule_is_refused_at_build(launch):
    """Rank 1 builds ``make_decen`` on a flag stream with one entry
    flipped: the digests' all-gather raises ``ValueError`` on both ranks,
    naming rank 1."""
    for rec in ran(launch)["records"]:
        msg = rec["refusals"]["schedule_digest"]
        assert msg is not None and "ranks [1]" in msg
        assert "differs across processes" in msg


def test_train_refuses_a_process_group(launch):
    """``train()`` under a group of 2 raises on each rank, saying that
    across processes the port runs the communicators."""
    for rank, rec in enumerate(ran(launch)["records"]):
        msg = rec["refusals"]["train"]
        assert msg is not None
        assert f"rank {rank} of a torch.distributed group of 2" in msg
        assert "communicators" in msg


# ------------------------------------------------ the three functions

def test_initialize_multihost_returns_false_without_arguments(monkeypatch):
    """No arguments and no cluster environment: False from both packages,
    and no group."""
    for key in ("MASTER_ADDR", "WORLD_SIZE", "JAX_COORDINATOR_ADDRESS",
                "COORDINATOR_ADDRESS"):
        monkeypatch.delenv(key, raising=False)
    assert initialize_multihost() is False
    assert jax_initialize() is False
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("cuda_visible, devices, backend, want", [
    (True, ["cpu", "cpu"], None, "gloo"),
    (True, None, None, "nccl"),
    (True, ["cuda:0"], None, "nccl"),
    (False, None, None, "gloo"),
    (True, None, "gloo", "gloo"),
])
def test_default_backend_follows_this_process_cards(monkeypatch, tmp_path,
                                                    cuda_visible, devices,
                                                    backend, want):
    """The default backend is decided by the cards this process will
    hold, not by whether CUDA is visible: a CPU launch on a host with a
    card joins gloo (NCCL would be handed host tensors); an explicit
    backend is kept."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda_visible)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    called = {}

    def record(backend, **kwargs):
        called.update(backend=backend, **kwargs)

    monkeypatch.setattr(torch.distributed, "init_process_group", record)
    assert initialize_multihost(f"file://{tmp_path}/store", 2, 0,
                                backend=backend, devices=devices) is True
    assert called["backend"] == want
    assert called["world_size"] == 2 and called["rank"] == 0
    assert not torch.distributed.is_initialized()


def test_bad_coordinator_reraises_within_its_timeout():
    """A coordinator nobody serves, with a 5 s timeout: the rendezvous
    error re-raises (never False, never a hang) inside the limit."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.monotonic()
    with pytest.raises(torch.distributed.DistError, match="timed out"):
        initialize_multihost(f"127.0.0.1:{port}", num_processes=2,
                             process_id=1, backend="gloo", timeout=5)
    assert time.monotonic() - t0 < 30
    assert not torch.distributed.is_initialized()


class FakeDevice:
    """Stand-in for a device: the two fields the ordering reads."""

    def __init__(self, process_index, dev_id):
        self.process_index = process_index
        self.id = dev_id


def fake_two_hosts(hosts=2, chips_per_host=4):
    """``tests/test_multihost.py:38``'s topology: host-interleaved."""
    devs = []
    for c in range(chips_per_host):
        for h in range(hosts):
            devs.append(FakeDevice(h, h * chips_per_host + c))
    return devs


def cross_host_ring_edges(device_order, n=16):
    rows = n // len(device_order)
    host = [device_order[g // rows].process_index for g in range(n)]
    return sum(host[i] != host[(i + 1) % n] for i in range(n))


@pytest.mark.parametrize("hosts,chips", [(2, 4), (4, 2), (2, 2)])
def test_dcn_order_matches_jax_on_fake_hosts(hosts, chips):
    """The fake multi-host topology through both functions: the same
    order, each host's chips together, and (2 × 4, as the JAX test) a
    16-worker ring crossing hosts on 2 edges instead of 8."""
    devs = fake_two_hosts(hosts, chips)
    got = dcn_aware_worker_order(16, devices=devs)
    want = jax_dcn_order(16, devices=devs)
    assert [id(d) for d in got] == [id(d) for d in want]
    assert [(d.process_index, d.id) for d in got] == sorted(
        (d.process_index, d.id) for d in devs)
    if (hosts, chips) == (2, 4):
        assert cross_host_ring_edges(list(got)) == 2
        assert cross_host_ring_edges(devs) == 8


def test_dcn_order_of_mesh_entries_builds_a_mesh():
    """The port's own entries (``MeshDevice``) sort the same way and build
    a mesh that spans their processes."""
    entries = [MeshDevice(torch.device("cpu"), d.process_index, d.id)
               for d in fake_two_hosts()]
    ordered = dcn_aware_worker_order(16, devices=entries)
    mesh = worker_mesh(devices=list(ordered))
    assert mesh.ranks == (0, 0, 0, 0, 1, 1, 1, 1) and mesh.rank == 0
    assert mesh.local_cards == (0, 1, 2, 3) and mesh.multi_process
    assert [(e.process_index, e.id) for e in mesh.entries] == [
        (0, c) for c in range(4)] + [(1, c) for c in range(4, 8)]


@pytest.mark.parametrize("num_workers", [9, 17, 3])
def test_dcn_order_refuses_what_does_not_divide(num_workers):
    devs = fake_two_hosts()
    with pytest.raises(ValueError):
        dcn_aware_worker_order(num_workers, devices=devs)
    with pytest.raises(ValueError):
        jax_dcn_order(num_workers, devices=devs)


def test_global_worker_mesh_outside_a_group():
    """With no group the global mesh is the one-process mesh, as JAX's is
    ``worker_mesh()``."""
    mesh = global_worker_mesh(devices=["cpu"] * 4)
    assert mesh == worker_mesh(devices=["cpu"] * 4)
    assert not mesh.multi_process and mesh.local_cards == (0, 1, 2, 3)


# ------------------------------- one process's view of a two-process mesh

def rank_view(rank, cards=4, owners=(0, 0, 1, 1)):
    return WorkerMesh(tuple(torch.device("cpu") for _ in range(cards)),
                      ranks=owners, rank=rank)


@pytest.mark.parametrize("rank", [0, 1])
def test_blocks_hold_this_process_cards(rank):
    """On a mesh that spans processes ``shard_workers`` keeps this
    process's rows, ``split_like`` cuts a mask the same way, block
    arithmetic keeps the mesh, and ``gather_workers`` refuses."""
    mesh = rank_view(rank)
    x = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    xs = shard_workers(x, mesh)
    assert xs.cards == (2 * rank, 2 * rank + 1)
    assert torch.equal(torch.cat(list(xs)), x[4 * rank:4 * rank + 4])
    gates = split_like(torch.arange(8.0), xs)
    assert torch.equal(torch.cat(list(gates)),
                       torch.arange(8.0)[4 * rank:4 * rank + 4])
    assert (xs + xs).mesh is mesh and xs.zeros_like().mesh is mesh
    with pytest.raises(ValueError):
        gather_workers(xs)


def test_exchange_moves_follow_the_plan():
    """The ``(card, offset)`` pairs the exchange reads cover exactly the
    cross-card parts of each matching, for every card, whatever process
    holds it."""
    case = CASES["16x64"]
    sched = smoke.case_schedule(case)
    plan = build_folded_plan(np.asarray(sched.perms), CARDS)
    _, tables, needs = _card_tables(plan, [None, None, "cpu", "cpu"])
    assert tables[0] is None and tables[1] is None
    for j, parts in enumerate(plan.matchings):
        want = sorted((c, p.offset) for p in parts if p.offset
                      for c in range(CARDS) if p.mask[c].any())
        assert sorted(needs[j]) == want
        for c in (2, 3):
            pieces, _ = tables[c][j]
            assert {d for d, _, _ in pieces} - {0} == {
                d for cc, d in needs[j] if cc == c}


def test_masked_mean_of_a_partial_view_needs_the_group():
    """A process's view alone cannot form a mean over cards it does not
    hold: without an initialized group the exchange refuses."""
    mesh = rank_view(0)
    xs = shard_workers(torch.ones(8, 3), mesh)
    with pytest.raises((RuntimeError, ValueError)):
        masked_mean_rows(xs, torch.ones(8))
    assert isinstance(xs, WorkerBlocks)
