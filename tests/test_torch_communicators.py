"""The port's other communicators against the JAX package's: the
centralized AllReduce (with and without a survivor mask, on an f32 and a
bf16 wire), ``none``, the skip backend (``gossip_mix_skip``), and the
per-matching byte account and per-worker deviation.

Tolerances:

* ``none``, ``matching_wire_bytes``: exact.
* ``centralized`` and ``worker_deviation_rows``: a mean over N rows, which
  XLA and PyTorch sum in other orders, so within ``N`` f32 ulps of the
  largest value (``worker_deviation_rows``: of the largest deviation).
* ``gossip_mix_skip`` against the JAX one: the JAX form adds each active
  matching to ``x`` in turn, the port sums them first (as ``gossip_mix``
  does), so within one f32 ulp of the state's magnitude per matching.
* The skip backend against the port's ``gather`` backend: bitwise on
  finite inputs, single steps and whole flag streams, with a survivor
  mask and on a bf16 wire, and through ``train()``.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matcha_tpu import topology as jtp
from matcha_tpu.communicator import make_centralized as jax_make_centralized
from matcha_tpu.communicator import make_none as jax_make_none
from matcha_tpu.parallel import gossip_mix_skip as jax_gossip_mix_skip
from matcha_tpu.parallel import matching_wire_bytes as jax_matching_wire_bytes
from matcha_tpu.parallel.collectives import \
    worker_deviation_rows as jax_worker_deviation_rows
from matcha_tpu.schedule import matcha_schedule as jax_matcha_schedule
from matcha_tpu_torch.communicator import (
    make_centralized,
    make_decen,
    make_none,
    select_communicator,
)
from matcha_tpu_torch.parallel import (
    gather_workers,
    gossip_mix_skip,
    matching_wire_bytes,
    shard_workers,
    worker_deviation_rows,
    worker_disagreement,
    worker_mesh,
)
from matcha_tpu_torch.schedule import matcha_schedule
from matcha_tpu_torch.topology import select_graph
from matcha_tpu_torch.train import TrainConfig, train

N, D = 8, 37
ULP = float(np.finfo(np.float32).eps)
ALIVE = np.array([1, 1, 0, 1, 1, 1, 0, 1], np.float32)
FLAGS_ROW = np.ones(4, np.float32)


def _state(seed=0, n=N, d=D):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("wire", ["f32", "bf16"])
@pytest.mark.parametrize("masked", [False, True])
def test_centralized_matches_jax(wire, masked):
    x = _state(1)
    x[2] = np.nan  # a quarantined row keeps its value under the mask
    if not masked:
        x[2] = 0.5
    alive = ALIVE if masked else None
    got, carry = make_centralized(wire).step(
        torch.from_numpy(x), (), torch.from_numpy(FLAGS_ROW),
        None if alive is None else torch.from_numpy(alive))
    want, _ = jax_make_centralized(wire).step(
        jnp.asarray(x), (), jnp.asarray(FLAGS_ROW),
        None if alive is None else jnp.asarray(alive))
    got, want = _np(got), _np(want)
    assert carry == ()
    live = np.ones(N, bool) if alive is None else alive > 0
    np.testing.assert_array_equal(got[~live], x[~live])  # unquantized
    bar = N * ULP * np.abs(x[live]).max()
    np.testing.assert_allclose(got[live], want[live], rtol=0, atol=bar)
    # the survivors all hold the one mean
    assert (got[live] == got[live][0]).all()


def test_none_is_the_identity_as_in_jax():
    x = _state(2)
    got, _ = make_none().step(torch.from_numpy(x), (),
                              torch.from_numpy(FLAGS_ROW))
    want, _ = jax_make_none().step(jnp.asarray(x), (), jnp.asarray(FLAGS_ROW))
    np.testing.assert_array_equal(_np(got), x)
    np.testing.assert_array_equal(_np(want), x)


def _schedules(gid=0, iterations=12):
    size = jtp.graph_size(gid)
    port = matcha_schedule(select_graph(gid), size, iterations, budget=0.5,
                           seed=3)
    ref = jax_matcha_schedule(jtp.select_graph(gid), size, iterations,
                              budget=0.5, seed=3)
    np.testing.assert_array_equal(port.flags, ref.flags)
    return port, ref


@pytest.mark.parametrize("wire", ["f32", "bf16"])
@pytest.mark.parametrize("masked", [False, True])
def test_gossip_mix_skip_matches_jax(wire, masked):
    port, _ = _schedules()
    x = _state(3)
    alive = ALIVE if masked else None
    ref = jax.jit(lambda xx, w: jax_gossip_mix_skip(
        xx, port.perms, w, None if alive is None else jnp.asarray(alive),
        wire_dtype=wire))
    for t in range(port.iterations):
        w = np.float32(port.alpha) * port.flags[t].astype(np.float32)
        got = gossip_mix_skip(
            torch.from_numpy(x), port.perms, torch.from_numpy(w),
            None if alive is None else torch.from_numpy(alive),
            wire_dtype=wire)
        want = ref(jnp.asarray(x), jnp.asarray(w))
        bar = max(int((w != 0).sum()), 1) * ULP * np.abs(x).max()
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=bar)


@pytest.mark.parametrize("wire", ["f32", "bf16"])
@pytest.mark.parametrize("masked", [False, True])
def test_skip_equals_gather_bitwise(wire, masked):
    port, _ = _schedules()
    flags = port.flags.copy()
    flags[4] = 0  # an all-inactive step
    x = torch.from_numpy(_state(4))
    alive = None if not masked else torch.from_numpy(ALIVE)
    skip = make_decen(port, "skip", device="cpu", wire_dtype=wire)
    gather = make_decen(port, "gather", device="cpu", wire_dtype=wire)
    assert skip.host_flags and not gather.host_flags
    for t in range(flags.shape[0]):
        row = torch.from_numpy(flags[t].astype(np.float32))
        a, _ = skip.step(x, (), row, alive)
        b, _ = gather.step(x, (), row, alive)
        assert torch.equal(a, b), t
    a, _ = skip.run(x, flags, alive=alive)
    b, _ = gather.run(x, flags, alive=alive)
    assert torch.equal(a, b)


def test_skip_inactive_row_is_the_input_itself():
    port, _ = _schedules()
    x = torch.from_numpy(_state(5))
    assert gossip_mix_skip(x, port.perms, np.zeros(port.num_matchings)) is x
    with pytest.raises(ValueError, match="incompatible"):
        gossip_mix_skip(x[:3], port.perms, np.ones(port.num_matchings))


@pytest.mark.parametrize("wire", [None, "f32", "bf16"])
def test_matching_wire_bytes_match_jax(wire):
    dec = jtp.select_graph(4)
    got = matching_wire_bytes(select_graph(4), 273258, wire_dtype=wire)
    want = jax_matching_wire_bytes(dec, 273258, wire_dtype=wire)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("masked", [False, True])
def test_worker_deviation_rows_match_jax(masked):
    x = _state(6, d=301) * np.linspace(0.5, 3, N, dtype=np.float32)[:, None]
    alive = ALIVE if masked else None
    if masked:
        x[2] = np.inf  # quarantined rows report 0, whatever they hold
    got = _np(worker_deviation_rows(
        torch.from_numpy(x), None if alive is None else torch.from_numpy(alive)))
    want = _np(jax_worker_deviation_rows(
        jnp.asarray(x), None if alive is None else jnp.asarray(alive)))
    assert got.shape == (N,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=N * ULP * np.abs(want).max())
    if masked:
        assert (got[ALIVE == 0] == 0).all()
    else:
        # the fleet scalar is the RMS of the rows
        fleet = float(worker_disagreement(torch.from_numpy(x)))
        assert np.isclose(np.sqrt(np.mean(got.astype(np.float64) ** 2)),
                          fleet, rtol=4 * ULP)


def test_select_communicator_names_and_refusals():
    port, _ = _schedules()
    assert select_communicator("decen", port, backend="skip",
                               device="cpu").name == "decen[skip]"
    assert select_communicator("centralized").name == "centralized"
    assert select_communicator(
        "centralized", wire_dtype="bf16").name == "centralized[wire=bfloat16]"
    assert select_communicator("none").name == "none"
    with pytest.warns(UserWarning, match="block_d"):
        select_communicator("none", block_d=64)
    assert select_communicator("choco", port,
                               device="cpu").name == "choco[r0.9]"
    with pytest.raises(ValueError, match="skip"):
        select_communicator("choco", port, backend="skip", device="cpu")
    with pytest.raises(ValueError, match="needs a mesh"):
        select_communicator("choco", port, backend="shard_map", device="cpu")
    # on a mesh: CHOCO's folded form, bitwise its batched form, and the
    # centralized mean formed across the cards
    mesh = worker_mesh(devices=["cpu"] * 2)
    x = torch.from_numpy(_state(seed=5))
    folded = select_communicator("choco", port, mesh=mesh, device="cpu")
    assert folded.name == "choco[r0.9,shard_map]"
    got, _ = folded.run(shard_workers(x, mesh), port.flags[:3])
    want, _ = select_communicator("choco", port, device="cpu").run(
        x, port.flags[:3])
    assert torch.equal(gather_workers(got), want)
    cent = select_communicator("centralized", mesh=mesh)
    got, _ = cent.step(shard_workers(x, mesh), (), port.flags[0])
    want, _ = cent.step(x, (), port.flags[0])
    assert float((gather_workers(got) - want).abs().max()) \
        <= 1e-6 * float(x.abs().max())
    with pytest.raises(KeyError):
        select_communicator("gossip")


RUN = dict(model="mlp", dataset="synthetic", num_workers=N, graphid=0,
           batch_size=8, epochs=1, lr=0.1, warmup=False,
           dataset_kwargs={"num_train": 256, "num_test": 32})


def _params(result):
    return torch.cat([p.detach().reshape(N, -1)
                      for p in result.state.model.parameters()], dim=1)


def test_train_with_centralized_keeps_identical_rows():
    result = train(TrainConfig(**RUN, communicator="centralized"),
                   device="cpu")
    flat = _params(result)
    assert torch.equal(flat, flat[:1].expand_as(flat))
    hist = result.history[0]
    assert all(np.isfinite(v) for v in hist.values())
    # the rows are one value; the metric's mean of them rounds in f32
    assert hist["disagreement"] <= 4 * ULP * float(flat.abs().max())


def test_train_with_none_never_mixes():
    result = train(TrainConfig(**RUN, communicator="none"), device="cpu")
    hist = result.history[0]
    assert hist["comm_time"] == 0.0 and hist["disagreement"] > 0
    flat = _params(result)
    assert not torch.equal(flat[0], flat[1])


def test_train_with_skip_equals_gather_bitwise():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        skip = train(TrainConfig(**RUN, gossip_backend="skip"), device="cpu")
        gather = train(TrainConfig(**RUN, gossip_backend="gather"),
                       device="cpu")
    assert torch.equal(_params(skip), _params(gather))
    for key in ("loss", "accuracy", "disagreement", "test_loss_mean"):
        assert skip.history[0][key] == gather.history[0][key], key
