"""The port's two-phase gossip and its chains against the JAX package's, and
the pipelined ``train()`` (``overlap="1step"``) against the JAX ``train()``,
on the CPU.

* ``begin_mix``/``apply_mix``, ``run_overlapped`` (drained, and undrained
  with its pending delta) and ``run_pipelined`` at K = 1, 2 and 3 (drained,
  and undrained with its ``[K, N, D]`` ring), carries included, on every
  backend of ``tests/test_overlap.py:44`` and the port's ``perm`` (held to
  the JAX ``gather`` backend, whose arithmetic it has), with an f32 and a
  bf16 wire, with and without a dead worker; at the JAX tests' sizes
  (zoo graph 0, N = 8, 12 steps, D = 21).
* The port's own laws: ``run_pipelined(staleness=1)`` bitwise
  ``run_overlapped``; ``run_elided(flags, L)`` bitwise ``run`` on the
  compacted stream (every backend) and on the thinned stream (but for
  the dense products on a bf16 wire, below); the
  ``offset`` splits a stream; the k-deep drain telescopes on a stream
  thinned to every K-th step; the worker mean never moves.
* Aliasing: the delta each step consumes is, bit for bit, the one issued
  K steps before it, though the optimizer and ``unflatten_into`` write the
  parameters in place in between.

Tolerances, and why:

* Port against JAX: the two sum in other orders (XLA contracts some
  multiply-adds into FMAs), about an ulp a step: over 12 steps
  ``|Δ| ≤ 2⁻¹⁹·max(1, max|ref|)`` (16 ulps).  With a bf16 wire a one-ulp
  f32 difference can round an exchanged value to the other bf16
  neighbour: there the bar is the wire's, ``2⁻⁸·max(1, max|ref|)``.
* The k-deep drain against ``run``: ``x + (W x − x)`` is ``W x`` only up
  to f32 rounding: ``rtol=1e-5, atol=1e-6``, the JAX test's bar
  (``tests/test_staleness.py:109``).
* The worker mean: ``atol=2e-5`` (``tests/test_staleness.py:127``; the
  dense and centralized bf16 reductions round through bf16, ``1e-2``).
* ``train()``: the acceptance run's bars (``tests/test_torch_acceptance.py``):
  loss and disagreement within 1e-4 relative, test accuracy within one
  example.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import train_torch
from _torch_parity import load_into_port, to_numpy
from matcha_tpu import topology as jtp
from matcha_tpu.communicator import make_centralized as jax_make_centralized
from matcha_tpu.communicator import make_choco as jax_make_choco
from matcha_tpu.communicator import make_decen as jax_make_decen
from matcha_tpu.schedule import matcha_schedule as jax_matcha_schedule
from matcha_tpu.train import TrainConfig as JaxTrainConfig
from matcha_tpu.train import train as jax_train
from matcha_tpu_torch import topology as tp
from matcha_tpu_torch.communicator import (
    Communicator,
    make_centralized,
    make_choco,
    make_decen,
)
from matcha_tpu_torch.models import select_model
from matcha_tpu_torch.schedule import matcha_schedule
from matcha_tpu_torch.train import (
    TrainConfig,
    init_train_state,
    make_lr_schedule,
    make_optimizer,
    make_train_step,
    train,
)

N, D, T = 8, 21, 12
JAX_SCHED = jax_matcha_schedule(jtp.select_graph(0), N, iterations=T,
                                budget=0.5, seed=3)
SCHED = matcha_schedule(tp.select_graph(0), N, iterations=T, budget=0.5,
                        seed=3)
ALIVE = np.array([1, 1, 0, 1, 1, 1, 1, 1], np.float32)
JAX_BACKENDS = ["gather", "dense", "skip", "fused", "choco", "centralized"]
BACKENDS = JAX_BACKENDS + ["perm"]
DECEN = ["gather", "dense", "skip", "fused", "perm"]
CHAINS = ["begin_mix", "overlapped", "pipelined_k1", "pipelined_k2",
          "pipelined_k3"]
ELISION_L = 3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: its tensors are tiny, and in a
    full run beside five other test processes more threads only contend
    for the cores.  Restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_schedules_agree():
    assert np.array_equal(SCHED.flags, JAX_SCHED.flags)
    assert np.array_equal(SCHED.perms, JAX_SCHED.perms)
    assert SCHED.alpha == JAX_SCHED.alpha


def _x0(d=D, seed=0):
    return np.random.default_rng(seed).normal(size=(N, d)).astype(np.float32)


def _make(backend, wire=None):
    if backend == "choco":
        return make_choco(SCHED, ratio=0.5, consensus_lr=0.3,
                          wire_dtype=wire, device="cpu")
    if backend == "centralized":
        return make_centralized(wire_dtype=wire)
    return make_decen(SCHED, backend=backend, wire_dtype=wire, device="cpu")


def _make_jax(backend, wire=None):
    if backend == "choco":
        return jax_make_choco(JAX_SCHED, ratio=0.5, consensus_lr=0.3,
                              wire_dtype=wire)
    if backend == "centralized":
        return jax_make_centralized(wire_dtype=wire)
    return jax_make_decen(JAX_SCHED, backend=backend, wire_dtype=wire)


def _chains(comm, x, flags, alive, as_alive):
    """Every chain of the two-phase contract, as ``{name: (outputs)}``;
    ``as_alive`` turns the numpy mask into the side's array type."""
    a0 = None if alive is None else as_alive(alive)
    delta, carry = comm.begin_mix(x, comm.init(x), flags[0], a0)
    out = {"begin_mix": (delta, carry, comm.apply_mix(x, delta)),
           "overlapped": (comm.run_overlapped(x, flags, alive=alive),
                          comm.run_overlapped(x, flags, alive=alive,
                                              drain=False))}
    for k in (1, 2, 3):
        out[f"pipelined_k{k}"] = (
            comm.run_pipelined(x, flags, alive=alive, staleness=k),
            comm.run_pipelined(x, flags, alive=alive, staleness=k,
                               drain=False))
    return out


def _leaves(tree):
    """Arrays of a nested tuple/dict in a fixed order, as numpy."""
    if isinstance(tree, (tuple, list)):
        return [leaf for item in tree for leaf in _leaves(item)]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, torch.Tensor):
        return [tree.numpy()]
    return [np.asarray(tree)]


_JAX_CACHE = {}


def _jax_chains(backend, wire, masked):
    """The JAX side, one compiled program per (backend, wire, mask)."""
    key = (backend, wire, masked)
    if key not in _JAX_CACHE:
        comm = _make_jax(backend, wire)
        alive = ALIVE if masked else None
        flags = jnp.asarray(JAX_SCHED.flags, jnp.float32)
        _JAX_CACHE[key] = jax.jit(lambda x: _chains(
            comm, x, flags, alive, jnp.asarray))(jnp.asarray(_x0()))
    return _JAX_CACHE[key]


@pytest.mark.parametrize("chain", CHAINS)
@pytest.mark.parametrize("masked", [False, True], ids=["full", "alive-mask"])
@pytest.mark.parametrize("wire", [None, "bf16"], ids=["f32", "bf16"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_two_phase_chains_match_jax(backend, wire, masked, chain):
    want = _jax_chains("gather" if backend == "perm" else backend, wire,
                       masked)[chain]
    got = _chains(_make(backend, wire), torch.from_numpy(_x0()),
                  torch.as_tensor(SCHED.flags, dtype=torch.float32),
                  ALIVE if masked else None, torch.from_numpy)[chain]
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    rel = 2.0 ** -8 if wire else 2.0 ** -19
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        bar = rel * max(1.0, float(np.max(np.abs(w))))
        assert float(np.max(np.abs(g.astype(np.float64) - w))) <= bar


def _same(a, b):
    a, b = _leaves(a), _leaves(b)
    return len(a) == len(b) and all(np.array_equal(x, y)
                                    for x, y in zip(a, b))


def _flags():
    return torch.as_tensor(SCHED.flags, dtype=torch.float32)


@pytest.mark.parametrize("masked", [False, True], ids=["full", "alive-mask"])
@pytest.mark.parametrize("wire", [None, "bf16"], ids=["f32", "bf16"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_ring_k1_bitwise_matches_overlapped(backend, wire, masked):
    """``tests/test_staleness.py:87``: state and carry, drained and not."""
    comm = _make(backend, wire)
    alive = ALIVE if masked else None
    x0 = torch.from_numpy(_x0())
    assert _same(comm.run_overlapped(x0, _flags(), alive=alive),
                 comm.run_pipelined(x0, _flags(), alive=alive, staleness=1))
    x, c, pending = comm.run_overlapped(x0, _flags(), alive=alive,
                                        drain=False)
    y, d, ring = comm.run_pipelined(x0, _flags(), alive=alive, staleness=1,
                                    drain=False)
    assert _same((x, c, pending), (y, d, ring[0]))


@pytest.mark.parametrize("masked", [False, True], ids=["full", "alive-mask"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_run_elided_bitwise_matches_compacted_chain(backend, masked):
    """``tests/test_overlap.py:378``, bit for bit: an elided step executes
    nothing, so eliding is running the kept rows alone, carry included."""
    comm = _make(backend)
    alive = ALIVE if masked else None
    x0 = torch.from_numpy(_x0(d=19, seed=7))
    assert _same(comm.run_elided(x0, _flags(), ELISION_L, alive=alive),
                 comm.run(x0, _flags()[::ELISION_L], alive=alive))


@pytest.mark.parametrize("wire", [None, "bf16"], ids=["f32", "bf16"])
@pytest.mark.parametrize("masked", [False, True], ids=["full", "alive-mask"])
@pytest.mark.parametrize("backend", DECEN)
def test_run_elided_matches_thinned_stream(backend, masked, wire):
    """``tests/test_overlap.py:400``: a zero flag row mixes by the
    identity, so eliding it is running it, bit for bit.  Except on the
    dense products with a bf16 wire, where the identity product still
    rounds the state through bf16 (as the JAX dense step does outside
    ``jit``): there within the wire's 2⁻⁸."""
    comm = _make(backend, wire)
    alive = ALIVE if masked else None
    x0 = torch.from_numpy(_x0(d=23, seed=8))
    thinned = _flags().clone()
    thinned[torch.arange(T) % ELISION_L != 0] = 0.0
    elided = comm.run_elided(x0, _flags(), ELISION_L, alive=alive)[0]
    ran = comm.run(x0, thinned, alive=alive)[0]
    if wire and backend in ("dense", "fused"):
        bar = 2.0 ** -8 * float(ran.abs().max())
        assert float((elided - ran).abs().max()) <= bar
    else:
        assert _same(elided, ran)


def test_run_elided_offset_splits_a_stream():
    """``tests/test_overlap.py:419``: a stream split at a step that is not a
    multiple of L and resumed with ``offset`` is the same chain; L = 1
    elides nothing; a per-step mask rides along."""
    comm = _make("choco")
    x0 = torch.from_numpy(_x0(d=11, seed=9))
    whole = comm.run_elided(x0, _flags(), ELISION_L)
    s = 4
    x1, c1 = comm.run_elided(x0, _flags()[:s], ELISION_L)
    rest = comm.run_elided(x1, _flags()[s:], ELISION_L, carry=c1, offset=s)
    assert _same(whole, rest)
    assert _same(comm.run_elided(x0, _flags(), 1), comm.run(x0, _flags()))
    alive = np.tile(ALIVE, (T, 1))
    alive[5:, 4] = 0.0
    gather = _make("gather")
    assert _same(gather.run_elided(x0, _flags(), 2, alive=alive),
                 gather.run(x0, _flags()[::2], alive=alive[::2]))


@pytest.mark.parametrize("masked", [False, True], ids=["full", "alive-mask"])
@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("backend", DECEN + ["choco"])
def test_kdeep_drain_telescopes_when_thinned(backend, k, masked):
    """``tests/test_staleness.py:109``: on a stream that fires every K-th
    step each delta is consumed before the next is issued."""
    comm = _make(backend)
    alive = ALIVE if masked else None
    flags = np.tile(SCHED.flags.astype(np.float32), (2, 1))
    flags[np.arange(len(flags)) % k != 0] = 0.0
    x0 = torch.from_numpy(_x0(d=13, seed=5))
    eager, _ = comm.run(x0, flags, alive=alive)
    piped, _ = comm.run_pipelined(x0, flags, alive=alive, staleness=k)
    np.testing.assert_allclose(piped.numpy(), eager.numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("wire", [None, "bf16"], ids=["f32", "bf16"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_pipeline_preserves_worker_mean(backend, wire):
    """The visible state of the undrained one-step and k = 2 pipelines
    keeps the worker mean, and every in-flight delta has zero column
    mean (``tests/test_overlap.py:101``, ``tests/test_staleness.py:127``)."""
    comm = _make(backend, wire)
    x0 = torch.from_numpy(_x0(d=17, seed=1))
    exact = wire is None or backend in ("gather", "skip", "perm", "choco")
    atol = 2e-5 if exact else 1e-2
    x, _, pending = comm.run_overlapped(x0, _flags(), drain=False)
    y, _, ring = comm.run_pipelined(x0, _flags(), staleness=2, drain=False)
    for state in (x, y):
        np.testing.assert_allclose(state.mean(0).numpy(), x0.mean(0).numpy(),
                                   atol=atol)
    np.testing.assert_allclose(pending.mean(0).numpy(), 0.0, atol=atol)
    np.testing.assert_allclose(ring.mean(1).numpy(), 0.0, atol=atol)


def test_begin_mix_delta_owns_its_storage():
    """``none`` returns the state itself; its delta is still a new zero
    tensor, not a view of the parameters."""
    from matcha_tpu_torch.communicator import make_none

    x = torch.from_numpy(_x0())
    for comm in (make_none(), _make("perm"), _make("centralized")):
        delta, _ = comm.begin_mix(x, comm.init(x), _flags()[0])
        assert delta.untyped_storage().data_ptr() \
            != x.untyped_storage().data_ptr()
    assert not make_none().begin_mix(x, (), _flags()[0])[0].any()


def _recording(monkeypatch):
    """Every delta ``begin_mix`` issues and ``apply_mix`` consumes, copied
    at the moment it is issued or consumed."""
    issued, consumed = [], []
    begin, apply = Communicator.begin_mix, Communicator.apply_mix

    def begin_mix(self, flat, carry, flags_t, alive=None):
        delta, carry = begin(self, flat, carry, flags_t, alive)
        issued.append(delta.clone())
        return delta, carry

    def apply_mix(self, flat, delta):
        consumed.append(delta.clone())
        return apply(self, flat, delta)

    monkeypatch.setattr(Communicator, "begin_mix", begin_mix)
    monkeypatch.setattr(Communicator, "apply_mix", apply_mix)
    return issued, consumed


@pytest.mark.parametrize("staleness", [1, 2])
def test_pending_delta_survives_the_optimizer(monkeypatch, staleness):
    """The delta consumed at step t + K is, bit for bit, the one issued at
    step t: the optimizer's in-place update and ``unflatten_into`` between
    the two never write into it.  The first K steps consume zeros."""
    comm = make_decen(SCHED, "perm", device="cpu")
    opt = make_optimizer(make_lr_schedule(0.1, 4))
    model = select_model("mlp", "synthetic", num_workers=N,
                         input_shape=(4, 4, 1))
    state, flattener = init_train_state(model, N, opt, comm, seed=1,
                                        device="cpu", overlap="1step",
                                        staleness=staleness)
    step = make_train_step(opt, comm, flattener, SCHED.flags,
                           overlap="1step", staleness=staleness)
    issued, consumed = _recording(monkeypatch)
    rng = np.random.default_rng(2)
    for _ in range(5):
        xb = torch.as_tensor(rng.normal(size=(N, 4, 4, 4, 1)),
                             dtype=torch.float32)
        yb = torch.as_tensor(rng.integers(0, 10, size=(N, 4)))
        state, _ = step(state, xb, yb)
    assert len(issued) == len(consumed) == 5
    for t in range(staleness):
        assert not consumed[t].any()
    for t in range(5 - staleness):
        assert torch.equal(consumed[t + staleness], issued[t])
        assert issued[t].any()


# ------------------------------------------------------------ train() vs JAX

ACCEPTANCE = dict(model="mlp", dataset="digits", graphid=5, num_workers=8,
                  matcha=False, epochs=2, batch_size=16, lr=0.1,
                  warmup=False, seed=0, gossip_backend="perm")
REL = 1e-4
ONE_EXAMPLE = 1.0 / 360


def train_against_jax(**pipeline):
    """The acceptance run (``tests/test_torch_acceptance.py``) with the
    pipelined schedule ``pipeline`` on both sides, from the JAX run's own
    initial parameters: ``(port history, JAX history, port result)``."""
    cfg = {**ACCEPTANCE, **pipeline}
    ref = jax_train(JaxTrainConfig(**cfg, telemetry=False, health=False))
    init = jax_train(JaxTrainConfig(**{**ACCEPTANCE, "epochs": 0},
                                    telemetry=False, health=False)).state
    params, stats = to_numpy(init.params), to_numpy(init.batch_stats)
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr("matcha_tpu_torch.train.state.init_workers",
                      lambda model, seed: load_into_port(model, params,
                                                         stats))
        port = train(TrainConfig(**cfg, sync_init=False, telemetry=False,
                                 health=False), device="cpu")
    return port.history, ref.history, port


def check_against_jax(port, ref):
    assert [h["epoch"] for h in port] == [h["epoch"] for h in ref] == [0, 1]
    for got, want in zip(port, ref):
        assert set(got) == set(want)
        for key in ("loss", "disagreement", "test_loss_mean"):
            assert np.isfinite(got[key])
            rel = abs(got[key] - want[key]) / max(abs(want[key]), 1e-12)
            assert rel <= REL, (key, got[key], want[key])
        assert abs(got["test_acc_mean"] - want["test_acc_mean"]) \
            <= ONE_EXAMPLE


@pytest.fixture(scope="module")
def one_step_runs():
    return train_against_jax(overlap="1step")


def test_one_step_train_matches_jax(one_step_runs):
    port, ref, _ = one_step_runs
    check_against_jax(port, ref)


def test_one_step_train_returns_the_drained_state(one_step_runs):
    _, _, result = one_step_runs
    dim = sum(p[0].numel() for p in result.state.model.parameters())
    assert result.state.mix_pending.shape == (8, dim)
    assert not result.state.mix_pending.any()
    assert result.state.mix_ages == ()


# ---------------------------------------------------------- config and CLI

@pytest.mark.parametrize("bad", [
    dict(overlap="2step"), dict(staleness=0), dict(staleness=2),
    dict(staleness=2, overlap="off"), dict(local_steps=0),
    dict(local_steps=-1, overlap="1step"),
])
def test_config_validates_the_pipeline_like_jax(bad):
    with pytest.raises(ValueError):
        JaxTrainConfig(**bad)
    with pytest.raises(ValueError):
        TrainConfig(**bad)


def test_config_takes_the_pipeline():
    cfg = TrainConfig(overlap="1step", staleness=4, local_steps=3)
    ref = JaxTrainConfig(overlap="1step", staleness=4, local_steps=3)
    assert (cfg.overlap, cfg.staleness, cfg.local_steps) \
        == (ref.overlap, ref.staleness, ref.local_steps) == ("1step", 4, 3)
    assert dataclasses.replace(cfg, local_steps=2).local_steps == 2


def test_cli_parses_the_pipeline_flags():
    cfg, _ = train_torch.parse_args(["--overlap", "1step", "--staleness",
                                     "2", "--local-steps", "3"])
    assert (cfg.overlap, cfg.staleness, cfg.local_steps) == ("1step", 2, 3)
    cfg, _ = train_torch.parse_args([])
    assert (cfg.overlap, cfg.staleness, cfg.local_steps) == ("off", 1, 1)
    with pytest.raises(SystemExit):
        train_torch.parse_args(["--overlap", "2step"])
    with pytest.raises(ValueError, match="staleness"):
        train_torch.parse_args(["--staleness", "2"])
