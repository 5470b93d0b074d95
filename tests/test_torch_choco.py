"""The port's CHOCO-SGD communicator (``communicator/choco.py``) against the
reference simulation, against the JAX package's ``make_choco``, and
against ``tests/test_communicator.py``'s laws, on the CPU.

Tolerances, and why:

* Against the numpy simulation of the reference (float64, per rank):
  ``rtol=3e-4, atol=3e-5``, the JAX package's own bar for the same
  comparison (``tests/test_communicator.py:122``): 15 float32 steps.
* Step-wise against the JAX ``make_choco``: both sides take the JAX state
  of every step and run one step each.  XLA contracts some of the step's
  multiply-adds into FMAs and PyTorch does not, so a value may part by
  an ulp or two of the largest magnitude involved: ``|Δ| ≤ 4·2⁻²³·max|x|``
  per step (4 ulps at the state's scale).  The selected sets are compared
  exactly: at D = 1000 no two magnitudes at the k-th place are within an
  ulp at these seeds.
* Chained against the JAX ``make_choco``: 15 steps at D = 21, where the
  gap between the k-th and (k+1)-th magnitudes is far above the drift, so
  both sides select the same coordinates every step:
  ``rtol=0, atol=1e-5`` (15 steps of a few ulps on values of order 1).
  With a bf16 wire a one-ulp f32 difference can round a message value to
  the other bf16 neighbour, one bf16 ulp (2⁻⁸ relative) away: there the
  bar is the repo's bf16-wire bar, ``atol=2⁻⁸`` on values of order 1.
* Keep-all CHOCO at γ = 1 against the decen communicator: ``rtol=1e-4,
  atol=1e-5``, the JAX package's bar (the two sum in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matcha_tpu import topology as jtp
from matcha_tpu.communicator import make_choco as jax_make_choco
from matcha_tpu.schedule import matcha_schedule as jax_matcha_schedule
from matcha_tpu_torch import topology as tp
from matcha_tpu_torch.communicator import (
    make_choco,
    make_decen,
    select_communicator,
)
from matcha_tpu_torch.ops import top_k_ratio_size
from matcha_tpu_torch.parallel import (
    WorkerBlocks,
    gather_workers,
    shard_workers,
    worker_disagreement,
    worker_mesh,
)
from matcha_tpu_torch.schedule import fixed_schedule, matcha_schedule

ULP = 2.0 ** -23


def random_state(n, d, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def numpy_choco_reference(x0, sched, ratio, gamma, steps):
    """Per-rank mirror of the reference's ChocoCommunicator
    (communicator.py:161-268), as ``tests/test_communicator.py:84``."""
    x = x0.astype(np.float64).copy()
    n, d = x.shape
    x_hat = np.zeros_like(x)
    s = np.zeros_like(x)
    k = top_k_ratio_size(d, ratio)
    nbrs = sched.neighbors_info
    alpha = sched.alpha
    for t in range(steps):
        flags = sched.flags[t]
        if flags.sum() == 0:
            continue  # the reference's early return: nothing mutates
        q = x - x_hat
        idxs = [np.argsort(-np.abs(q[i]), kind="stable")[:k]
                for i in range(n)]
        vals = [q[i][idxs[i]] for i in range(n)]
        for i in range(n):
            deg = 0
            for j, f in enumerate(flags):
                if f and nbrs[j][i] != -1:
                    deg += 1
                    p = nbrs[j][i]
                    np.add.at(s[i], idxs[p], alpha * vals[p])
            np.add.at(s[i], idxs[i], (1 - deg * alpha) * vals[i])
            np.add.at(x_hat[i], idxs[i], vals[i])
            x[i] += gamma * (s[i] - x_hat[i])
    return x


def _run(comm, x0, flags, carry=None):
    x, carry = comm.run(torch.from_numpy(x0), flags, carry)
    return x.numpy(), carry


def _zoo0(iterations):
    port = matcha_schedule(tp.select_graph(0), 8, iterations=iterations,
                           budget=0.5, seed=7)
    ref = jax_matcha_schedule(jtp.select_graph(0), 8, iterations=iterations,
                              budget=0.5, seed=7)
    assert np.array_equal(port.flags, ref.flags) and port.alpha == ref.alpha
    return port, ref


def _ring(iterations, **kwargs):
    return fixed_schedule(tp.select_graph(5), 8, iterations=iterations,
                          **kwargs)


@pytest.mark.parametrize("ratio", [0.0, 0.5, 0.9])
def test_choco_matches_reference_simulation(ratio):
    sched, _ = _zoo0(15)
    x0 = random_state(8, 21, seed=5)
    got, carry = _run(make_choco(sched, ratio=ratio, consensus_lr=0.3,
                                 device="cpu"), x0, sched.flags)
    want = numpy_choco_reference(x0, sched, ratio, 0.3, 15)
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-5)
    assert set(carry) == {"x_hat", "s"}


@pytest.mark.parametrize("wire", [None, "bf16"])
@pytest.mark.parametrize("ratio", [0.0, 0.5, 0.9])
def test_choco_chained_matches_jax(ratio, wire):
    sched, jsched = _zoo0(15)
    x0 = random_state(8, 21, seed=5)
    want, jcarry = jax.jit(jax_make_choco(
        jsched, ratio=ratio, consensus_lr=0.3, backend="batched",
        wire_dtype=wire).run)(jnp.asarray(x0), jsched.flags)
    got, carry = _run(make_choco(sched, ratio=ratio, consensus_lr=0.3,
                                 wire_dtype=wire, device="cpu"),
                      x0, sched.flags)
    atol = 1e-5 if wire is None else 2.0 ** -8
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol)
    for key in ("x_hat", "s"):
        np.testing.assert_allclose(carry[key].numpy(),
                                   np.asarray(jcarry[key]), rtol=0,
                                   atol=atol, err_msg=key)


@pytest.mark.parametrize("case", ["top_k", "top_k_approx", "keep_all",
                                  "bf16_wire", "alive"])
def test_choco_stepwise_matches_jax(case):
    """Every step from the JAX state: one port step against one JAX step."""
    n, d, steps = 16, 1000, 8
    edges = jtp.make_graph("ring", n)
    jsched = jax_matcha_schedule(jtp.decompose(edges, n, seed=0), n,
                                 iterations=steps, budget=0.75, seed=2)
    sched = matcha_schedule(tp.decompose(tp.make_graph("ring", n), n, seed=0),
                            n, iterations=steps, budget=0.75, seed=2)
    assert np.array_equal(sched.flags, jsched.flags)
    kw = dict(ratio=0.0 if case == "keep_all" else 0.9, consensus_lr=0.4,
              compressor="top_k_approx" if case == "top_k_approx"
              else "top_k", wire_dtype="bf16" if case == "bf16_wire"
              else None)
    jcomm = jax_make_choco(jsched, backend="batched", **kw)
    comm = make_choco(sched, device="cpu", **kw)
    alive = None
    if case == "alive":
        alive = np.ones(n, np.float32)
        alive[[3, 10]] = 0.0
    jstep = jax.jit(jcomm.step)
    x = jnp.asarray(random_state(n, d, seed=11))
    carry = jcomm.init(x)
    for t in range(steps):
        args = (x, carry, jnp.asarray(sched.flags[t]))
        if alive is not None:
            args += (jnp.asarray(alive),)
        x, carry = jstep(*args)
        got, got_carry = comm.step(
            torch.tensor(np.asarray(args[0])),
            {k: torch.tensor(np.asarray(v)) for k, v in args[1].items()},
            torch.from_numpy(sched.flags[t].astype(np.float32)),
            None if alive is None else torch.from_numpy(alive))
        for key, want, have in (("x", x, got),
                                ("x_hat", carry["x_hat"],
                                 got_carry["x_hat"]),
                                ("s", carry["s"], got_carry["s"])):
            want = np.asarray(want)
            bar = 4 * ULP * max(np.abs(want).max(), 1.0)
            np.testing.assert_allclose(have.numpy(), want, rtol=0, atol=bar,
                                       err_msg=f"{key} at step {t}")


def test_choco_keep_all_gamma1_equals_decen():
    """No compression and γ = 1 is D-PSGD under a constant W
    (``tests/test_communicator.py:125``)."""
    sched = _ring(20)
    x0 = random_state(8, 15, seed=9)
    a, _ = _run(make_decen(sched, "gather", device="cpu"), x0, sched.flags)
    b, _ = _run(make_choco(sched, ratio=0.0, consensus_lr=1.0, device="cpu"),
                x0, sched.flags)
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("compressor", ["top_k", "random_k"])
def test_choco_skip_iterations_freeze_all_state(compressor):
    sched = _ring(3, mode="bernoulli", budget=0.0)
    assert not sched.flags.any()
    comm = make_choco(sched, ratio=0.5, compressor=compressor, device="cpu")
    x0 = random_state(8, 9)
    carry0 = comm.init(torch.from_numpy(x0))
    got, carry = _run(comm, x0, sched.flags, carry0)
    np.testing.assert_array_equal(got, x0)
    assert not carry["x_hat"].any() and not carry["s"].any()
    if compressor == "random_k":
        # the random state advances on frozen steps too, as the JAX key is
        # split before the freeze
        assert not torch.equal(carry["key"], carry0["key"])


@pytest.mark.parametrize("compressor,bar", [
    ("top_k", 0.05), ("top_k_approx", 0.05), ("random_k", 0.1),
    ("top_k_q8", 0.1)])
def test_choco_contracts_disagreement(compressor, bar):
    """400 steps on ring-8 shrink the disagreement below the JAX package's
    bars (``tests/test_communicator.py:192``, :203, :362); a rerun from
    the same seed is bitwise the same."""
    sched = _ring(400)
    comm = make_choco(sched, ratio=0.7, consensus_lr=0.3,
                      compressor=compressor, seed=5, device="cpu")
    x0 = random_state(8, 30, seed=1)
    carry0 = comm.init(torch.from_numpy(x0))
    assert ("key" in carry0) == (compressor in ("random_k", "top_k_q8"))
    xt, carry = _run(comm, x0, sched.flags)
    x0t = torch.from_numpy(x0)
    assert float(worker_disagreement(torch.from_numpy(xt))) \
        < bar * float(worker_disagreement(x0t))
    again, _ = _run(comm, x0, sched.flags)
    np.testing.assert_array_equal(xt, again)
    if "key" in carry0:
        assert carry["key"].dtype == torch.uint8
        assert not torch.equal(carry["key"], carry0["key"])


def test_select_communicator_plumbs_compressor_and_seed():
    """``tests/test_communicator.py:301``: the same seed gives the same
    chain bitwise, another seed another sample path."""
    sched = _ring(40)
    x0 = random_state(8, 17, seed=4)

    def run(seed):
        comm = select_communicator("choco", sched, compressor="random_k",
                                   ratio=0.5, seed=seed, device="cpu")
        return _run(comm, x0, sched.flags)[0]

    a, b, c = run(1), run(1), run(2)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_select_communicator_choco_backends_and_names():
    sched = _ring(2)
    for backend in ("perm", "dense", "fused", "gather", "auto"):
        comm = select_communicator("choco", sched, backend=backend,
                                   device="cpu")
        assert comm.name == "choco[r0.9]" and comm.encode_probe is not None
    assert select_communicator(
        "choco", sched, ratio=0.5, compressor="top_k_q8", wire_dtype="bf16",
        device="cpu").name == "choco[r0.5,top_k_q8,wire=bfloat16]"
    with pytest.raises(ValueError, match="skip"):
        select_communicator("choco", sched, backend="skip", device="cpu")
    with pytest.raises(ValueError, match="needs a mesh"):
        select_communicator("choco", sched, backend="shard_map", device="cpu")
    # on a mesh, auto and shard_map are the folded form, bitwise the
    # batched one; a batched spelling is the batched form on card 0
    mesh = worker_mesh(devices=["cpu"] * 4)
    x = torch.from_numpy(random_state(8, 40, seed=3))
    want, want_carry = select_communicator(
        "choco", sched, ratio=0.5, device="cpu").run(x, sched.flags[:2])
    for backend in ("auto", "shard_map"):
        comm = select_communicator("choco", sched, ratio=0.5, mesh=mesh,
                                   backend=backend, device="cpu")
        assert comm.name == "choco[r0.5,shard_map]"
        got, carry = comm.run(shard_workers(x, mesh), sched.flags[:2])
        assert torch.equal(gather_workers(got), want)
        assert torch.equal(gather_workers(carry["s"]), want_carry["s"])
    comm = select_communicator("choco", sched, ratio=0.5, mesh=mesh,
                               backend="perm", device="cpu")
    assert comm.name == "choco[r0.5]"
    got, carry = comm.run(shard_workers(x, mesh), sched.flags[:2])
    assert isinstance(got, WorkerBlocks) and isinstance(carry["s"],
                                                        WorkerBlocks)
    assert torch.equal(gather_workers(got), want)
    assert torch.equal(gather_workers(carry["s"]), want_carry["s"])
    with pytest.raises(KeyError):
        make_choco(sched, backend="ring", device="cpu")
    with pytest.warns(UserWarning, match="no effect"):
        select_communicator("choco", sched, block_d=64, device="cpu")


def test_encode_probe_is_the_compress_path():
    sched = _ring(2)
    x = torch.from_numpy(random_state(8, 40, seed=2))
    comm = make_choco(sched, ratio=0.75, device="cpu")
    probe = comm.encode_probe(x, torch.zeros_like(x))
    # x̂ += scatter(top-k of x − x̂): 10 of 40 coordinates copied from x
    kept = probe != 0
    assert kept.sum(dim=1).tolist() == [10] * 8
    assert torch.equal(probe[kept], x[kept])


def test_carry_key_survives_a_weights_only_round_trip(tmp_path):
    sched = _ring(4)
    comm = make_choco(sched, compressor="random_k", seed=3, device="cpu")
    x = torch.from_numpy(random_state(8, 12))
    half, carry = comm.run(x, sched.flags[:2])
    torch.save(carry, tmp_path / "carry.pt")
    loaded = torch.load(tmp_path / "carry.pt", weights_only=True)
    # two steps, the carry saved and loaded, two more: one run of four
    whole, _ = comm.run(x, sched.flags)
    rest, _ = comm.run(half, sched.flags[2:], loaded)
    assert torch.equal(whole, rest)
