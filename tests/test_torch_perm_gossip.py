"""The port's permutation-form gossip against the JAX package.

``matcha_tpu_torch.parallel.perm_gossip_run`` on CPU tensors runs its plain
PyTorch version; it is held here against the JAX ``perm_gossip_run`` run
through the Pallas interpreter (as ``tests/test_perm_backend.py`` runs it)
and against the port's own gather oracle ``gossip_mix``.  Inputs come from
numpy with a fixed seed and are handed to both frameworks.

Tolerances:

* Against the port's ``gossip_mix`` chain: bitwise.  Both are eager PyTorch
  with one rounding per product and per sum, in the same order.
* Against JAX at T = 1: bitwise.  At T > 1: at most one f32 ulp of the
  state's magnitude per step.  XLA compiles the interpreted kernel's step
  loop and contracts a multiply and the add after it into one fused
  multiply-add, which rounds once where eager PyTorch (and the CUDA
  kernel, built with ``--fmad=false``) rounds twice; the JAX package's own
  perm tests name the same 1-ulp contraction scale.
* bf16 wire against the f32 wire: each step quantizes the exchanged image
  to bf16 (relative error ≤ 2⁻⁹), so the chains may part by at most
  2⁻⁸·max|x| per step.

The CUDA kernel itself runs only on the card: ``test_kernel_bitwise_on_card``
is marked ``cuda`` and skips on a host without one; ``chip_smoke.py`` holds
the kernel against the plain version at the training slice's shapes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from matcha_tpu import topology as jtp
from matcha_tpu.parallel import collectives as jax_collectives
from matcha_tpu.parallel import gossip_mix as jax_gossip_mix
from matcha_tpu.parallel import involution_tables as jax_involution_tables
from matcha_tpu.parallel import perm_gossip_run as jax_perm_gossip_run
from matcha_tpu.schedule import matcha_schedule as jax_matcha_schedule
from matcha_tpu_torch.parallel import (
    LAUNCHES,
    allreduce_mean,
    gossip_mix,
    involution_tables,
    masked_allreduce_mean,
    perm_gossip_plain,
    perm_gossip_run,
    worker_disagreement,
)

N, D = 8, 37
ULP = float(np.finfo(np.float32).eps)
ALIVE = np.array([1, 1, 0, 1, 1, 1, 0, 1], np.float32)


@pytest.fixture(scope="module")
def sched():
    dec = jtp.decompose(jtp.ring_graph(N), N, seed=0)
    return jax_matcha_schedule(dec, N, iterations=13, budget=0.6, seed=0)


@pytest.fixture(scope="module")
def tables(sched):
    return involution_tables(sched.perms)


def _state(seed=0, n=N, d=D):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _weights(sched, t_steps):
    return (sched.alpha * np.asarray(sched.flags[:t_steps])).astype(np.float32)


def _port(x, w, tables, **kw):
    alive = kw.pop("alive", None)
    out = perm_gossip_run(torch.from_numpy(x), torch.from_numpy(w), *tables,
                          alive=None if alive is None
                          else torch.from_numpy(alive), **kw)
    return out.float().numpy()


def _jax(x, w, tables, **kw):
    alive = kw.pop("alive", None)
    out = jax_perm_gossip_run(jnp.asarray(x), jnp.asarray(w), *tables,
                              alive=None if alive is None
                              else jnp.asarray(alive),
                              interpret=True, **kw)
    return np.asarray(out.astype(jnp.float32))


def _per_step_ulps(x, t_steps):
    return t_steps * ULP * float(np.abs(x).max() + 1.0)


@pytest.mark.parametrize("t_steps", [1, 5, 13])
@pytest.mark.parametrize("masked", [False, True])
def test_perm_f32_matches_jax_kernel(sched, tables, t_steps, masked):
    x, w = _state(), _weights(sched, t_steps)
    alive = ALIVE if masked else None
    port = _port(x, w, tables, alive=alive)
    ref = _jax(x, w, tables, alive=alive)
    if t_steps == 1:
        np.testing.assert_array_equal(port, ref)
    else:
        np.testing.assert_allclose(port, ref, rtol=0,
                                   atol=_per_step_ulps(x, t_steps))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("wire", [None, "bf16"])
def test_perm_bitwise_vs_gather_oracle(sched, tables, masked, wire):
    x, w = _state(1), _weights(sched, 13)
    alive = torch.from_numpy(ALIVE) if masked else None
    ref = torch.from_numpy(x)
    for t in range(w.shape[0]):
        ref = gossip_mix(ref, sched.perms, torch.from_numpy(w[t]), alive,
                         wire_dtype=wire)
    port = perm_gossip_run(torch.from_numpy(x), torch.from_numpy(w), *tables,
                           alive=alive, wire_dtype=wire)
    assert torch.equal(port, ref)


@pytest.mark.parametrize("t_steps", [1, 13])
def test_perm_bf16_wire_matches_jax_and_bounds_quantization(sched, tables,
                                                            t_steps):
    x, w = _state(2), _weights(sched, t_steps)
    port = _port(x, w, tables, wire_dtype="bf16")
    ref = _jax(x, w, tables, wire_dtype="bf16")
    np.testing.assert_allclose(port, ref, rtol=0,
                               atol=_per_step_ulps(x, t_steps))
    exact = _port(x, w, tables)
    scale = float(np.abs(x).max())
    assert np.abs(port - exact).max() <= t_steps * 2.0 ** -8 * scale
    # the narrow wire keeps the exchange pairwise: the worker mean holds
    np.testing.assert_allclose(port.mean(0), x.mean(0), rtol=0, atol=1e-5)


def test_perm_bf16_state_matches_jax(sched, tables):
    x, w = _state(3), _weights(sched, 13)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    port = perm_gossip_run(xb, torch.from_numpy(w), *tables)
    assert port.dtype == torch.bfloat16
    ref = jax_perm_gossip_run(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w),
                              *tables, interpret=True)
    # each step rounds the f32 sum to bf16 on both sides; a 1-ulp f32
    # difference before the cast can flip one bf16 rounding
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), rtol=0,
                               atol=13 * 2.0 ** -8 * float(np.abs(x).max()))


@pytest.mark.parametrize("w_window", [1, 4, 5, 13])
@pytest.mark.parametrize("block_d", [32, 2048])
@pytest.mark.parametrize("dbuf", [True, False])
def test_perm_window_block_and_dbuf_invariance(sched, tables, w_window,
                                               block_d, dbuf):
    x, w = _state(4), _weights(sched, 13)
    base = _port(x, w, tables)
    out = _port(x, w, tables, w_window=w_window, block_d=block_d, dbuf=dbuf)
    # front-padding with zero-weight rows (13 % 4, 13 % 5) is an exact
    # identity, and the tile width never enters the arithmetic
    np.testing.assert_array_equal(out, base)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("wire", [None, "bf16"])
def test_gossip_mix_matches_jax_oracle(sched, masked, wire):
    # one eager step on each side, one rounding per operation: bitwise
    x, w = _state(7), _weights(sched, 1)[0]
    port = gossip_mix(torch.from_numpy(x), sched.perms, torch.from_numpy(w),
                      torch.from_numpy(ALIVE) if masked else None,
                      wire_dtype=wire)
    ref = jax_gossip_mix(jnp.asarray(x), sched.perms, jnp.asarray(w),
                         jnp.asarray(ALIVE) if masked else None,
                         wire_dtype=wire)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


@pytest.mark.parametrize("masked", [False, True])
def test_collectives_match_jax(masked):
    x = _state(8)
    alive = ALIVE if masked else None
    tx = torch.from_numpy(x)
    talive = None if alive is None else torch.from_numpy(alive)
    jx = jnp.asarray(x)
    jalive = None if alive is None else jnp.asarray(alive)
    # reductions sum in another order on each side: 1e-6 relative
    np.testing.assert_allclose(
        worker_disagreement(tx, talive).item(),
        float(jax_collectives.worker_disagreement(jx, jalive)), rtol=1e-6)
    np.testing.assert_allclose(
        allreduce_mean(tx).numpy(),
        np.asarray(jax_collectives.allreduce_mean(jx)), rtol=1e-6, atol=1e-7)
    if masked:
        np.testing.assert_allclose(
            masked_allreduce_mean(tx, talive).numpy(),
            np.asarray(jax_collectives.masked_allreduce_mean(jx, jalive)),
            rtol=1e-6, atol=1e-7)


def test_perm_empty_chains_return_the_state(sched, tables):
    x = torch.from_numpy(_state(5))
    assert perm_gossip_run(x, torch.zeros((0, sched.num_matchings)),
                           *tables) is x
    empty = (np.zeros((0, N), np.int32), np.zeros((0, N), np.float32))
    assert perm_gossip_run(x, torch.zeros((3, 0)), *empty) is x
    assert perm_gossip_plain(x, torch.zeros((0, sched.num_matchings)),
                             *tables) is x


def test_perm_rejects_bad_shapes(sched, tables):
    x = torch.from_numpy(_state())
    with pytest.raises(ValueError, match="incompatible"):
        perm_gossip_run(x, torch.zeros((2, sched.num_matchings + 1)), *tables)
    with pytest.raises(ValueError, match=r"\[T, M\]"):
        perm_gossip_run(x, torch.zeros(sched.num_matchings), *tables)


def test_perm_plain_path_counts_no_launch(sched, tables):
    before = dict(LAUNCHES)
    _port(_state(), _weights(sched, 5), tables)
    assert LAUNCHES == before


def test_perm_non_cpu_tensor_never_falls_back(sched, tables):
    x = torch.empty((N, D), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        perm_gossip_run(x, torch.zeros((1, sched.num_matchings),
                                       device="meta"),
                        *(torch.as_tensor(t, device="meta") for t in tables))


@pytest.mark.parametrize("perms", [
    np.array([[1, 2, 0, 3]]),            # a 3-cycle, not an involution
    np.array([[1, 0, 3, 2], [0, 1, 2, 4]]),  # out of range
    np.array([[1.0, 0.0]]),              # not integer
    np.array([1, 0]),                    # not [M, N]
    np.array([[0, 1, 2, 3], [2, 3, 3, 1]]),  # second row broken
])
def test_involution_tables_rejects_like_jax(perms):
    with pytest.raises(ValueError) as jax_err:
        jax_involution_tables(perms)
    with pytest.raises(ValueError) as port_err:
        involution_tables(perms)
    assert str(port_err.value) == str(jax_err.value)


def test_involution_tables_match_jax(sched):
    port = involution_tables(sched.perms)
    ref = jax_involution_tables(sched.perms)
    for a, b in zip(port, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_kernel_bitwise_on_card(sched, tables):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")
    x, w = _state(6, d=1031), _weights(sched, 13)
    dev = torch.device("cuda")
    args = [torch.from_numpy(w).to(dev)] + [torch.as_tensor(t, device=dev)
                                            for t in tables]
    xd = torch.from_numpy(x).to(dev)
    alive = torch.from_numpy(ALIVE).to(dev)
    for wire in (None, "bf16"):
        for mask in (None, alive):
            ref = perm_gossip_plain(xd, *args, alive=mask, wire_dtype=wire)
            for dbuf in (True, False):
                for w_window in (1, 5):
                    out = perm_gossip_run(xd, *args, alive=mask,
                                          wire_dtype=wire, dbuf=dbuf,
                                          w_window=w_window)
                    torch.cuda.synchronize()
                    assert torch.equal(out, ref)


class _SmemOnly:
    """The two shared-memory queries of the kernel library, with the
    formula of ``csrc/perm_gossip.cu``'s ``smem_bytes``."""

    @staticmethod
    def perm_gossip_smem_limit():
        return 232448

    @staticmethod
    def perm_gossip_smem_bytes(n, tile, w_window, m):
        return 4 * (2 * n * tile + 2 * w_window * m) + 16 * m * n + 4 * n


@pytest.mark.parametrize("n,m,block_d,tile", [
    (16, 8, 2048, 128),   # the slice: the widest tile
    (16, 8, 64, 64),      # block_d caps the tile
    (256, 10, 2048, 32),  # large N: the narrowest tile, more CTAs per SM
])
def test_kernel_tile_choice(n, m, block_d, tile):
    from matcha_tpu_torch.parallel.perm_gossip import _tile_width
    assert _tile_width(_SmemOnly, n, m, 1, block_d) == tile


def test_kernel_refuses_a_state_too_tall_for_shared_memory():
    from matcha_tpu_torch.parallel.perm_gossip import _tile_width
    with pytest.raises(ValueError, match="ROADMAP.md"):
        _tile_width(_SmemOnly, 4096, 12, 1, 2048)
