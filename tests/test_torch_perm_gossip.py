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

The CUDA kernel itself runs only on the card: ``test_kernel_bitwise_on_card``,
``test_kernel_smem_formula_matches_library``, ``test_step_path_bitwise_on_card``
(the band path) and ``test_band_shapes_bitwise_on_card`` are marked ``cuda``
and skip on a host without one; ``chip_smoke.py`` holds the kernel against
the plain version at the training slice's shapes and the band path's.  The
launch rule (slabs or bands) is pinned here through a stand-in for the
library's shared-memory and scratch queries, and the band shapes' L2 budget
and scratch formula by count.
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
from matcha_tpu.schedule import fixed_schedule as jax_fixed_schedule
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


def _hypercube(n, t_steps, seed=0):
    """Tables and MATCHA-style weights of an ``n``-worker hypercube, each
    matching active with probability 0.5 (JAX package's schedule)."""
    dec = jtp.decompose(jtp.hypercube_graph(n), n, seed=seed)
    sched = jax_fixed_schedule(dec, n, t_steps, budget=0.5,
                               mode="bernoulli", seed=seed)
    return sched, involution_tables(sched.perms)


@pytest.mark.parametrize("n", [512, 1024])
def test_perm_large_n_matches_jax_kernel(n):
    # the tables' large-N path: N·M entries well past what fits a CTA as
    # int2, held to the reference at a narrow D
    sched, tabs = _hypercube(n, 3)
    x, w = _state(9, n=n, d=6), _weights(sched, 3)
    port = _port(x, w, tabs)
    ref = _jax(x, w, tabs, block_d=6)
    np.testing.assert_allclose(port, ref, rtol=0, atol=_per_step_ulps(x, 3))
    # and bitwise against the port's gather oracle, step by step
    chain = torch.from_numpy(x)
    for t in range(3):
        chain = gossip_mix(chain, sched.perms, torch.from_numpy(w[t]))
    np.testing.assert_array_equal(port, chain.numpy())


@pytest.mark.cuda
def test_kernel_bitwise_on_card(sched, tables):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")
    dev = torch.device("cuda")
    alive = torch.from_numpy(ALIVE).to(dev)

    def held(x, w, tabs, masks):
        args = [torch.from_numpy(w).to(dev)] + [torch.as_tensor(t, device=dev)
                                                for t in tabs]
        xd = torch.from_numpy(x).to(dev)
        for wire in (None, "bf16"):
            for mask in masks:
                ref = perm_gossip_plain(xd, *args, alive=mask,
                                        wire_dtype=wire)
                for dbuf in (True, False):
                    for w_window in (1, 5):
                        out = perm_gossip_run(xd, *args, alive=mask,
                                              wire_dtype=wire, dbuf=dbuf,
                                              w_window=w_window)
                        torch.cuda.synchronize()
                        assert torch.equal(out, ref)

    w = _weights(sched, 13)
    # odd D: scalar edges; D = 2 (mod 4): pairs 8-byte but not 16-byte
    # aligned on odd rows
    for d in (1031, 1030):
        held(_state(6, d=d), w, tables, (None, alive))
    # N = 1 and 2: four rows a thread, those past N masked
    pair, pair_tables = _hypercube(2, 8)
    held(_state(6, n=2, d=1031), _weights(pair, 8), pair_tables, (None,))
    held(_state(6, n=1, d=1030), _weights(pair, 8)[:, :1],
         involution_tables(np.zeros((1, 1), np.int64)), (None,))
    big, big_tables = _hypercube(4096, 8)
    weak = torch.ones(4096, device=dev)  # gates the uint16 tables lack
    weak[::7], weak[::11] = 0.5, 0.0
    held(_state(6, n=4096, d=1030), _weights(big, 8), big_tables,
         (None, weak))


@pytest.mark.cuda
def test_kernel_smem_formula_matches_library():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the library builds there")
    from matcha_tpu_torch.parallel.perm_gossip import _library
    lib = _library()
    assert lib.perm_gossip_smem_limit() == _SmemOnly.perm_gossip_smem_limit()
    assert (lib.perm_gossip_max_threads()
            == _SmemOnly.perm_gossip_max_threads())
    for args in [(16, 64, 1, 8, 0, 2, 1), (256, 64, 8, 10, 1, 1, 1),
                 (4096, 4, 1, 15, 0, 1, 2), (8192, 2, 3, 10, 1, 2, 2),
                 (7, 6, 5, 3, 1, 1, 2)]:
        assert (lib.perm_gossip_smem_bytes(*args)
                == _SmemOnly.perm_gossip_smem_bytes(*args))
    for args, _ in _BAND_SCRATCH:
        assert (lib.perm_gossip_band_scratch_bytes(*args)
                == _SmemOnly.perm_gossip_band_scratch_bytes(*args))
    # a band narrower than one lane's 16 bytes, or not a power-of-two
    # number of lanes, is refused
    assert lib.perm_gossip_band_scratch_bytes(64, 100, 2, 0, 2) == -1
    assert lib.perm_gossip_band_scratch_bytes(64, 100, 2, 0, 12) == -1


def _align16(b):
    return -(-b // 16) * 16


class _SmemOnly:
    """The shared-memory queries of the kernel library, with the formulas
    of ``csrc/perm_gossip.cu`` (``smem_bytes``, ``table_bytes``): the wire
    image, two weight windows, and the tables (int2 or uint16 per entry)."""

    @staticmethod
    def perm_gossip_smem_limit():
        return 232448

    @staticmethod
    def perm_gossip_max_threads():
        return 1024

    @staticmethod
    def perm_gossip_smem_bytes(n, cols, w_window, m, wire_bf16, nbuf, tables):
        image = _align16(nbuf * n * cols * (2 if wire_bf16 else 4))
        weights = _align16(4 * 2 * w_window * m)
        table = 8 * m * n if tables == 1 else _align16(2 * m * n)
        return image + weights + table

    @staticmethod
    def perm_gossip_band_scratch_bytes(n, d, t_steps, state_dtype, cols):
        """``band_scratch_bytes``: 32 flag words of the grid and two a band
        (256-byte aligned), then two ``[n, cols]`` buffers where the chain
        has two steps or more."""
        n_bands = -(-d // cols)
        flags = -(-4 * (32 + 2 * n_bands) // 256) * 256
        bufs = (2 * n * cols * (4 if state_dtype == 0 else 2)
                if t_steps >= 2 else 0)
        return flags + bufs


# (n, d, t_steps, state_dtype, cols) and the scratch counted by hand
_BAND_SCRATCH = [
    # 2135 bands of 128 columns: 4 * (32 + 2 * 2135) = 17,208 flag bytes,
    # 17,408 aligned; two f32 buffers of 16,384 * 128 * 4 = 8,388,608
    ((16384, 273258, 4, 0, 128), 17408 + 2 * 8388608),
    ((16384, 273258, 1, 0, 128), 17408),   # T = 1: the flags alone
    # 64 bands: 4 * (32 + 2 * 64) = 640 -> 768; two bf16 buffers of
    # 4096 * 512 * 2 = 4,194,304
    ((4096, 32768, 3, 1, 512), 768 + 2 * 4194304),
    # one ragged band of 4 columns at N = 1: 4 * (32 + 2) = 136 -> 256
    ((1, 3, 2, 0, 4), 256 + 2 * 16),
]


@pytest.mark.parametrize("n,m,block_d,wire,shape", [
    # the slice: 64-column slabs, 4 rows a thread, tables as int2
    (16, 8, 2048, False, (64, 4, 128, 2, 1)),
    (16, 8, 32, True, (32, 4, 64, 2, 1)),      # block_d caps the slab
    # N < 4: four rows a thread, those past N masked
    (1, 1, 2048, False, (64, 4, 32, 2, 1)),
    (2, 1, 2048, True, (64, 4, 32, 2, 1)),
    # N = 256: 8 rows a thread, one 1024-thread CTA per SM, two images
    (256, 10, 2048, False, (64, 8, 1024, 2, 1)),
    # N = 4096, one step: the band path (1024 f32 columns), which beats the
    # slab kernel's 4-column slabs there (test_slab_keeps_chains)
    (4096, 15, 2048, False, (1024,)),
    (4096, 15, 2048, True, (1024,)),
    (4096, 12, 2048, False, (1024,)),
])
def test_kernel_tile_choice(n, m, block_d, wire, shape):
    from matcha_tpu_torch.parallel.perm_gossip import _launch_shape
    assert tuple(_launch_shape(_SmemOnly, n, m, 1, block_d, wire)) == shape


@pytest.mark.parametrize("n,m,wire,steps,shape", [
    # N = 4096 over more than one step: 4 columns, the tables as uint16; at
    # M = 15 one f32 image, two bf16 ones
    (4096, 15, False, 2, (4, 8, 1024, 1, 2)),
    (4096, 15, True, 64, (4, 8, 1024, 2, 2)),
    (4096, 12, False, 8, (4, 8, 1024, 2, 2)),
    (8192, 5, False, 8, (2, 8, 1024, 2, 2)),   # the 8192-worker torus
    # below 4096 workers the slabs take one step too
    (2048, 11, False, 1, (8, 8, 1024, 2, 2)),
])
def test_slab_keeps_chains(n, m, wire, steps, shape):
    from matcha_tpu_torch.parallel.perm_gossip import LaunchShape, _launch_shape
    got = _launch_shape(_SmemOnly, n, m, 1, 2048, wire, 4, steps)
    assert isinstance(got, LaunchShape) and tuple(got) == shape


@pytest.mark.parametrize("taken,refused", [
    ((8192, 1), (8193, 1)),     # 1024 threads of 8 rows, one column pair
    ((8192, 10), (8192, 11)),   # the tables no longer fit beside the image
    ((4096, 24), (4096, 25)),
])
def test_kernel_refuses_a_state_too_tall_for_shared_memory(taken, refused):
    # the slab kernel refuses the taller shape; the band path (the state
    # in device memory, walked in bands that stay in L2) takes it instead
    # of a ValueError
    from matcha_tpu_torch.parallel.perm_gossip import (LaunchShape,
                                                       _launch_shape,
                                                       band_shape)
    # a chain of steps, where the slab kernel is taken wherever it fits
    slab = _launch_shape(_SmemOnly, *taken, 1, 2048, False, 4, 8)
    assert isinstance(slab, LaunchShape) and slab.cols == 2
    assert (_launch_shape(_SmemOnly, *refused, 1, 2048, False, 4, 8)
            == band_shape(refused[0], 4))


@pytest.mark.parametrize("n,m,wire", [(8193, 14, False), (16384, 14, False),
                                      (16384, 14, True), (4096, 25, False)])
def test_every_shape_takes_a_path(n, m, wire):
    # past the slab kernel's reach (N above 8192, or 25 matchings at 4096)
    # the band path takes the shape, for either state dtype; nothing raises
    from matcha_tpu_torch.parallel.perm_gossip import (BandShape,
                                                       _launch_shape,
                                                       band_shape)
    for w_window in (1, 8):
        for state_bytes in (4, 2):
            for steps in (1, 8):
                shape = _launch_shape(_SmemOnly, n, m, w_window, 2048, wire,
                                      state_bytes, steps)
                assert isinstance(shape, BandShape)
                assert shape == band_shape(n, state_bytes)


@pytest.mark.parametrize("state_bytes", [4, 2])
@pytest.mark.parametrize("n", [4097, 8193, 10000, 16384, 16385, 32768,
                               50000, 65536])
def test_band_buffers_stay_in_l2(n, state_bytes):
    # the band's two buffers together stay within the L2 budget, and the
    # band is the widest that does: a lane's 16 bytes times a power of
    # two, at most _BAND_MAX_BYTES a row
    from matcha_tpu_torch.parallel.perm_gossip import (_BAND_MAX_BYTES,
                                                       _L2_BAND_BYTES,
                                                       band_shape)
    (cols,) = band_shape(n, state_bytes)
    lane = 16 // state_bytes
    lanes = cols // lane
    assert cols % lane == 0 and lanes & (lanes - 1) == 0
    assert 2 * n * cols * state_bytes <= _L2_BAND_BYTES
    assert (cols * state_bytes == _BAND_MAX_BYTES
            or 2 * n * 2 * cols * state_bytes > _L2_BAND_BYTES)
    # the library takes the shape: its scratch is the flags and the buffers
    d = 273258
    assert (_SmemOnly.perm_gossip_band_scratch_bytes(
        n, d, 4, 0 if state_bytes == 4 else 1, cols)
        < 2 * n * cols * state_bytes + (1 << 20))


@pytest.mark.parametrize("args,nbytes", _BAND_SCRATCH)
def test_band_scratch_formula_counts_flags_and_buffers(args, nbytes):
    # the Python mirror of band_scratch_bytes against a count by hand
    assert _SmemOnly.perm_gossip_band_scratch_bytes(*args) == nbytes


def _same_bits(a, b):
    """Bitwise equality with NaN positions compared (a NaN's payload and
    ``torch.equal``'s NaN != NaN aside)."""
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    as_int = torch.int32 if a.element_size() == 4 else torch.int16
    return (a.dtype == b.dtype and torch.equal(nan_a, nan_b) and torch.equal(
        a.masked_fill(nan_a, 0).view(as_int),
        b.masked_fill(nan_b, 0).view(as_int)))


@pytest.mark.cuda
@pytest.mark.parametrize("t_steps", [1, 2, 3, 8])
@pytest.mark.parametrize("kind,n", [("hypercube", 16384),
                                    ("erdos_renyi", 4096),
                                    ("erdos_renyi", 8193)])
def test_step_path_bitwise_on_card(kind, n, t_steps):
    # the band path: N above 8192 (the 16,384-worker hypercube, M = 14; a
    # ragged 8193-worker graph), and a 4096-worker graph of mean degree 30
    # coloured into more matchings than the slab tables hold; T odd and
    # even (the buffers' ping-pong), an odd D, both wires and state dtypes,
    # an alive mask, and inf and NaN in the state (no term skipped)
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")
    from matcha_tpu_torch.schedule import fixed_schedule
    from matcha_tpu_torch.topology import (decompose, erdos_renyi_graph,
                                           hypercube_graph)
    degree = 30 if n == 4096 else 10
    edges = (hypercube_graph(n) if kind == "hypercube"
             else erdos_renyi_graph(n, degree / (n - 1), seed=1))
    sched = fixed_schedule(decompose(edges, n), n, t_steps, budget=0.5,
                           mode="bernoulli", seed=1)
    dev = torch.device("cuda")
    args = [torch.as_tensor(sched.alpha * sched.flags, dtype=torch.float32,
                            device=dev)]
    args += [torch.as_tensor(t, device=dev)
             for t in involution_tables(sched.perms)]
    x = torch.from_numpy(_state(6, n=n, d=257)).to(dev)
    wild = x.clone()
    wild[3, 100], wild[n - 1, 256] = float("nan"), float("inf")
    alive = torch.ones(n, device=dev)
    alive[::5] = 0.0
    cases = [(x, None, None), (x, "bf16", None), (x, None, alive),
             (x.to(torch.bfloat16), None, None),
             (x.to(torch.bfloat16), "bf16", alive), (wild, None, None)]
    for state, wire, mask in cases:
        ref = perm_gossip_plain(state, *args, alive=mask, wire_dtype=wire)
        for dbuf in (True, False):
            before = LAUNCHES["perm_gossip/band"]
            out = perm_gossip_run(state, *args, alive=mask, wire_dtype=wire,
                                  dbuf=dbuf)
            torch.cuda.synchronize()
            assert LAUNCHES["perm_gossip/band"] == before + 1
            assert _same_bits(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("cols", [4, 8, 32, 128, 512, 1024])
def test_band_shapes_bitwise_on_card(cols):
    # any band width the library takes gives the plain version's bits:
    # lanes of several rows in a warp (4 to 32 columns), several warps a
    # row (1024), ragged last bands
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")
    from matcha_tpu_torch.parallel.perm_gossip import (BandShape, _launch,
                                                       _prepare)
    sched, tabs = _hypercube(256, 5)
    dev = torch.device("cuda")
    w = torch.from_numpy(_weights(sched, 5)).to(dev)
    tabs = [torch.as_tensor(t, device=dev) for t in tabs]
    for d in (1031, 1030, 4096):
        x = torch.from_numpy(_state(6, n=256, d=d)).to(dev)
        for t_steps in (1, 2, 5):
            ref = perm_gossip_plain(x, w[:t_steps], *tabs)
            wt, p, gate, w_window, block_d, wire = _prepare(
                x, w[:t_steps], *tabs, None, 2048, 1, None)
            out = _launch(x, wt, p, gate, w_window, block_d, wire, True,
                          shape=BandShape(cols))
            torch.cuda.synchronize()
            assert _same_bits(out, ref)
