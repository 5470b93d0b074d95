"""The port's dense and fused gossip backends against the JAX package.

``matcha_tpu_torch.parallel.fused_gossip_run`` on CPU tensors runs its plain
PyTorch version (one ``torch.matmul`` per step).  It is held here against
the JAX ``fused_gossip_run`` run through the Pallas interpreter (as
``tests/test_pallas.py`` runs it, and as the JAX ``make_decen`` runs it off
a TPU), and against the port's own dense backend.  The seven laws of
``tests/test_pallas.py`` are mirrored on the port.  Inputs come from numpy
with a fixed seed and are handed to both frameworks; both sides use the
JAX package's schedule, so the flags and α are the same.

Tolerances:

* Port fused (plain) against port dense: bitwise.  Both build each step's
  mixing matrix with the same elementwise sum and multiply the same
  operands with the same ``torch.matmul`` call.
* Port against JAX, f32: ``rtol=1e-5, atol=1e-6`` (``tests/test_pallas.py``
  uses the same for fused vs dense and for composition).  The two sides sum
  each ``W_t`` (over the M matchings) and each product (over the N
  workers) in another order, a few f32 ulps per step on values of order 1.
* Port against JAX, a bf16 operand pass (bf16 stack or compute dtype):
  one step at ``rtol=1e-5, atol=1e-6`` as in f32, since the products of
  bf16 operands are exact on both sides and only the f32 sums may differ.
  A chain: ``2⁻⁸ · max|ref|``, half a bf16 ulp at the output's largest
  magnitude, for a sum one f32 ulp apart that rounds a later step's bf16
  operand (or a bf16 state) the other way.  The measured gap is 0 in every
  such case here, over seeds 0–11 of the state (at N = 8 on a ring each
  sum has at most three nonzero terms).
* Composition against the step chain: ``rtol=1e-5, atol=1e-6``
  (associativity up to f32 reordering).
* ``w_window`` and ``block_d``: bitwise (identity front-padding is exact
  on finite states; the tile never enters the arithmetic).

The CUDA kernel itself runs only on the card: the ``cuda``-marked test
skips on a host without one; ``chip_smoke.py`` holds the kernel against the
plain version at the slice's shapes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from matcha_tpu import topology as jtp
from matcha_tpu.communicator import make_decen as jax_make_decen
from matcha_tpu.parallel import build_mixing_stack as jax_build_mixing_stack
from matcha_tpu.parallel import canonical_chunk as jax_canonical_chunk
from matcha_tpu.parallel import compose_mixing_stack as jax_compose
from matcha_tpu.parallel import fused_gossip_run as jax_fused_gossip_run
from matcha_tpu.parallel import gossip_mix_dense as jax_gossip_mix_dense
from matcha_tpu.parallel import masked_laplacians as jax_masked_laplacians
from matcha_tpu.schedule import matcha_schedule as jax_matcha_schedule
from matcha_tpu_torch.communicator import make_decen
from matcha_tpu_torch.parallel import (
    LAUNCHES,
    build_mixing_stack,
    canonical_chunk,
    compose_mixing_stack,
    fused_gossip_plain,
    fused_gossip_run,
    gossip_mix_dense,
    masked_laplacians,
    mxu_precision,
)
from matcha_tpu_torch.parallel.gossip import _dense_apply

N, D = 8, 37
ALIVE = np.array([1, 1, 0, 1, 1, 1, 0, 1], np.float32)
F32_TOL = dict(rtol=1e-5, atol=1e-6)
TORCH = {"f32": torch.float32, "bf16": torch.bfloat16}
JAX = {"f32": jnp.float32, "bf16": jnp.bfloat16}


@pytest.fixture(scope="module")
def sched():
    dec = jtp.decompose(jtp.ring_graph(N), N, seed=0)
    return jax_matcha_schedule(dec, N, iterations=24, budget=0.6, seed=0)


def _state(seed=0, n=N, d=D):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _bf16_chain_bound(ref):
    return 2.0 ** -8 * float(np.abs(_np(ref)).max())


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


def _lap(sched):
    return torch.as_tensor(sched.laplacians(), dtype=torch.float32)


def _port_run(sched, backend, x, t_steps, **kw):
    alive = kw.pop("alive", None)
    comm = make_decen(sched, backend, device="cpu", **kw)
    out, _ = comm.run(torch.from_numpy(x),
                      np.asarray(sched.flags[:t_steps], np.float32),
                      alive=None if alive is None else torch.from_numpy(alive))
    return out


def _jax_run(sched, backend, x, t_steps, **kw):
    alive = kw.pop("alive", None)
    comm = jax_make_decen(sched, backend=backend, **kw)
    out, _ = comm.run(jnp.asarray(x),
                      jnp.asarray(sched.flags[:t_steps], jnp.float32),
                      alive=None if alive is None else jnp.asarray(alive))
    return out


# ------------------------------------------------ the dense helpers vs JAX


@pytest.mark.parametrize("alive", [ALIVE, np.linspace(0.2, 1.0, N,
                                                      dtype=np.float32)],
                         ids=["zero-one", "probabilities"])
def test_masked_laplacians_match_jax(sched, alive):
    port = masked_laplacians(_lap(sched), torch.from_numpy(alive))
    ref = jax_masked_laplacians(jnp.asarray(sched.laplacians(), jnp.float32),
                                jnp.asarray(alive))
    # adjacency entries are 0/1 scaled by one product: every value and
    # every degree sum is computed the same way on both sides
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(port.numpy().sum(-1), 0.0, atol=1e-6)
    np.testing.assert_array_equal(port.numpy(),
                                  np.swapaxes(port.numpy(), -1, -2))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_gossip_mix_dense_matches_jax(sched, compute, masked):
    x = _state(1)
    w = (sched.alpha * np.asarray(sched.flags[3])).astype(np.float32)
    alive = ALIVE if masked else None
    port = gossip_mix_dense(torch.from_numpy(x), _lap(sched),
                            torch.from_numpy(w), compute_dtype=TORCH[compute],
                            alive=None if alive is None
                            else torch.from_numpy(alive))
    ref = jax_gossip_mix_dense(jnp.asarray(x),
                               jnp.asarray(sched.laplacians(), jnp.float32),
                               jnp.asarray(w), compute_dtype=JAX[compute],
                               alive=None if alive is None
                               else jnp.asarray(alive))
    assert port.dtype == torch.float32
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **F32_TOL)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_build_mixing_stack_matches_jax(sched, dtype):
    port = build_mixing_stack(sched.laplacians(), sched.alpha,
                              torch.as_tensor(sched.flags), TORCH[dtype])
    ref = jax_build_mixing_stack(sched.laplacians(), sched.alpha, sched.flags,
                                 JAX[dtype])
    assert port.dtype == TORCH[dtype] and tuple(port.shape) == ref.shape
    # f32: the M-term sum in another order; bf16: one rounding of that
    # f32 value, which a one-ulp difference can tip by one bf16 ulp
    atol = 1e-6 if dtype == "f32" else 2.0 ** -7
    np.testing.assert_allclose(_np(port), _np(ref), rtol=0, atol=atol)


def test_mixing_stack_rows_sum_to_one_and_is_symmetric(sched):
    stack = build_mixing_stack(sched.laplacians(), sched.alpha, sched.flags,
                               torch.float32).numpy()
    np.testing.assert_allclose(stack.sum(axis=-1), 1.0, atol=1e-5)
    np.testing.assert_array_equal(stack, np.swapaxes(stack, -1, -2))


@pytest.mark.parametrize("chunk", [-3, 0, 1, 2, 3, 8, 50])
def test_canonical_chunk_matches_jax(chunk):
    assert canonical_chunk(chunk) == jax_canonical_chunk(chunk)
    assert canonical_chunk(np.int64(chunk)) == jax_canonical_chunk(chunk)


def test_canonical_chunk_refuses_floats():
    with pytest.raises(TypeError):
        jax_canonical_chunk(4.0)
    with pytest.raises(TypeError):
        canonical_chunk(4.0)


def test_dense_product_does_not_round_through_bf16():
    # a bf16 x bf16 matmul returns bf16: its f32 sum is rounded to bf16
    # before the cast to the f32 state.  The dense mix multiplies the
    # bf16-rounded operands as f32 instead, as JAX's
    # preferred_element_type=float32 does
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.normal(size=(N, N)).astype(np.float32))
    x = torch.from_numpy(_state(5))
    out = _dense_apply(w, x, torch.bfloat16)
    want = torch.matmul(w.to(torch.bfloat16).float(),
                        x.to(torch.bfloat16).float())
    assert torch.equal(out, want)
    rounded = torch.matmul(w.to(torch.bfloat16), x.to(torch.bfloat16)).float()
    assert not torch.equal(out, rounded)


def test_mxu_precision_turns_tf32_off_and_restores():
    matmul = torch.backends.cuda.matmul
    before = matmul.allow_tf32
    try:
        for caller in (True, False):
            matmul.allow_tf32 = caller
            with mxu_precision():
                assert matmul.allow_tf32 is False
            assert matmul.allow_tf32 is caller
        matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="inside"):
            with mxu_precision():
                raise RuntimeError("inside")
        assert matmul.allow_tf32 is True
    finally:
        matmul.allow_tf32 = before


# ------------------------------------------- the seven laws of test_pallas


@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_fused_matches_dense_chain(sched, compute):
    x = _state(0)
    kw = {"compute_dtype": TORCH[compute]}
    fused = _port_run(sched, "fused", x, 12, **kw)
    dense = _port_run(sched, "dense", x, 12, **kw)
    assert torch.equal(fused, dense)
    ref = _jax_run(sched, "fused", x, 12, compute_dtype=JAX[compute])
    if compute == "f32":
        np.testing.assert_allclose(fused.numpy(), np.asarray(ref), **F32_TOL)
    else:
        np.testing.assert_allclose(fused.numpy(), np.asarray(ref), rtol=0,
                                   atol=_bf16_chain_bound(ref))


@pytest.mark.parametrize("state,compute", [("f32", "bf16"), ("bf16", "bf16"),
                                           ("bf16", "f32")])
def test_fused_mixed_dtype_bitwise_vs_dense(sched, state, compute):
    x = torch.from_numpy(_state(2, d=33)).to(TORCH[state])
    flags = np.asarray(sched.flags[:12], np.float32)
    outs = [make_decen(sched, backend, device="cpu",
                       compute_dtype=TORCH[compute]).run(x, flags)[0]
            for backend in ("dense", "fused")]
    assert outs[0].dtype == outs[1].dtype == x.dtype
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("block_d", [16, 32, 2048])
def test_fused_block_boundary(sched, block_d):
    # D = 37 is not a multiple of the tile: the ragged edge block
    x = _state(1)
    stack = jax_build_mixing_stack(sched.laplacians(), sched.alpha,
                                   sched.flags[:5], jnp.float32)
    port = fused_gossip_run(torch.from_numpy(x),
                            torch.from_numpy(np.array(stack)),
                            block_d=block_d)
    ref = jax_fused_gossip_run(jnp.asarray(x), stack, block_d=16,
                               interpret=True)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **F32_TOL)
    steps = torch.from_numpy(x)
    for t in range(5):
        steps = torch.matmul(torch.from_numpy(np.array(stack[t])), steps)
    np.testing.assert_allclose(port.numpy(), steps.numpy(), **F32_TOL)


@pytest.mark.parametrize("backend", ["dense", "fused", "gather"])
def test_empty_flag_stream_is_identity(sched, backend):
    x = torch.from_numpy(_state(3, d=10))
    empty = np.zeros((0, sched.flags.shape[1]), np.float32)
    out, _ = make_decen(sched, backend, device="cpu").run(x, empty)
    assert out is x
    ref, _ = jax_make_decen(sched, backend=backend).run(jnp.asarray(x.numpy()),
                                                         empty)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("chunk", [1, 4, 7, 24, 50])
def test_compose_mixing_stack_chunked_parity(sched, chunk):
    x = _state(7, d=33)
    stack = build_mixing_stack(sched.laplacians(), sched.alpha, sched.flags,
                               torch.float32)
    composed = compose_mixing_stack(stack, chunk)
    chunk2 = canonical_chunk(chunk)
    assert composed.shape[0] == (24 if chunk2 <= 1 else -(-24 // chunk2))
    ref = jax_compose(jnp.asarray(stack.numpy()), chunk)
    np.testing.assert_allclose(composed.numpy(), np.asarray(ref), **F32_TOL)
    steps = _port_run(sched, "dense", x, 24)
    chained = _port_run(sched, "fused", x, 24, chunk=chunk)
    np.testing.assert_allclose(chained.numpy(), steps.numpy(), **F32_TOL)


@pytest.mark.parametrize("w_window", [2, 4, 5, 13, 64])
@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_w_window_bitwise_matches_window1(sched, compute, w_window):
    # 13 steps: prime, so no window but 13 and 64 divides it (front
    # identity padding) and 64 exceeds it
    x = _state(11)
    kw = {"compute_dtype": TORCH[compute]}
    base = _port_run(sched, "fused", x, 13, **kw)
    out = _port_run(sched, "fused", x, 13, w_window=w_window, **kw)
    assert torch.equal(base, out)


# ------------------------------------------------- the kernel entry vs JAX


@pytest.mark.parametrize("t_steps", [1, 13])
@pytest.mark.parametrize("state,stack", [("f32", "f32"), ("f32", "bf16"),
                                         ("bf16", "bf16")])
def test_fused_gossip_run_matches_jax_kernel(sched, state, stack, t_steps):
    x = _state(4)
    w = jax_build_mixing_stack(sched.laplacians(), sched.alpha,
                               sched.flags[:t_steps], JAX[stack])
    port = fused_gossip_run(torch.from_numpy(x).to(TORCH[state]),
                            torch.from_numpy(np.array(w.astype(jnp.float32))
                                             ).to(TORCH[stack]))
    ref = jax_fused_gossip_run(jnp.asarray(x, JAX[state]), w, interpret=True)
    assert port.dtype == TORCH[state]
    if state == stack == "f32" or t_steps == 1:
        np.testing.assert_allclose(_np(port), _np(ref), **F32_TOL)
    else:
        np.testing.assert_allclose(_np(port), _np(ref), rtol=0,
                                   atol=_bf16_chain_bound(ref))


@pytest.mark.parametrize("alive", ["constant", "per-step"])
@pytest.mark.parametrize("backend", ["dense", "fused"])
def test_make_decen_masked_runs_match_jax(sched, backend, alive):
    # the fused backend has no masked multi_step: a masked chain steps
    # through the dense mix on both sides
    x = _state(6)
    mask = ALIVE if alive == "constant" else np.stack(
        [np.roll(ALIVE, t) for t in range(9)])
    port = _port_run(sched, backend, x, 9, alive=mask)
    ref = _jax_run(sched, backend, x, 9, alive=mask)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **F32_TOL)
    if alive == "constant":  # dead workers' rows are untouched
        dead = ALIVE == 0
        np.testing.assert_array_equal(port.numpy()[dead], x[dead])


@pytest.mark.parametrize("backend", ["dense", "fused"])
def test_bf16_wire_selects_bf16_compute(sched, backend):
    x = _state(8)
    wire = _port_run(sched, backend, x, 7, wire_dtype="bf16")
    compute = _port_run(sched, backend, x, 7, compute_dtype=torch.bfloat16)
    assert torch.equal(wire, compute)
    assert make_decen(sched, backend, device="cpu",
                      wire_dtype="bf16").name == f"decen[{backend},wire=bfloat16]"
    ref = _jax_run(sched, backend, x, 7, wire_dtype="bf16")
    np.testing.assert_allclose(wire.numpy(), np.asarray(ref), rtol=0,
                               atol=_bf16_chain_bound(ref))


@pytest.mark.parametrize("backend", ["dense", "gather"])
def test_kernel_knobs_warn_on_backends_that_ignore_them(sched, backend):
    with pytest.warns(UserWarning, match="ignores them"):
        make_decen(sched, backend, device="cpu", w_window=4)
    with pytest.warns(UserWarning, match="ignores them"):
        make_decen(sched, backend, device="cpu", block_d=64)


@pytest.mark.parametrize("n,warns", [(63, False), (64, True)])
def test_gather_warns_from_64_workers_on_both_sides(n, warns):
    import warnings

    from matcha_tpu.schedule import fixed_schedule as jax_fixed_schedule
    from matcha_tpu_torch.schedule import fixed_schedule
    from matcha_tpu_torch.topology import decompose_greedy, ring_graph

    dec = decompose_greedy(ring_graph(n), n)
    for build, sch in ((make_decen, fixed_schedule(dec, n, 4)),
                       (jax_make_decen, jax_fixed_schedule(dec, n, 4))):
        kw = {"device": "cpu"} if build is make_decen else {}
        if warns:
            with pytest.warns(UserWarning, match="gather"):
                build(sch, backend="gather", **kw)
        else:
            with warnings.catch_warnings():
                warnings.simplefilter("error")
                build(sch, backend="gather", **kw)


# ------------------------------------------------------ the wrapper's rules


def test_fused_empty_stream_returns_the_state(sched):
    x = torch.from_numpy(_state(5))
    empty = torch.zeros((0, N, N))
    assert fused_gossip_run(x, empty) is x
    assert fused_gossip_plain(x, empty) is x


@pytest.mark.parametrize("x_dtype,stack_dtype,shape,match", [
    (torch.float16, torch.float32, (2, N, N), "float32 or bfloat16 state"),
    (torch.float32, torch.float64, (2, N, N), "bfloat16 mixing stack"),
    (torch.float32, torch.float32, (2, N, N + 1), "vs state"),
])
def test_fused_refuses_what_the_kernel_does_not_take(x_dtype, stack_dtype,
                                                     shape, match):
    x = torch.zeros((N, D), dtype=x_dtype)
    with pytest.raises(ValueError, match=match):
        fused_gossip_run(x, torch.zeros(shape, dtype=stack_dtype))


def test_fused_plain_path_counts_no_launch(sched):
    before = dict(LAUNCHES)
    _port_run(sched, "fused", _state(), 5)
    fused_gossip_run(torch.from_numpy(_state()), torch.eye(N)[None])
    assert LAUNCHES == before


def test_fused_non_cpu_tensor_never_falls_back():
    x = torch.empty((N, D), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fused_gossip_run(x, torch.empty((2, N, N), device="meta"))


class _SmemOnly:
    """The launch-shape queries of the kernel library, with the formulas
    of ``csrc/fused_gossip.cu``: ``fp32::chain_smem_bytes`` (path 0),
    ``tc::smem_bytes`` (path 1 unsplit, 2 split), the register paths'
    largest N (``fused_gossip_reg_max_n``: 16 on paths 3 and 4), the
    shared memory they stage the stack in (64 KB), the per-step paths'
    output tile (``fused_gossip_step_tile``: 256 columns on paths 5 and
    6) and the device memory a launch takes as scratch
    (``fused_gossip_scratch_bytes``)."""

    @staticmethod
    def fused_gossip_step_tile(path):
        return {5: 256, 6: 256}.get(path, -1)

    @staticmethod
    def fused_gossip_scratch_bytes(n, d, t_steps, path, tile, state_dtype):
        def align(b):
            return -(-b // 256) * 256

        def wt(ldw):  # the f32 stack transposed, [t][k][ldw]
            return align(4 * t_steps * n * ldw)

        if path == 0:
            return wt(16384 // tile)
        if path == 5:  # f32 states between steps; a bf16 state widened
            bufs = min(2, t_steps - (1 if state_dtype == 0 else 0))
            return wt(-(-n // 128) * 128) + bufs * align(4 * n * d)
        if path == 6:  # bf16 [npad][ldx]: the cast input and the steps'
            npad, ldx = -(-n // 16) * 16, -(-d // 256) * 256
            return min(2, t_steps) * align(2 * npad * ldx)
        return 0

    @staticmethod
    def fused_gossip_smem_limit():
        return 232448

    @staticmethod
    def fused_gossip_reg_max_n(path):
        return {3: 16, 4: 16}.get(path, -1)

    @staticmethod
    def fused_gossip_stage_bytes():
        return 64 * 1024

    @staticmethod
    def fused_gossip_smem_bytes(n, tile, path=0):
        if path == 0:  # the FMA chain: one [n, tile] state, a W^T ring
            if tile not in (64, 128, 256, 512) or n > 16384 // tile:
                return -1
            rows = 16384 // tile
            return 4 * (n * tile + 3 * (32 if rows <= 64 else 16) * rows)
        # the tensor cores (tc::layout): passes of 256 rows unsplit at
        # tiles 32-128 (64 at tile 128 where N <= 64, which tile 256 does
        # not take), of 128 rows split and at the unsplit tile 256; W
        # stages of [pass rows x 64 k] (one ring, two split), as many as
        # fit up to 4 and at least 2; the bf16 state (npad x tile), one
        # buffer where a step is one pass, two otherwise; 1 KB to align,
        # 128 B of mbarriers
        split = path == 2
        if path not in (1, 2) or tile not in ((32, 64, 128) if split
                                               else (32, 64, 128, 256)):
            return -1
        npad = -(-n // 16) * 16
        if not split and tile == 256 and npad <= 64:
            return -1
        rows = 128 if split or tile == 256 else (
            64 if tile == 128 and npad <= 64 else 256)
        bufs = 2 if npad > rows else 1
        fixed = 1024 + 128 + bufs * 2 * npad * tile
        ring = (2 if split else 1) * rows * 128  # one stage of each ring
        stages = max(2, min(4, max(0, 232448 - fixed) // ring))
        return fixed + stages * ring


@pytest.mark.parametrize("n,block_d,tile", [
    (16, 2048, 512),   # the chain's widest tile: 32 rows of sums
    (33, 2048, 256),   # 64 rows of sums, 256 columns
    (16, 64, 64),      # block_d caps the tile
    (256, 2048, 64),   # N = 256: 256 rows of sums, 64 columns
    (100, 2048, 128),  # 128 rows of sums, 128 columns
    (300, 2048, 256),  # above the chain: one launch per step, 256 columns
])
def test_kernel_tile_choice(n, block_d, tile):
    from matcha_tpu_torch.parallel.fused_gossip import (_launch_shape,
                                                        kernel_path)
    path = kernel_path(torch.float32, max(n, 17))
    assert _launch_shape(_SmemOnly, n, block_d, path, 64).tile == tile


def test_kernel_refuses_a_state_too_tall_for_shared_memory():
    # the chain holds one step's sums in registers up to 256 workers; a
    # taller f32 state runs one launch per step, its state in device memory
    from matcha_tpu_torch.parallel.fused_gossip import (
        FMA, FMA_STEP, LaunchShape, _launch_shape, kernel_path)
    with pytest.raises(ValueError, match="N <= 256, got 1024"):
        _launch_shape(_SmemOnly, 1024, 2048, FMA, 64)
    assert kernel_path(torch.float32, 1024) == FMA_STEP
    assert _launch_shape(_SmemOnly, 1024, 2048, FMA_STEP, 64) == \
        LaunchShape(FMA_STEP, 256)


@pytest.mark.parametrize("n,block_d,t_steps", [(257, 2048, 1), (1024, 64, 8),
                                               (4095, 32, 1)])
@pytest.mark.parametrize("path", [5, 6])
def test_per_step_tile_is_the_library_s(n, block_d, t_steps, path):
    # a per-step path's tile is the kernel's constant, which block_d does
    # not cap: the wrapper asks the library for it
    from matcha_tpu_torch.parallel.fused_gossip import (LaunchShape,
                                                        _launch_shape)
    assert _launch_shape(_SmemOnly, n, block_d, path, t_steps) == \
        LaunchShape(path, _SmemOnly.fused_gossip_step_tile(path))


# (n, d, t, path, state dtype code, bytes): the FMA per-step path takes the
# transposed f32 stack (ldw = n rounded up to 128) and min(T - 1, 2) f32
# states (an f32 state's first step reads it in place) or min(T, 2) (a
# bf16 state is widened to f32 first); the tensor cores min(T, 2) bf16
# states of npad rows by D rounded up to 256 columns (the first step's
# input is the state cast to bf16)
SCRATCH = [
    (300, 1031, 1, 5, 0, 4 * 300 * 384),
    (300, 1031, 2, 5, 0, 4 * 300 * 384 * 2 + 1237248),
    (300, 1031, 8, 5, 0, 4 * 300 * 384 * 8 + 2 * 1237248),
    (300, 1031, 1, 5, 1, 4 * 300 * 384 + 1237248),
    (300, 1031, 2, 5, 1, 4 * 300 * 384 * 2 + 2 * 1237248),
    (1025, 4098, 1, 6, 0, 2 * 1040 * 4352),
    (1025, 4098, 1, 6, 1, 2 * 1040 * 4352),
    (1025, 4098, 3, 6, 0, 2 * 2 * 1040 * 4352),
    (4095, 273258, 1, 6, 0, 2 * 4096 * 273408),
]


@pytest.mark.parametrize("n,d,t_steps,path,state_dtype,nbytes", SCRATCH)
def test_per_step_scratch_bytes(n, d, t_steps, path, state_dtype, nbytes):
    assert _SmemOnly.fused_gossip_scratch_bytes(
        n, d, t_steps, path, 256, state_dtype) == nbytes


@pytest.mark.parametrize("n,block_d,path,t_steps,tile", [
    (256, 2048, 1, 64, 128),   # chain (b): 193 KB, one CTA per SM
    (256, 2048, 2, 2000, 128),  # the probe's split schedule: two rings
    (256, 64, 1, 64, 64),      # block_d caps the tile
    (8, 2048, 2, 32, 128),     # padded to 16 rows, split: one m64 block
    (32, 2048, 1, 64, 128),    # N <= 64: each warpgroup 64 columns
    (400, 2048, 2, 64, 64),    # 400 rows, two rings: 128 columns too many
    (1024, 2048, 1, 64, 32),   # the narrowest tile
])
def test_tensor_core_tile_choice(n, block_d, path, t_steps, tile):
    from matcha_tpu_torch.parallel.fused_gossip import _launch_shape
    assert _launch_shape(_SmemOnly, n, block_d, path, t_steps).tile == tile


@pytest.mark.parametrize("path,name", [(1, "fused_gossip"),
                                       (2, "split_gossip")])
def test_tensor_core_refuses_a_state_too_tall(path, name):
    # the shared-memory mainloop's cap stays; only the split probe (K4)
    # reaches it: the fused path rule sends such N one step at a time
    from matcha_tpu_torch.parallel.fused_gossip import (TC_STEP, _tile_width,
                                                        kernel_path)
    with pytest.raises(ValueError, match=f"{name}: 2048 workers"):
        _tile_width(_SmemOnly, 2048, 2048, path)
    assert kernel_path(torch.bfloat16, 2048) == TC_STEP


def test_bf16_stack_takes_the_tensor_cores():
    from matcha_tpu_torch.parallel.fused_gossip import (
        FMA, SPLIT, TC_REGS, TENSOR_CORE, kernel_path)
    assert kernel_path(torch.float32, 256) == FMA
    assert kernel_path(torch.bfloat16, 256) == TENSOR_CORE
    assert kernel_path(torch.bfloat16, 16) == TC_REGS
    for n in (16, 256):
        assert kernel_path(torch.bfloat16, n, split=True) == SPLIT
        with pytest.raises(ValueError, match="bfloat16 mixing stack"):
            kernel_path(torch.float32, n, split=True)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 100, 300])
def test_kernel_matches_plain_on_card(n):
    # N = 100 and 300 take two row passes per step (at tiles 128 and 32);
    # block_d = 32 gives N = 100 one pass, bitwise the same sums
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")
    from matcha_tpu_torch.schedule import fixed_schedule
    from matcha_tpu_torch.topology import decompose, ring_graph

    dev = torch.device("cuda")
    ring = fixed_schedule(decompose(ring_graph(n), n, seed=0), n, 13,
                          budget=0.5, mode="bernoulli", seed=0)
    x = torch.from_numpy(_state(6, n=n, d=1031)).to(dev)
    for stack_dtype in (torch.float32, torch.bfloat16):
        stack = build_mixing_stack(ring.laplacians(), ring.alpha,
                                   torch.as_tensor(ring.flags, device=dev),
                                   stack_dtype)
        for state in (x, x.to(torch.bfloat16)):
            ref = fused_gossip_plain(state, stack)
            base = fused_gossip_run(state, stack)
            torch.cuda.synchronize()
            exact = state.dtype == stack_dtype == torch.float32
            bound = (1e-5 if exact else 2.0 ** -7) * float(ref.abs().max())
            assert float((base.float() - ref.float()).abs().max()) <= bound
            for kw in ({"w_window": 5}, {"block_d": 32}):
                assert torch.equal(fused_gossip_run(state, stack, **kw), base)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_chain_at_1024_workers_on_card(dtype):
    # above the shared-memory paths' old caps: make_decen's fused chain
    # runs a hand-written kernel one step at a time, against its plain
    # version
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")
    from matcha_tpu_torch.parallel.fused_gossip import PATH_NAMES, kernel_path
    from matcha_tpu_torch.schedule import fixed_schedule
    from matcha_tpu_torch.topology import decompose, hypercube_graph

    n, dev = 1024, torch.device("cuda")
    cube = fixed_schedule(decompose(hypercube_graph(n), n), n, 8,
                          budget=0.5, mode="bernoulli", seed=0)
    x = torch.from_numpy(_state(6, n=n, d=1031)).to(dev).to(dtype)
    counter = f"fused_gossip/{PATH_NAMES[kernel_path(dtype, n)]}"
    before = LAUNCHES[counter]
    out, _ = make_decen(cube, "fused", device=dev,
                        compute_dtype=dtype).run(x, cube.flags)
    torch.cuda.synchronize()
    assert LAUNCHES[counter] == before + 1
    stack = build_mixing_stack(cube.laplacians(), cube.alpha,
                               torch.as_tensor(cube.flags, device=dev), dtype)
    ref = fused_gossip_plain(x, stack)
    # the plain version's products are the library's, whose sums may run
    # in another order: the bars of chip_smoke.py
    bound = (1e-5 if dtype == torch.float32 else 2.0 ** -7) * float(
        ref.float().abs().max())
    assert float((out.float() - ref.float()).abs().max()) <= bound


def _forced_run(x, stack, path):
    """One launch of ``path`` whatever N the path rule would give it."""
    from matcha_tpu_torch.parallel import fused_gossip as fg
    prep, _ = fg.prepare_stack(x, stack, 2048, 1)
    return fg.launch_kernel(x, prep, fg.kernel_shape(x.shape[0], 2048, path,
                                                     prep.shape[0]))


def _same_bits(a, b):
    as_int = torch.int32 if a.element_size() == 4 else torch.int16
    return a.dtype == b.dtype and torch.equal(a.view(as_int), b.view(as_int))


def _random_stack(n, t_steps, dtype, dev, seed=0):
    """``W_t = 0.5·I + U(0, 0.5/n)``: no ``W_t`` symmetric."""
    rng = np.random.default_rng(seed)
    w = 0.5 * np.eye(n, dtype=np.float32) + rng.random(
        (t_steps, n, n), dtype=np.float32) * np.float32(0.5 / n)
    return torch.from_numpy(w).to(dev).to(dtype)


# D = 1,031 (odd: no f32 pair aligned) and 4,098 (≡ 2 mod 4: f32 rows only
# 8-byte aligned)
@pytest.mark.cuda
@pytest.mark.parametrize("d", [1031, 4098])
@pytest.mark.parametrize("state", ["f32", "bf16"])
@pytest.mark.parametrize("n,other", [(200, "fma"), (257, "plain")])
def test_fma_step_bitwise_on_card(n, other, state, d):
    # the per-step FMA path forced below its range against the chain, and
    # just above the chain's range against the plain version: the same
    # chain of fmas per element, so the same bits
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")
    from matcha_tpu_torch.parallel.fused_gossip import FMA, FMA_STEP
    dev = torch.device("cuda")
    x = torch.from_numpy(_state(3, n=n, d=d)).to(dev).to(TORCH[state])
    stack = _random_stack(n, 3, torch.float32, dev)
    out = _forced_run(x, stack, FMA_STEP)
    ref = (_forced_run(x, stack, FMA) if other == "fma"
           else fused_gossip_plain(x, stack))
    torch.cuda.synchronize()
    assert _same_bits(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1031, 4098])
@pytest.mark.parametrize("state", ["f32", "bf16"])
@pytest.mark.parametrize("n", [1025, 1040])
def test_tc_step_bitwise_vs_tensor_core_on_card(n, state, d):
    # each element runs the shared-memory mainloop's mma sequence
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")
    from matcha_tpu_torch.parallel.fused_gossip import TC_STEP, TENSOR_CORE
    dev = torch.device("cuda")
    x = torch.from_numpy(_state(4, n=n, d=d)).to(dev).to(TORCH[state])
    stack = _random_stack(n, 3, torch.bfloat16, dev)
    out = _forced_run(x, stack, TC_STEP)
    ref = _forced_run(x, stack, TENSOR_CORE)
    torch.cuda.synchronize()
    assert _same_bits(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1031, 4098])
@pytest.mark.parametrize("state", ["f32", "bf16"])
@pytest.mark.parametrize("n", [17, 64, 256, 1000, 1024])
def test_tensor_core_bitwise_vs_tc_step_on_card(n, state, d):
    # the shared-memory mainloop (wgmma fed by TMA) across its range
    # against tc_step, which keeps the bits of the mainloop before it
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")
    from matcha_tpu_torch.parallel.fused_gossip import TC_STEP, TENSOR_CORE
    dev = torch.device("cuda")
    x = torch.from_numpy(_state(4, n=n, d=d)).to(dev).to(TORCH[state])
    stack = _random_stack(n, 3, torch.bfloat16, dev)
    out = _forced_run(x, stack, TENSOR_CORE)
    ref = _forced_run(x, stack, TC_STEP)
    torch.cuda.synchronize()
    assert _same_bits(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("state", ["f32", "bf16"])
@pytest.mark.parametrize("stack_dtype", ["f32", "bf16"])
def test_per_step_paths_at_4095_workers_on_card(stack_dtype, state):
    # the reference's fused range ends below 4096 workers: both per-step
    # paths within chip_smoke.py's bars of the plain version
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")
    n, dev = 4095, torch.device("cuda")
    x = torch.from_numpy(_state(5, n=n, d=37)).to(dev).to(TORCH[state])
    stack = _random_stack(n, 2, TORCH[stack_dtype], dev)
    out = fused_gossip_run(x, stack)
    ref = fused_gossip_plain(x, stack)
    torch.cuda.synchronize()
    exact = state == stack_dtype == "f32"
    bound = (1e-5 if exact else 2.0 ** -7) * float(ref.float().abs().max())
    assert float((out.float() - ref.float()).abs().max()) <= bound


@pytest.mark.cuda
def test_step_queries_are_the_card_library_s():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")
    from matcha_tpu_torch.parallel.fused_gossip import _library
    lib = _library()
    for path in range(7):
        assert lib.fused_gossip_step_tile(path) == \
            _SmemOnly.fused_gossip_step_tile(path)
    for n, d, t_steps, path, state_dtype, nbytes in SCRATCH:
        assert lib.fused_gossip_scratch_bytes(n, d, t_steps, path, 256,
                                              state_dtype) == nbytes
