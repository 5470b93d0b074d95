"""The fused kernel's register paths (small N) from the CPU.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them
against the plain version there).  What the CPU can check:

1. ``fused_gossip_run`` on CPU tensors (its plain version) against the JAX
   ``fused_gossip_run`` through the Pallas interpreter, at the N values
   where the register paths start and stop: N = 1, 2, 3, 15, 16, 17, 32 and
   33, every state/stack dtype pair, T = 1 and 5, an odd D.  The stacks
   are products of two mixing matrices, so no ``W_t`` is symmetric: a
   transposed ``W_t`` would show.
2. The path rule: which path and launch shape ``kernel_path`` and
   ``_launch_shape`` give for N, dtype and T, through a stand-in for the
   library's queries, at N = 1, 16, each register path's limit and the
   limit plus one; and up to 4,095 workers (the JAX planner's fused
   range), across the shared-memory paths' old caps, where every N takes
   a path and none raises.  Beside it, the plain version at N = 900 (above
   the old FMA cap) against the JAX kernel.
3. A numpy model of the tensor-core register path's layouts
   (``csrc/fused_gossip.cu``, ``tcregs``): the ``mma.m16n8k16`` fragments
   as the PTX ISA assigns them to lanes, ``ldmatrix.trans`` from the
   staging buffer, the permuted stack, the output staging, and the
   modelled chain against the plain version.
4. Numpy models of the per-step kernels' tiles, grids and ``wgmma``
   layouts, and (5.) of the shared-memory tensor-core mainloop: the TMA
   box read back through the A descriptor, the epilogue's map onto the
   N-major state and the B descriptor, and the ring's mbarrier phases.

Tolerances: f32 state and stack, or one step on an f32 state, against JAX
``rtol=1e-5, atol=1e-6`` (f32 sums in another order, as
``tests/test_torch_fused_gossip.py``).  Otherwise a bf16 operand pass:
``2⁻⁷ · max|ref|``, one bf16 ulp at the output's largest magnitude, the
bar ``chip_smoke.py`` holds the kernel to (a sum one f32 ulp apart may
round a bf16 value the other way, and dense 33-worker sums give it room).
The modelled chain is held to the same bar.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from matcha_tpu.parallel import fused_gossip_run as jax_fused_gossip_run
from matcha_tpu_torch.parallel import fused_gossip_plain, fused_gossip_run
from matcha_tpu_torch.parallel.fused_gossip import (
    FMA,
    FMA_REGS,
    FMA_STEP,
    N_CHAIN_F32,
    N_REG_F32,
    N_REG_TC,
    N_SMEM_TC,
    SPLIT,
    TC_REGS,
    TC_STEP,
    TENSOR_CORE,
    LaunchShape,
    _launch_shape,
    kernel_path,
)

D = 37  # odd: every row's pairs unaligned on the card
F32_TOL = dict(rtol=1e-5, atol=1e-6)
TORCH = {"f32": torch.float32, "bf16": torch.bfloat16}
JAX = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _mixing(rng, n):
    """``I − α·L`` of a random graph on ``n`` workers (α = 1/(deg + 1)):
    symmetric, rows summing to one."""
    adj = np.triu(rng.random((n, n)) < 0.5, 1)
    adj = (adj | adj.T).astype(np.float32)
    lap = np.diag(adj.sum(1)) - adj
    return np.eye(n, dtype=np.float32) - lap / (adj.sum(1).max() + 1)


def _stack(n, t_steps, seed=0):
    """``[T, n, n]``: each ``W_t`` the product of two mixing matrices,
    which is not symmetric."""
    rng = np.random.default_rng(seed)
    return np.stack([_mixing(rng, n) @ _mixing(rng, n)
                     for _ in range(t_steps)]).astype(np.float32)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


def _bf16(a):
    """Round an f32 array to bf16 values (round to nearest even)."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


# --------------------------------------------- 1. the port against JAX


@pytest.mark.parametrize("t_steps", [1, 5])
@pytest.mark.parametrize("state,stack", [("f32", "f32"), ("f32", "bf16"),
                                         ("bf16", "bf16")])
@pytest.mark.parametrize("n", [1, 2, 3, 15, 16, 17, 32, 33])
def test_small_n_matches_jax_kernel(n, state, stack, t_steps):
    x = np.random.default_rng(n).normal(size=(n, D)).astype(np.float32)
    w = jnp.asarray(_stack(n, t_steps, seed=n), JAX[stack])
    port = fused_gossip_run(torch.from_numpy(x).to(TORCH[state]),
                            torch.tensor(_np(w)).to(TORCH[stack]))
    ref = jax_fused_gossip_run(jnp.asarray(x, JAX[state]), w, interpret=True)
    assert port.dtype == TORCH[state] and tuple(port.shape) == (n, D)
    if state == stack == "f32" or (state == "f32" and t_steps == 1):
        np.testing.assert_allclose(_np(port), _np(ref), **F32_TOL)
    else:
        np.testing.assert_allclose(_np(port), _np(ref), rtol=0,
                                   atol=2.0 ** -7 * np.abs(_np(ref)).max())


@pytest.mark.parametrize("state,stack", [("f32", "f32"), ("f32", "bf16"),
                                         ("bf16", "bf16")])
def test_large_n_matches_jax_kernel(state, stack):
    # N = 900: above the old shared-memory FMA path's cap (843 workers),
    # which the JAX kernel never had; the card runs it one step a launch
    n, t_steps = 900, 2
    x = np.random.default_rng(n).normal(size=(n, D)).astype(np.float32)
    w = jnp.asarray(_stack(n, t_steps, seed=n), JAX[stack])
    port = fused_gossip_run(torch.from_numpy(x).to(TORCH[state]),
                            torch.tensor(_np(w)).to(TORCH[stack]))
    ref = jax_fused_gossip_run(jnp.asarray(x, JAX[state]), w, interpret=True)
    assert port.dtype == TORCH[state] and tuple(port.shape) == (n, D)
    if state == stack == "f32":
        np.testing.assert_allclose(_np(port), _np(ref), **F32_TOL)
    else:
        np.testing.assert_allclose(_np(port), _np(ref), rtol=0,
                                   atol=2.0 ** -7 * np.abs(_np(ref)).max())


# ---------------------------------------------------- 2. the path rule


class _Lib:
    """The library's launch-shape queries, with the formulas of
    ``csrc/fused_gossip.cu``: the register paths' largest N, the 64 KB
    they stage the stack in, the per-step paths' 256-column tiles, and the
    shared-memory paths' bytes (256-column tiles and below;
    ``tests/test_torch_fused_gossip.py`` pins those)."""

    @staticmethod
    def fused_gossip_reg_max_n(path):
        return {FMA_REGS: 16, TC_REGS: 16}.get(path, -1)

    @staticmethod
    def fused_gossip_stage_bytes():
        return 64 * 1024

    @staticmethod
    def fused_gossip_step_tile(path):
        return {FMA_STEP: 256, TC_STEP: 256}.get(path, -1)

    @staticmethod
    def fused_gossip_smem_limit():
        return 232448

    @staticmethod
    def fused_gossip_smem_bytes(n, tile, path):
        if path == FMA:  # the chain: 16,384 sums, a 3-stage ring of W^T
            if tile not in (64, 128, 256, 512) or n > 16384 // tile:
                return -1
            rows = 16384 // tile
            return 4 * (n * tile + 3 * (32 if rows <= 64 else 16) * rows)
        split = path == SPLIT
        if path not in (TENSOR_CORE, SPLIT) or tile not in (
                (32, 64, 128) if split else (32, 64, 128, 256)):
            return -1
        # tc::layout: [pass rows x 64 k] W stages, 2 to 4 a ring; the bf16
        # state (npad x tile), twice where a step takes two passes
        npad = -(-n // 16) * 16
        if not split and tile == 256 and npad <= 64:
            return -1
        rows = 128 if split or tile == 256 else (
            64 if tile == 128 and npad <= 64 else 256)
        bufs = 2 if npad > rows else 1
        fixed = 1024 + 128 + bufs * 2 * npad * tile
        ring = (2 if split else 1) * rows * 128
        stages = max(2, min(4, max(0, 232448 - fixed) // ring))
        return fixed + stages * ring


def test_register_limits_are_the_library_s():
    assert (N_REG_F32, N_REG_TC) == (_Lib.fused_gossip_reg_max_n(FMA_REGS),
                                     _Lib.fused_gossip_reg_max_n(TC_REGS))


@pytest.mark.parametrize("stack,n,t_steps,want", [
    # f32 stack: N padded to 8 or 16 rows, 512 columns a CTA and round, the
    # whole stack staged where it takes at most 64 KB
    ("f32", 1, 1, LaunchShape(FMA_REGS, 512, 8, 1)),
    ("f32", 1, 64, LaunchShape(FMA_REGS, 512, 8, 64)),
    ("f32", 8, 2000, LaunchShape(FMA_REGS, 512, 8, 256)),
    ("f32", 9, 4, LaunchShape(FMA_REGS, 512, 16, 4)),
    ("f32", 16, 1, LaunchShape(FMA_REGS, 512, 16, 1)),
    ("f32", 16, 64, LaunchShape(FMA_REGS, 512, 16, 64)),
    ("f32", 16, 2000, LaunchShape(FMA_REGS, 512, 16, 64)),
    ("f32", 17, 64, LaunchShape(FMA, 512, 32)),
    # bf16 stack: one m16 tile of workers, 512 B of B fragments a step
    ("bf16", 1, 1, LaunchShape(TC_REGS, 256, 16, 1)),
    ("bf16", 16, 64, LaunchShape(TC_REGS, 256, 16, 64)),
    ("bf16", 16, 2000, LaunchShape(TC_REGS, 256, 16, 128)),
    ("bf16", 17, 64, LaunchShape(TENSOR_CORE, 128)),
])
def test_path_rule(stack, n, t_steps, want):
    # the state's dtype is no argument: it never changes the path or shape
    path = kernel_path(TORCH[stack], n)
    assert path == want.path
    assert _launch_shape(_Lib, n, 2048, path, t_steps) == want


@pytest.mark.parametrize("path,n", [(FMA_REGS, N_REG_F32 + 1),
                                    (TC_REGS, N_REG_TC + 1)])
def test_register_path_refuses_past_its_limit(path, n):
    with pytest.raises(ValueError, match=f"got {n}"):
        _launch_shape(_Lib, n, 2048, path, 1)


@pytest.mark.cuda
def test_register_limits_and_stage_are_the_card_library_s():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs the paths there")
    from matcha_tpu_torch.parallel.fused_gossip import _library
    lib = _library()
    for path in (FMA_REGS, TC_REGS, FMA, TENSOR_CORE, SPLIT):
        assert lib.fused_gossip_reg_max_n(path) == \
            _Lib.fused_gossip_reg_max_n(path)
    assert lib.fused_gossip_stage_bytes() == _Lib.fused_gossip_stage_bytes()


# The shared-memory paths' caps before the per-step paths: the old FMA path
# (two f32 tiles of 32 columns and its W chunks) took N <= 843; the
# tensor cores' two tile-32 states and two W stages fit shared memory to
# N = 1,280.
OLD_FMA_CAP = 843
TC_SMEM_CAP = max(n for n in range(1024, 2048)
                  if 0 <= _Lib.fused_gossip_smem_bytes(n, 32, TENSOR_CORE)
                  <= _Lib.fused_gossip_smem_limit())


@pytest.mark.parametrize("n", [17, 255, 256, 257, 1024, 4095,
                               OLD_FMA_CAP, OLD_FMA_CAP + 1,
                               TC_SMEM_CAP, TC_SMEM_CAP + 1])
@pytest.mark.parametrize("stack", ["f32", "bf16"])
def test_every_n_takes_a_path(stack, n):
    path = kernel_path(TORCH[stack], n)
    if stack == "f32":
        assert path == (FMA if n <= N_CHAIN_F32 else FMA_STEP)
    else:
        assert path == (TENSOR_CORE if n <= N_SMEM_TC else TC_STEP)
    for t_steps in (1, 8, 64):
        shape = _launch_shape(_Lib, n, 2048, path, t_steps)
        assert shape.path == path and shape.tile > 0
    if path == TENSOR_CORE:  # its tile fits shared memory at this N
        assert 0 <= _Lib.fused_gossip_smem_bytes(n, shape.tile, path) \
            <= _Lib.fused_gossip_smem_limit()


def test_tc_smem_cap_is_above_the_path_rule_s():
    assert TC_SMEM_CAP == 1280 and N_SMEM_TC < TC_SMEM_CAP


def test_block_d_caps_only_the_shared_memory_tiles():
    assert _launch_shape(_Lib, 16, 32, FMA_REGS, 1).tile == 512
    assert _launch_shape(_Lib, 16, 32, TC_REGS, 1).tile == 256
    # the FMA chain's narrowest tile is 64 columns (256 rows)
    assert _launch_shape(_Lib, 33, 32, FMA, 1) == LaunchShape(FMA, 64, 256)


# ------------------------------- 3. the tensor-core register path's layouts

# mma.m16n8k16 with g = lane // 4, t = lane % 4 (PTX ISA, bf16 operands):
# register r of A holds the pair (row, col), (row, col + 1) below, of D
# element e the (row, col) below; B's b0 holds (k = 2t, 2t+1; n = g) and b1
# (k = 2t+8, 2t+9; n = g).
A_AT = [lambda g, t: (g, 2 * t), lambda g, t: (g + 8, 2 * t),
        lambda g, t: (g, 2 * t + 8), lambda g, t: (g + 8, 2 * t + 8)]
D_AT = [lambda g, t: (g, 2 * t), lambda g, t: (g, 2 * t + 1),
        lambda g, t: (g + 8, 2 * t), lambda g, t: (g + 8, 2 * t + 1)]
STRIDE = 36  # the staging buffer's f32 per row (tcregs::kStride, kCT = 2)


def a_fragments(a):
    """Lane -> 4 registers, each a (low, high) pair, of A [16 m][16 k]."""
    out = []
    for lane in range(32):
        g, t = divmod(lane, 4)
        out.append([(a[r, c], a[r, c + 1])
                    for r, c in (f(g, t) for f in A_AT)])
    return out


def b_fragments(w, j):
    """Lane -> (b0, b1) of n8 tile j of B = W^T, each a (low, high) pair:
    B[k][n] = W[n][k]."""
    out = []
    for lane in range(32):
        g, t = divmod(lane, 4)
        row = w[g + 8 * j]
        out.append(((row[2 * t], row[2 * t + 1]),
                    (row[2 * t + 8], row[2 * t + 9])))
    return out


def mma(a_frag, b_frag):
    """D = A·B from the lanes' fragments (f64 sums rounded to f32), as
    lane -> the 4 D elements it holds."""
    a = np.zeros((16, 16))
    b = np.zeros((16, 8))
    for lane in range(32):
        g, t = divmod(lane, 4)
        for f, pair in zip(A_AT, a_frag[lane]):
            r, c = f(g, t)
            a[r, c], a[r, c + 1] = pair
        b[2 * t:2 * t + 2, g] = b_frag[lane][0]
        b[2 * t + 8:2 * t + 10, g] = b_frag[lane][1]
    d = (a @ b).astype(np.float32)
    return [[d[f(*divmod(lane, 4))] for f in D_AT] for lane in range(32)]


def next_a(d0, d1):
    """The kernel's packing: the two n8 tiles' accumulators as the next
    A fragment (tcregs: a[0] = d0[0:2], a[1] = d0[2:4], a[2] = d1[0:2],
    a[3] = d1[2:4])."""
    return [[(d0[l][0], d0[l][1]), (d0[l][2], d0[l][3]),
             (d1[l][0], d1[l][1]), (d1[l][2], d1[l][3])] for l in range(32)]


def ldmatrix_x4_trans(buf, row_addr):
    """``ldmatrix.sync.aligned.m8n8.x4.trans.b16``: lanes 8q..8q+7 give the
    8 rows (16 bytes, as [row, first column] of ``buf``) of matrix q;
    register q of lane i gets (row 2(i%4), col i/4) and (row 2(i%4)+1,
    col i/4) of it."""
    out = [[None] * 4 for _ in range(32)]
    for q in range(4):
        rows = [row_addr(8 * q + r) for r in range(8)]
        for i in range(32):
            g, t = divmod(i, 4)
            (r0, c0), (r1, c1) = rows[2 * t], rows[2 * t + 1]
            out[i][q] = (buf[r0, c0 + g], buf[r1, c1 + g])
    return out


def staging_a(x_tile):
    """The kernel's A fragments of tile c = 0 of a [16 workers][32 cols]
    staging buffer: matrix mq = lane/8 at k = 8·(mq/2) + lane%8,
    m = 8·(mq%2)."""
    def addr(lane):
        mq, mrow = divmod(lane, 8)
        return ((mq >> 1) * 8 + mrow, (mq & 1) * 8)
    return ldmatrix_x4_trans(x_tile, addr)


def permuted_stack(w):
    """The kernel's fill: word wi = r·8 + w of W_t (row r, k = 2w, 2w+1)
    goes to lane (r%8)·4 + w%4, slot (r/8)·2 + w/4."""
    words = [[None] * 4 for _ in range(32)]
    for r in range(16):
        for w8 in range(8):
            lane = (r % 8) * 4 + w8 % 4
            slot = (r // 8) * 2 + w8 // 4
            words[lane][slot] = (w[r, 2 * w8], w[r, 2 * w8 + 1])
    return words


def test_accumulators_are_the_next_a_fragment():
    # D's element (m, n) lands where the next step's A wants (m, k = n)
    d = np.arange(256, dtype=np.float64).reshape(16, 16)  # [m][n]
    d0 = [[d[f(*divmod(l, 4))] for f in D_AT] for l in range(32)]
    d1 = [[d[r, c + 8] for r, c in (f(*divmod(l, 4)) for f in D_AT)]
          for l in range(32)]
    assert next_a(d0, d1) == a_fragments(d)


def test_ldmatrix_trans_of_the_staging_buffer_is_the_a_fragment():
    x = np.arange(16 * 32, dtype=np.float64).reshape(16, 32)  # [k][col]
    assert staging_a(x) == a_fragments(x[:, :16].T)


def test_permuted_stack_is_one_load_of_b_fragments_per_lane():
    w = np.arange(256, dtype=np.float64).reshape(16, 16)
    words = permuted_stack(w)
    for lane in range(32):
        assert words[lane][0:2] == list(b_fragments(w, 0)[lane])
        assert words[lane][2:4] == list(b_fragments(w, 1)[lane])


def test_output_staging_is_the_product_in_the_state_s_layout():
    rng = np.random.default_rng(3)
    xt = rng.normal(size=(16, 16))  # [m][k] = x^T
    w = rng.normal(size=(16, 16))
    d0 = mma(a_fragments(xt), b_fragments(w, 0))
    d1 = mma(a_fragments(xt), b_fragments(w, 1))
    stage = np.full((16, STRIDE), np.nan)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for j, dj in enumerate((d0, d1)):
            w0 = 8 * j + 2 * t
            stage[w0, g], stage[w0 + 1, g] = dj[lane][0], dj[lane][1]
            stage[w0, g + 8], stage[w0 + 1, g + 8] = dj[lane][2], dj[lane][3]
    np.testing.assert_allclose(stage[:, :16], (w @ xt.T).astype(np.float32),
                               rtol=1e-6)


def test_staging_accesses_are_free_of_bank_conflicts():
    # ldmatrix: the 8 rows of one matrix in 8 distinct 16-byte granules of
    # the 128 bytes the banks span (a row is 144 bytes)
    for q in range(4):
        granules = {(((q >> 1) * 8 + r) * STRIDE * 4 + (q & 1) * 16) % 128
                    // 16 for r in range(8)}
        assert len(granules) == 8
    # the accumulators' f32 stores: 32 lanes, 32 banks, for each element
    for e in range(4):
        banks = set()
        for lane in range(32):
            g, t = divmod(lane, 4)
            w0 = 2 * t + (e & 1)
            banks.add((w0 * STRIDE + g + 8 * (e >> 1)) % 32)
        assert len(banks) == 32


def _modelled_chain(x, stack, state):
    """The tensor-core register path on one 16-column tile, through the
    fragments: bf16 A from the staging buffer, the padded workers zeroed
    every step, the last step's f32 sums rounded to the state dtype."""
    n = x.shape[0]
    pad = np.zeros((16, 32), np.float32)
    pad[:n, :x.shape[1]] = x
    a = staging_a(_bf16(pad).astype(np.float64))
    for w in stack:
        wp = np.zeros((16, 16))
        wp[:n, :n] = _bf16(w)
        d = [mma(a, b_fragments(wp, j)) for j in (0, 1)]
        for lane in range(32):
            t = lane % 4
            for j in (0, 1):
                w0 = 8 * j + 2 * t
                for e in range(4):
                    if w0 + (e & 1) >= n:
                        d[j][lane][e] = 0.0
        a = [[tuple(_bf16(np.array(p)).astype(np.float64)) for p in regs]
             for regs in next_a(*d)]
    out = np.zeros((16, 16), np.float32)  # [worker][column]
    for lane in range(32):
        for j in (0, 1):
            for e, f in enumerate(D_AT):
                m, c = f(*divmod(lane, 4))
                out[8 * j + c, m] = d[j][lane][e]
    out = out[:n, :x.shape[1]]
    return _bf16(out) if state == "bf16" else out


@pytest.mark.parametrize("state", ["f32", "bf16"])
@pytest.mark.parametrize("n,t_steps", [(1, 3), (3, 5), (16, 1), (16, 5)])
def test_modelled_chain_matches_the_plain_version(n, t_steps, state):
    rng = np.random.default_rng(n + t_steps)
    x = rng.normal(size=(n, 16)).astype(np.float32)
    if state == "bf16":
        x = _bf16(x)
    stack = _stack(n, t_steps, seed=n)
    ref = fused_gossip_plain(torch.from_numpy(x).to(TORCH[state]),
                             torch.from_numpy(stack).to(torch.bfloat16))
    got = _modelled_chain(x, stack, state)
    np.testing.assert_allclose(got, _np(ref), rtol=0,
                               atol=2.0 ** -7 * np.abs(_np(ref)).max())


def test_modelled_chain_keeps_an_inf_out_of_the_padded_workers():
    # 0 * inf is NaN: without the per-step zeroing a padded worker's sum
    # in the inf's column would be NaN and carry it into every real row on
    # the next step.  With every W_t entry positive the plain version keeps
    # that column at +inf.
    x = np.ones((3, 16), np.float32)
    x[1, 4] = np.inf
    stack = np.stack([0.5 * np.eye(3) + 0.5 / 3] * 3).astype(np.float32)
    got = _modelled_chain(x, stack, "f32")
    ref = _np(fused_gossip_plain(torch.from_numpy(x),
                                 torch.from_numpy(stack).to(torch.bfloat16)))
    assert np.isposinf(ref[:, 4]).all()
    assert np.isfinite(np.delete(ref, 4, 1)).all()
    np.testing.assert_array_equal(got, ref)


# ----------------------------------------- 4. the per-step kernels' maps

# Copies of the index maps of csrc/fused_gossip.cu's per-step kernels
# (fp32::fma_step_kernel, tc::tc_step_kernel), which only the card runs:
# the tiles must cover every output element once, the grid every tile
# once, and the tensor cores' stages must be wgmma's 128-byte-swizzled
# layouts, in which 8 rows of one 16-byte granule fall in 8 bank groups.
STEP_ROWS, STEP_COLS, TC_STEP_K = 128, 256, 64


def step_w_idx(r, k):
    """tc::step_w_idx: element (r, k) of a [128][64] bf16 W stage."""
    return r * TC_STEP_K + ((((k >> 3) ^ r) & 7) << 3) + (k & 7)


def step_x_idx(k, c):
    """tc::step_x_idx: element (k, c) of a [64][256] bf16 state stage."""
    return ((c >> 6) * (TC_STEP_K * 64) + k * 64
            + ((((c >> 3) ^ k) & 7) << 3) + (c & 7))


def sw128(byte):
    """The 128-byte swizzle wgmma applies to a byte address of a stage
    that starts on a 1024-byte boundary: 16-byte granule bits 4-6 XOR
    bits 7-9."""
    return byte ^ (((byte >> 7) & 7) << 4)


def step_tile(b, row_tiles):
    """Both per-step kernels' grids: block b -> (row tile, column tile),
    the row tiles fastest."""
    return b % row_tiles, b // row_tiles


@pytest.mark.parametrize("idx,rows,cols", [(step_w_idx, 128, 64),
                                           (step_x_idx, 64, 256)])
def test_tc_step_stages_are_swizzled_without_bank_conflicts(idx, rows, cols):
    at = np.array([[idx(r, c) for c in range(cols)] for r in range(rows)])
    assert sorted(at.ravel()) == list(range(rows * cols))  # a permutation
    # every granule of 8 stays whole and 16-byte aligned
    assert (at[:, ::8] % 8 == 0).all()
    assert (np.diff(at.reshape(rows, cols // 8, 8), axis=2) == 1).all()
    # 8 consecutive rows (8-aligned) of one granule: the W stage's rows or
    # the state stage's k
    for r0 in range(0, rows, 8):
        for c0 in range(0, cols, 8):
            banks = {(at[r0 + i, c0] * 2 // 16) % 8 for i in range(8)}
            assert len(banks) == 8


def test_tc_step_stages_are_wgmma_s_canonical_layouts():
    # W_t, K-major: row r of 64 k is 128 B at r*128 (8-row groups 1024 B
    # apart, the descriptor's stride); the state, N-major: the 64-column
    # segment s, row k is 128 B at s*8192 + k*128 (segments 8 KB apart,
    # 8-k groups 1024 B apart).  Each element sits where the swizzle puts
    # its unswizzled address.
    for r in range(128):
        for k in range(64):
            assert 2 * step_w_idx(r, k) == sw128(r * 128 + 2 * k)
    for k in range(64):
        for c in range(256):
            plain = (c // 64) * 8192 + k * 128 + 2 * (c % 64)
            assert 2 * step_x_idx(k, c) == sw128(plain)


@pytest.mark.parametrize("n,d", [(4095, 273258 // 100), (257, 4098),
                                 (1024, 1031), (300, 256), (1040, 700)])
def test_per_step_grid_covers_every_tile_once(n, d):
    row_tiles, col_tiles = -(-n // STEP_ROWS), -(-d // STEP_COLS)
    tiles = [step_tile(b, row_tiles) for b in range(row_tiles * col_tiles)]
    assert sorted(tiles) == [(r, c) for r in range(row_tiles)
                             for c in range(col_tiles)]
    assert [t[0] for t in tiles[:row_tiles]] == list(range(row_tiles))


def test_fma_step_threads_cover_the_tile_once():
    # thread (g, l) of 16 x 16 sums rows 8g..8g+7 by columns 4l + 64q + j
    cover = np.zeros((STEP_ROWS, STEP_COLS), int)
    for g in range(16):
        for l in range(16):
            for r in range(8):
                for q in range(4):
                    for j in range(4):
                        cover[8 * g + r, 64 * q + 4 * l + j] += 1
    assert (cover == 1).all()


def test_tc_step_warpgroups_cover_the_tile_once_on_the_mma_grid():
    # two warpgroups of m64n256: accumulator i of lane `lane` of warp w is
    # n8 block i // 4 of the m16n8 fragment (D_AT) at rows 64*wg + 16*w;
    # every element keeps its place in its m16n8 tile, as in the mainloop
    cover = np.zeros((STEP_ROWS, STEP_COLS), int)
    for wg in range(2):
        for w in range(4):
            for lane in range(32):
                for i in range(128):
                    r, c = D_AT[i % 4](*divmod(lane, 4))
                    r0, c0 = 64 * wg + 16 * w, 8 * (i // 4)
                    assert r0 % 16 == 0 and c0 % 8 == 0
                    cover[r0 + r, c0 + c] += 1
    assert (cover == 1).all()


# ------------------- 5. the shared-memory mainloop's layouts and its ring

# Copies of csrc/fused_gossip.cu's tc::plan, tc::layout, StateLayout and
# the index maps of tc_gossip_kernel (TENSOR_CORE and SPLIT), which only
# the card runs: the TMA box of W_t is the K-major stage wgmma's A reads,
# the epilogue writes every element of the next state once where the B
# descriptor reads it, and the ring's full and empty mbarriers hand each
# slot over in order.

def tc_plan(n, tile, split):
    """tc::plan: (m64 blocks a warpgroup, its columns, rows a pass, by
    columns), or None for a tile the path does not take at n."""
    npad = -(-n // 16) * 16
    if split:
        return (2, tile // 2, 128, True) if tile in (128, 64, 32) else None
    if tile == 256:
        return None if npad <= 64 else (2, 128, 128, True)
    if tile == 128 and npad <= 64:
        return (1, 64, 64, True)
    return (2, tile, 256, False) if tile in (32, 64, 128) else None


def tc_stages(n, tile, split):
    """tc::layout's W stages a ring: as many as fit, 2 to 4."""
    _, _, rows, _ = tc_plan(n, tile, split)
    npad = -(-n // 16) * 16
    bufs = 2 if npad > rows else 1
    fixed = 1024 + 128 + bufs * 2 * npad * tile
    ring = (2 if split else 1) * rows * 128
    return max(2, min(4, max(0, 232448 - fixed) // ring))


def swizzle(byte, row_bytes):
    """wgmma's (and TMA's) swizzle of a byte address in rows of 128, 64 or
    32 bytes: the 16-byte granule bits XOR address bits 7 and up."""
    mask = {128: 7, 64: 3, 32: 1}[row_bytes]
    return byte ^ (((byte >> 7) & mask) << 4)


def state_byte(k, c, npad, sw):
    """StateLayout<NW>::idx in bytes: segments of sw columns, each npad
    rows (k) of 2*sw bytes."""
    return swizzle((c // sw) * npad * 2 * sw + k * 2 * sw + (c % sw) * 2,
                   2 * sw)


@pytest.mark.parametrize("n", [17, 32, 256, 1000])
@pytest.mark.parametrize("rows", [64, 128, 256])
def test_tma_box_is_the_k_major_stage_wgmma_reads(n, rows):
    # the 3-D box {64 k, box rows, 1} at (64c, p*rows, t), 128-byte
    # swizzled into a stage on a 1024-byte boundary, read back through
    # sw128_desc (8-row groups 1024 B apart, a k16 block 32 B on): W_t's
    # rows of the pass, zero past npad in rows and in k, never step t+1's
    rng = np.random.default_rng(n)
    npad = -(-n // 16) * 16
    t_steps = 2
    stack = np.zeros((t_steps, npad, npad))
    stack[:, :n, :n] = rng.random((t_steps, n, n)) + 1.0
    box = min(rows, npad)
    r = np.arange(box)[:, None]
    kk = np.arange(64)[None, :]
    m = np.arange(64)[:, None]
    kq = np.arange(16)[None, :]
    for t in range(t_steps):
        for p in range(-(-npad // rows)):
            for c in range(-(-npad // 64)):
                stage = np.full(rows * 64, np.nan)  # rows past the box: stale
                rr, kc = p * rows + r, 64 * c + kk
                inside = (rr < npad) & (kc < npad)
                vals = np.where(inside, stack[t, np.minimum(rr, npad - 1),
                                              np.minimum(kc, npad - 1)], 0.0)
                stage[swizzle(r * 128 + 2 * kk, 128) // 2] = vals
                for block in range(rows // 64):
                    for s in range(4):
                        if 64 * c + 16 * s >= npad:  # the kernel's k16 test
                            continue
                        at = (block * 64 * 128 + s * 32 + (m // 8) * 1024
                              + (m % 8) * 128 + 2 * kq)
                        a = stage[swizzle(at, 128) // 2]
                        i = p * rows + block * 64 + m
                        k = 64 * c + 16 * s + kq
                        want = np.where(i < npad, stack[t, np.minimum(
                            i, npad - 1), k], 0.0)
                        live = (block * 64 + m < box).repeat(16, 1)
                        np.testing.assert_array_equal(a[live], want[live])
                        # a row the box holds past npad reads zero
                        assert (a[live & (i >= npad)] == 0).all()


SCHEDULES = [(17, 128, False), (64, 128, False), (100, 256, False),
             (256, 128, False), (256, 64, False), (1000, 32, False),
             (8, 128, True), (256, 128, True), (400, 64, True),
             (1000, 32, True)]


@pytest.mark.parametrize("n,tile,split", SCHEDULES)
def test_epilogue_writes_every_state_element_once(n, tile, split):
    # a consumer thread's accumulator v of m64 block m in pass p goes to
    # the byte the kernel computes (its row base, the 8-column group's
    # segment, h*8 rows, the granule XOR fixed by g); over a step every
    # element of the npad x tile state is written once, where StateLayout
    # puts it and the N-major B descriptor (segments npad rows apart, 8-row
    # groups 8 rows apart) reads it
    mb, nw, rows, cols = tc_plan(n, tile, split)
    npad = -(-n // 16) * 16
    sw = min(64, nw)
    row_bytes = 2 * sw
    seg_bytes = npad * row_bytes
    written = {}
    for p in range(-(-npad // rows)):
        for wg in range(2):
            row_off = 0 if cols else wg * 64 * mb
            col_off = wg * nw if cols else 0
            row0 = p * rows + row_off
            for m in range(mb):
                for wwarp in range(4):
                    i0 = row0 + m * 64 + 16 * wwarp
                    live = (not cols or row0 + m * 64 < npad) and i0 < npad
                    for lane in range(32):
                        g, t4 = divmod(lane, 4)
                        swz = ((g * row_bytes) >> 7) & {64: 7, 32: 3,
                                                        16: 1}[sw]
                        base = ((col_off // sw) * seg_bytes
                                + (i0 + g) * row_bytes + 4 * t4)
                        for v in range(0, nw // 2, 2):
                            grp, h = v >> 2, (v >> 1) & 1
                            at = (base + (grp * 8 // sw) * seg_bytes
                                  + 8 * h * row_bytes
                                  + (((grp * 8) % sw // 8) ^ swz) * 16)
                            i = i0 + g + 8 * h
                            c = col_off + 8 * grp + 2 * t4
                            assert at == state_byte(i, c, npad, sw)
                            if live:
                                for e in (0, 1):
                                    written.setdefault(at + 2 * e, []).append(
                                        (i, c + e))
    assert all(len(w) == 1 for w in written.values())
    assert sorted(w[0] for w in written.values()) == [
        (i, c) for i in range(npad) for c in range(tile)]
    assert max(written) < npad * tile * 2
    # the B descriptor of warpgroup wg at k0 reads element (k0 + kk, nn)
    for wg in range(2):
        col_off = wg * nw if cols else 0
        for k0 in range(0, npad, 16):
            kk = np.arange(16)[:, None]
            nn = np.arange(nw)[None, :]
            start = (col_off // sw) * seg_bytes + k0 * row_bytes
            at = swizzle(start + (nn // sw) * seg_bytes + (kk // 8) * 8
                         * row_bytes + (kk % 8) * row_bytes + 2 * (nn % sw),
                         row_bytes)
            want = state_byte(k0 + kk, col_off + nn, npad, sw)
            np.testing.assert_array_equal(at, want)


class _MBarrier:
    """An mbarrier: a phase completes when its arrivals and its
    transaction bytes are all in; try_wait.parity(P) passes while the
    current phase's parity is not P."""

    def __init__(self, count):
        self.count, self.pending, self.tx, self.done = count, count, 0, 0

    def arrive(self, expect_tx=0):
        self.pending -= 1
        self.tx += expect_tx
        self._complete()

    def land(self, nbytes):
        self.tx -= nbytes
        self._complete()

    def _complete(self):
        if self.pending == 0 and self.tx == 0:
            self.done += 1
            self.pending = self.count

    def passes(self, parity, phase_wanted):
        ok = (self.done & 1) != parity
        if ok:  # the phase the waiter wants, never one a round later
            assert self.done == phase_wanted + 1
        return ok


def _ring_run(n, tile, split, t_steps, seed):
    """The kernel's producer lane(s) and consumer warps on the ring(s),
    scheduled in a random order: returns the chunks each consumer warp
    read, in order, and checks that no slot is refilled while a warp
    still reads it."""
    mb, nw, rows, cols = tc_plan(n, tile, split)
    npad = -(-n // 16) * 16
    stages = tc_stages(n, tile, split)
    passes, kchunks = -(-npad // rows), -(-npad // 64)
    chunks = t_steps * passes * kchunks
    rings = 2 if split else 1
    warps = 4 if split else 8  # the warps that release a ring's stage
    full = [[_MBarrier(1) for _ in range(stages)] for _ in range(rings)]
    empty = [[_MBarrier(warps) for _ in range(stages)] for _ in range(rings)]
    slot_holds = [[None] * stages for _ in range(rings)]
    reading = [[set() for _ in range(stages)] for _ in range(rings)]
    in_flight = []  # (ring, slot, chunk): TMA loads not yet landed
    read = {}

    def producer(rg):
        for q in range(chunks):
            s, rnd = q % stages, q // stages
            while not empty[rg][s].passes((rnd & 1) ^ 1, rnd - 1):
                yield
            assert not reading[rg][s]  # every warp released the slot
            slot_holds[rg][s] = None
            full[rg][s].arrive(expect_tx=rows * 128)
            in_flight.append((rg, s, q))
            yield

    def consumer(w):
        rg = w // 4 if split else 0
        prev = None
        for q in range(chunks):
            s, rnd = q % stages, q // stages
            while not full[rg][s].passes(rnd & 1, rnd):
                yield
            assert slot_holds[rg][s] == q  # this round's load landed
            reading[rg][s].add(w)
            read.setdefault(w, []).append(q)
            yield
            if prev is not None:  # wgmma_wait<1>: chunk q-1 is summed
                reading[rg][prev].discard(w)
                empty[rg][prev].arrive()
            prev = s
            if (q + 1) % kchunks == 0:  # the pass ends: wait<0>
                reading[rg][s].discard(w)
                empty[rg][s].arrive()
                prev = None
            yield

    rng = np.random.default_rng(seed)
    actors = [producer(r) for r in range(rings)] + [consumer(w)
                                                    for w in range(8)]
    steps = 0
    while actors or in_flight:
        steps += 1
        assert steps < 400 * (chunks + 10), "the ring deadlocked"
        if in_flight and (not actors or rng.random() < 0.3):
            rg, s, q = in_flight.pop(rng.integers(len(in_flight)))
            slot_holds[rg][s] = q
            full[rg][s].land(rows * 128)
            continue
        a = actors[rng.integers(len(actors))]
        try:
            next(a)
        except StopIteration:
            actors.remove(a)
    return read, chunks


@pytest.mark.parametrize("t_steps", [1, 2, 64])
@pytest.mark.parametrize("n,tile,split", [(17, 128, False), (100, 256, False),
                                          (256, 128, False), (300, 128, False),
                                          (1024, 32, False), (17, 128, True),
                                          (256, 128, True), (1000, 32, True)])
def test_ring_fills_and_releases_each_slot_in_order(n, tile, split, t_steps):
    # the flat chunk sequence (step, pass, 64-k chunk) through 2-4 slots:
    # each consumer warp reads every chunk once, in order, a slot only
    # after its load landed and never after it was refilled, and no wait
    # passes on a phase a round ahead of the one it wants
    read, chunks = _ring_run(n, tile, split, t_steps, seed=n + t_steps)
    assert all(read[w] == list(range(chunks)) for w in range(8))
