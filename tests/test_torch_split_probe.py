"""The split-step probe (K4) of the port against the JAX package.

The reference probe (``benchmarks/split_probe.py``) builds its Pallas
kernels inside ``main()`` and passes no ``interpret`` flag, so they cannot
run on the CPU.  K4's arithmetic is K3's on a bf16 stack: every step
``x ← bf16(W_t @ x)`` with f32 accumulation, the split being a schedule of
the same products.  So the port's ``split_gossip_run`` (on CPU tensors, its
plain version) is held against the JAX package's ``fused_gossip_run``
through the Pallas interpreter, with the same ``block_d`` and ``w_window``;
T is a multiple of ``w_window``, so neither side pads.  Inputs come from
numpy with a fixed seed and are rounded to bf16 before both sides see them.

Tolerances (as ``tests/test_torch_fused_gossip.py``):

* T = 1: ``rtol=1e-5, atol=1e-6``.  Products of bf16 operands are exact in
  f32 on both sides; only the order of the f32 sum may differ, and the
  output rounds that sum to bf16 once.
* A chain: ``2⁻⁸ · max|ref|``, half a bf16 ulp at the output's largest
  magnitude, for a sum one f32 ulp apart that rounds a later step's bf16
  state the other way.
* Split against unsplit: bitwise (on the CPU both are the plain version;
  on the card the ``cuda``-marked tests hold the two kernel schedules to
  each other bitwise).
* The kernel against the plain version on the card: one bf16 ulp at the
  output's largest magnitude, or twice the plain version's own spread when
  its sums are taken in another order, whichever is larger.  The probe's
  random ``W_t`` shrink the state about as fast as they shrink rounding
  differences, so a chain does not forget its flipped roundings as a
  gossip chain does.

The CUDA kernel runs only on the card: the ``cuda``-marked tests skip on a
host without one; ``chip_smoke.py`` checks the kernel at full width.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from matcha_tpu.parallel import fused_gossip_run as jax_fused_gossip_run
from matcha_tpu_torch.parallel import LAUNCHES, fused_gossip_plain
from matcha_tpu_torch.probes import split_probe
from matcha_tpu_torch.probes.split_probe import (
    main,
    make_inputs,
    split_gossip_plain,
    split_gossip_run,
)

D = 300  # ragged against every tile
F32_TOL = dict(rtol=1e-5, atol=1e-6)
RECORD_KEYS = {"probe", "n", "d", "steps", "block_d", "w_window",
               "device_kind", "outputs_equal", "slice_sums_equal",
               "base_steps_per_sec", "split_steps_per_sec", "ratio"}


def _inputs(n, steps, seed=0, d=D):
    """The probe's distributions from numpy, rounded to bf16 once: the
    state ``N(0, 1)``, the stack ``0.9·I + 0.01·N(0, 1)``."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    w = (0.01 * rng.normal(size=(steps, n, n))
         + 0.9 * np.eye(n)).astype(np.float32)
    return x.to(torch.bfloat16), torch.from_numpy(w).to(torch.bfloat16)


def _jax(t: torch.Tensor):
    return jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


# ------------------------------------------- the port's K4 vs the JAX K3


@pytest.mark.parametrize("n", [8, 16])
def test_one_step_matches_jax_kernel(n):
    x, stack = _inputs(n, 1, seed=n)
    port = split_gossip_run(x, stack, split=True, block_d=128, w_window=1)
    ref = jax_fused_gossip_run(_jax(x), _jax(stack), block_d=128,
                               w_window=1, interpret=True)
    assert port.dtype == torch.bfloat16 and tuple(port.shape) == (n, D)
    np.testing.assert_allclose(_np(port), _np(ref), **F32_TOL)


@pytest.mark.parametrize("steps", [8, 16])
@pytest.mark.parametrize("w_window", [1, 4, 8])
@pytest.mark.parametrize("n", [8, 16])
def test_chain_matches_jax_kernel(n, w_window, steps):
    x, stack = _inputs(n, steps, seed=100 * n + steps)
    port = split_gossip_run(x, stack, split=True, block_d=128,
                            w_window=w_window)
    ref = jax_fused_gossip_run(_jax(x), _jax(stack), block_d=128,
                               w_window=w_window, interpret=True)
    bound = 2.0 ** -8 * float(np.abs(_np(ref)).max())
    np.testing.assert_allclose(_np(port), _np(ref), rtol=0, atol=bound)


@pytest.mark.parametrize("state", [torch.bfloat16, torch.float32])
def test_split_equals_unsplit_bitwise(state):
    x, stack = _inputs(16, 16, seed=3)
    x = x.to(state)
    base = split_gossip_run(x, stack, split=False)
    split = split_gossip_run(x, stack, split=True)
    assert base.dtype == split.dtype == state
    assert torch.equal(base.view(torch.int16 if state == torch.bfloat16
                                 else torch.int32),
                       split.view(torch.int16 if state == torch.bfloat16
                                  else torch.int32))


def test_plain_version_is_the_fused_plain_version():
    # the split is a schedule, not arithmetic: one plain form for both
    assert split_gossip_plain is fused_gossip_plain
    x, stack = _inputs(8, 8, seed=4)
    assert torch.equal(split_gossip_run(x, stack, split=True),
                       fused_gossip_plain(x, stack))


def test_empty_stream_returns_the_state():
    x, _ = _inputs(8, 0)
    empty = torch.zeros((0, 8, 8), dtype=torch.bfloat16)
    assert split_gossip_run(x, empty, split=True) is x


# ------------------------------------------------------- the refusals


@pytest.mark.parametrize("steps,w_window", [(12, 8), (7, 2), (8, 0)])
def test_refuses_a_stream_not_a_multiple_of_the_window(steps, w_window):
    # the reference's grid T // w_window would drop the remainder
    x, stack = _inputs(8, steps)
    with pytest.raises(ValueError, match="multiple of w_window"):
        split_gossip_run(x, stack, split=True, w_window=w_window)


def test_refuses_a_state_that_is_not_a_matrix():
    x, stack = _inputs(8, 8)
    with pytest.raises(ValueError, match=r"\[N, D\]"):
        split_gossip_run(x[None], stack, split=False)


@pytest.mark.parametrize("shape", [(8, 8, 9), (8, 9, 9), (8, 8)])
def test_refuses_a_stack_that_does_not_match(shape):
    x, _ = _inputs(8, 8)
    with pytest.raises(ValueError, match="vs state"):
        split_gossip_run(x, torch.zeros(shape, dtype=torch.bfloat16),
                         split=False)


def test_refuses_a_float32_stack():
    x, stack = _inputs(8, 8)
    with pytest.raises(ValueError, match="bfloat16 mixing stack"):
        split_gossip_run(x, stack.float(), split=True)


def test_non_cpu_tensor_never_falls_back():
    x = torch.empty((8, D), dtype=torch.bfloat16, device="meta")
    stack = torch.empty((8, 8, 8), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        split_gossip_run(x, stack, split=True)


def test_plain_path_counts_no_launch():
    before = dict(LAUNCHES)
    x, stack = _inputs(8, 8)
    split_gossip_run(x, stack, split=True)
    split_gossip_run(x, stack, split=False)
    assert LAUNCHES == before


# ------------------------------------------------------------ the inputs


def test_make_inputs_is_deterministic_for_a_seed():
    def draw(seed):
        return make_inputs(8, 20, 4, torch.Generator().manual_seed(seed))

    (x0, w0), (x1, w1), (x2, _) = draw(5), draw(5), draw(6)
    assert torch.equal(x0, x1) and torch.equal(w0, w1)
    assert not torch.equal(x0, x2)


def test_make_inputs_shapes_and_dtypes():
    x, stack = make_inputs(16, 33, 5, torch.Generator().manual_seed(0))
    assert tuple(x.shape) == (16, 33) and x.dtype == torch.bfloat16
    assert tuple(stack.shape) == (5, 16, 16)
    assert stack.dtype == torch.bfloat16


def test_make_inputs_follows_the_reference_distributions():
    n, steps = 16, 64
    x, stack = make_inputs(n, 4096, steps, torch.Generator().manual_seed(1))
    w = stack.float()
    eye = torch.eye(n, dtype=torch.bool).expand(steps, n, n)
    diag, off = w[eye], w[~eye]
    # 1,024 diagonal draws of 0.9 + 0.01·z (bf16 steps of 2⁻⁸ near 0.9):
    # the mean's standard error is about 3.2e-4; 15,360 off-diagonal draws
    # of 0.01·z: the std's relative standard error is about 0.6 %
    assert abs(float(diag.mean()) - 0.9) < 2e-3
    assert abs(float(off.std()) - 0.01) < 5e-4
    assert abs(float(off.mean())) < 5e-4
    # the state: 65,536 draws of N(0, 1)
    assert abs(float(x.float().mean())) < 0.02
    assert abs(float(x.float().std()) - 1.0) < 0.02


# --------------------------------------------------------------- the CLI


def test_main_prints_the_reference_record(tmp_path, capsys):
    out = tmp_path / "probe.json"
    rec = main(["--device", "cpu", "--n", "16", "--d", "300", "--steps",
                "16", "--reps", "1", "--out", str(out)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    printed = json.loads(lines[0])
    assert set(printed) == RECORD_KEYS
    assert printed == rec == json.loads(out.read_text())
    assert rec["outputs_equal"] is True and rec["slice_sums_equal"] is True
    assert (rec["n"], rec["d"], rec["steps"]) == (16, 300, 16)
    assert rec["w_window"] == 8 and rec["device_kind"] == "cpu"
    assert rec["base_steps_per_sec"] > 0 and rec["split_steps_per_sec"] > 0


def test_main_defaults_are_the_reference_constants():
    assert (split_probe.N, split_probe.D, split_probe.T,
            split_probe.BLOCK_D, split_probe.W_WINDOW) == (
        256, 273258, 2000, 4096, 8)


def test_main_refuses_zero_reps():
    with pytest.raises(SystemExit) as err:
        main(["--device", "cpu", "--reps", "0"])
    assert err.value.code == 2


# ------------------------------------------------------- on the card only


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")
    return torch.device("cuda")


def _same_bits(a, b):
    as_int = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return torch.equal(a.view(as_int), b.view(as_int))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16, 100, 256])
def test_split_kernel_equals_unsplit_on_card(n):
    dev = _card()
    x, stack = make_inputs(n, 1031, 16,
                           torch.Generator(device=dev).manual_seed(n))
    before = LAUNCHES["split_gossip"]
    base = split_gossip_run(x, stack, split=False)
    for block_d in (4096, 32):
        assert _same_bits(split_gossip_run(x, stack, split=True,
                                           block_d=block_d), base)
    assert LAUNCHES["split_gossip"] == before + 3


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 100])
def test_tensor_core_mainloop_matches_plain_on_card(n):
    # N = 8 and 100 are zero-padded to 16 and 112 rows and k values.  The
    # probe's random W_t do not contract rounding differences, so a chain
    # is held to one bf16 ulp at the output's largest magnitude or twice
    # the plain version's own spread (its sums taken in another order),
    # whichever is larger, as chip_smoke.py holds it
    dev = _card()
    x, stack = make_inputs(n, 1031, 8,
                           torch.Generator(device=dev).manual_seed(n))
    for state in (x, x.float()):
        for steps in (1, 8):
            s = stack[:steps]
            ref = split_gossip_plain(state, s)
            again = split_gossip_plain(state.flip(0),
                                       s.flip(1).flip(2)).flip(0)
            out = split_gossip_run(state, s, split=False, w_window=1)
            torch.cuda.synchronize()
            spread = float((again.float() - ref.float()).abs().max())
            bound = max(2.0 ** -7 * float(ref.float().abs().max()),
                        2.0 * spread)
            assert float((out.float() - ref.float()).abs().max()) <= bound
