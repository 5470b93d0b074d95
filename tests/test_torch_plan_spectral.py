"""The port's consensus simulator and its predictors against the JAX
package's (``matcha_tpu/plan/spectral.py``), on the CPU.

Both sides run the same numpy operations on the same seeded inputs, so
every comparison is exact (``np.array_equal``, ``==``).  The one place
the two differ in code is the bf16 wire: the JAX package rounds through
``ml_dtypes.bfloat16`` and the port through ``torch.bfloat16``, both round
to nearest even, so the bf16 trajectories are bitwise equal too.  The
Monte-Carlo bound tests (ρ at or above the simulated rate) are those of
``tests/test_plan.py:54``, ``tests/test_overlap.py:223`` and
``tests/test_staleness.py:172`` run on the port's functions, with their
2 % headroom for the sampling noise of 4 trials × 60 steps.
"""

import itertools

import ml_dtypes
import numpy as np
import pytest

from matcha_tpu.plan import spectral as jspec
from matcha_tpu_torch import topology as tp
from matcha_tpu_torch.plan import spectral as pspec
from matcha_tpu_torch.schedule.solvers import (
    solve_activation_probabilities,
    solve_mixing_weight,
)

BUDGETS = (0.1, 0.25, 0.5, 1.0)


@pytest.fixture(scope="module")
def solved():
    """Zoo graphs 0 and 5 solved once at budget 0.5:
    ``{gid: (decomposed, size, laplacians, probs, alpha, rho)}``."""
    out = {}
    for gid in (0, 5):
        size = tp.graph_size(gid)
        dec = tp.select_graph(gid)
        Ls = tp.matching_laplacians(dec, size)
        p = solve_activation_probabilities(Ls, 0.5, iters=600)
        alpha, rho = solve_mixing_weight(Ls, p)
        out[gid] = (dec, size, Ls, p, alpha, rho)
    return out


# overlap off: staleness 1 only; the pipelined recurrence at every depth
GRID = [(ov, k, L, wire)
        for ov, k in (("off", 1), ("1step", 1), ("1step", 2), ("1step", 4))
        for L, wire in itertools.product((1, 2), ("f32", "bf16"))]


@pytest.mark.parametrize("gid", [0, 5])
@pytest.mark.parametrize("overlap,staleness,local_steps,wire", GRID)
def test_simulate_consensus_bitwise_the_jax_simulator(
        solved, gid, overlap, staleness, local_steps, wire):
    dec, size, Ls, p, alpha, _ = solved[gid]
    kw = dict(steps=40, trials=3, seed=11, overlap=overlap, wire_dtype=wire,
              staleness=staleness, local_steps=local_steps)
    got = pspec.simulate_consensus(dec, size, p, alpha, laplacians=Ls, **kw)
    want = jspec.simulate_consensus(dec, size, p, alpha, laplacians=Ls, **kw)
    assert got.log_errors.shape == (3, 41)
    assert np.array_equal(got.log_errors, want.log_errors)
    assert got.rho_bound == want.rho_bound
    assert got.alpha == want.alpha
    assert got.empirical_rate() == want.empirical_rate()
    assert np.array_equal(got.mean_decay_curve(), want.mean_decay_curve())
    assert np.array_equal(got.predicted_bound_curve(),
                          want.predicted_bound_curve())


def test_wire_quantize_is_round_to_nearest_even_like_ml_dtypes():
    """The bf16 rounding on the values where the two rules part: ties at
    both parities, the largest finite values, subnormals, inf and NaN."""
    rng = np.random.default_rng(0)
    bits = np.concatenate([
        rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32),
        np.array([0x3F808000, 0x3F818000, 0x7F7FFFFF, 0x7F7F8000,
                  0x00008000, 0x00018000, 0x80008000, 0x7F800000,
                  0xFF800000, 0x00000001], np.uint32)])
    x = bits.view(np.float32)
    x = x[~np.isnan(x)].astype(np.float64)
    got = pspec._wire_quantize(x, "bf16")
    want = x.astype(np.float32).astype(ml_dtypes.bfloat16).astype(np.float64)
    assert np.array_equal(got, want)
    assert np.isnan(pspec._wire_quantize(np.array([np.nan]), "bf16")[0])
    same = np.array([1.0, 2.5])
    assert pspec._wire_quantize(same, "f32") is same


def test_simulate_consensus_refuses_like_jax(solved):
    dec, size, Ls, p, alpha, _ = solved[5]
    for bad in (dict(overlap="2step"), dict(staleness=0),
                dict(local_steps=0), dict(staleness=2),
                dict(wire_dtype="fp8")):
        messages = []
        for fn in (pspec.simulate_consensus, jspec.simulate_consensus):
            with pytest.raises(ValueError) as err:
                fn(dec, size, p, alpha, steps=4, trials=1, **bad)
            messages.append(str(err.value))
        assert messages[0] == messages[1], bad


def test_empirical_contraction_rate_equal():
    logs = np.cumsum(-np.abs(np.random.default_rng(3).normal(size=(5, 31))),
                     axis=1)
    logs[:, 0] = 0.0
    assert pspec.empirical_contraction_rate(logs) == \
        jspec.empirical_contraction_rate(logs)
    for fn in (pspec.empirical_contraction_rate,
               jspec.empirical_contraction_rate):
        with pytest.raises(ValueError, match="at least one"):
            fn(np.zeros((2, 1)))


@pytest.mark.parametrize("rho,target", [
    (1.0, 1e-3), (1.5, 1e-3), (0.0, 1e-3), (-0.2, 1e-3), (0.5, 0.25),
    (0.93, 1e-3), (0.2, 1e-9)])
def test_steps_to_consensus_equal(rho, target):
    got = pspec.steps_to_consensus(rho, target)
    assert got == jspec.steps_to_consensus(rho, target)


def test_steps_to_consensus_edge_cases():
    """``tests/test_plan.py``'s edge cases on the port."""
    assert pspec.steps_to_consensus(1.0, 1e-3) == float("inf")
    assert pspec.steps_to_consensus(0.0, 1e-3) == 1.0
    assert pspec.steps_to_consensus(0.5, 0.25) == pytest.approx(2.0)
    for target in (1.5, 0.0):
        with pytest.raises(ValueError, match="target"):
            pspec.steps_to_consensus(0.5, target)


@pytest.mark.parametrize("args,kw", [
    ((0.5, 40), dict(target=0.25, step_time_s=1.0, gossip_time_s=1.0)),
    ((0.5, 40), dict(target=0.25)),
    ((1.0, 40), dict()),
    ((1.0, 40), dict(step_time_s=1.0, gossip_time_s=1.0)),
    ((0.9, 10), dict(target=0.5, step_time_s=1.0, gossip_time_s=0.25)),
    ((0.0, 7), dict(step_time_s=1.0, gossip_time_s=3.0)),
    ((0.5, 40), dict(step_time_s=0.0, gossip_time_s=0.0)),
])
def test_local_step_breakeven_equal(args, kw):
    assert pspec.local_step_breakeven(*args, **kw) == \
        jspec.local_step_breakeven(*args, **kw)


def test_local_step_breakeven_hand_check():
    """ρ = 0.5 and target 0.25 need 2 gossip steps, so a 40-step horizon
    takes L = 20, and with c = g the speedup there is 2 / (1 + 1/20)."""
    out = pspec.local_step_breakeven(0.5, 40, target=0.25,
                                     step_time_s=1.0, gossip_time_s=1.0)
    assert out["steps_needed"] == pytest.approx(2.0)
    assert out["max_local_every"] == pytest.approx(20.0)
    assert out["speedup_at_max"] == pytest.approx(2.0 / (1.0 + 1.0 / 20))
    for bad in (dict(t_steps=0),
                dict(t_steps=40, step_time_s=-1.0, gossip_time_s=1.0)):
        with pytest.raises(ValueError):
            pspec.local_step_breakeven(0.5, **bad)


@pytest.mark.parametrize("wire", [None, "f32", "bf16"])
def test_wire_disagreement_floor_equal(wire):
    assert pspec.wire_disagreement_floor(wire, 3.5) == \
        jspec.wire_disagreement_floor(wire, 3.5)


@pytest.mark.parametrize("gid", range(6))
def test_rho_bounds_the_simulated_rate_across_the_zoo(gid):
    """``tests/test_plan.py:54`` on the port: for every zoo graph and
    budget the simulated per-step contraction stays at or under ρ (2 %
    headroom for 4 trials × 60 steps), and a contractive schedule
    contracts."""
    size = tp.graph_size(gid)
    dec = tp.select_graph(gid)
    Ls = tp.matching_laplacians(dec, size)
    for budget in BUDGETS:
        p = solve_activation_probabilities(Ls, budget, iters=600)
        alpha, rho = solve_mixing_weight(Ls, p)
        sim = pspec.simulate_consensus(dec, size, p, alpha, steps=60,
                                       trials=4, seed=3, laplacians=Ls)
        emp = sim.empirical_rate()
        assert emp <= rho * 1.02, (gid, budget, emp, rho)
        if rho < 1.0:
            assert emp < 1.0, (gid, budget, emp, rho)


@pytest.mark.parametrize("gid", [0, 5])
def test_stale_rho_bounds_the_pipelined_simulation(solved, gid):
    """``tests/test_overlap.py:223`` on the port: the one-step pipeline's
    bound holds the simulated rate, with and without the bf16 wire."""
    dec, size, Ls, p, alpha, rho = solved[gid]
    for wire in (None, "bf16"):
        pred = pspec.stale_contraction_rho(Ls, p, alpha, overlap="1step",
                                           wire_dtype=wire)
        sim = pspec.simulate_consensus(dec, size, p, alpha, steps=60,
                                       trials=4, seed=3, laplacians=Ls,
                                       overlap="1step", wire_dtype=wire)
        assert sim.empirical_rate() <= pred * 1.02, (gid, wire)
        assert sim.rho_bound == pytest.approx(pred)
    assert pspec.stale_contraction_rho(Ls, p, alpha) == pytest.approx(rho)
    assert pspec.stale_contraction_rho(Ls, p, alpha,
                                       wire_dtype="bf16") >= rho


@pytest.mark.parametrize("gid", [0, 5])
def test_stale_rho_bounds_the_ring_simulation(solved, gid):
    """``tests/test_staleness.py:172`` on the port: the k-deep bound holds
    the ring recurrence at k = 2 and 4, with local steps and the bf16
    wire."""
    dec, size, Ls, p, alpha, _ = solved[gid]
    for k, L, wire in ((2, 1, None), (4, 1, None), (2, 2, None),
                       (2, 1, "bf16")):
        pred = pspec.stale_contraction_rho(Ls, p, alpha, overlap="1step",
                                           staleness=k, local_steps=L,
                                           wire_dtype=wire)
        assert np.isfinite(pred)
        sim = pspec.simulate_consensus(dec, size, p, alpha, steps=60,
                                       trials=4, seed=3, laplacians=Ls,
                                       overlap="1step", staleness=k,
                                       local_steps=L, wire_dtype=wire)
        assert sim.empirical_rate() <= pred * 1.02, (gid, k, L, wire)
        assert sim.rho_bound == pytest.approx(pred)
