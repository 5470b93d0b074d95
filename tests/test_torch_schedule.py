"""The port's topology and schedule layers against the JAX package.

Both are host numpy, and the port's are copies, so the schedule a training
run consumes must be the same object on both sides: matchings, ``perms``
and ``flags`` exactly equal, ``probs`` and ``alpha`` to 1e-12 (the
solvers are the same code; the bound only allows for a library that
reorders a float64 sum).  Every zoo graph (ids 0-5) and two generator
topologies, under MATCHA and under every D-PSGD flag mode.
"""

import functools

import numpy as np
import pytest

from matcha_tpu import schedule as jsch
from matcha_tpu import topology as jtp
from matcha_tpu.train import TrainConfig as JaxTrainConfig
from matcha_tpu.train.loop import build_schedule as jax_build_schedule
from matcha_tpu_torch import schedule as psch
from matcha_tpu_torch import topology as ptp
from matcha_tpu_torch.train import TrainConfig
from matcha_tpu_torch.train import build_schedule

GRAPHS = [("zoo", g) for g in range(6)] + [("ring", 12), ("torus", 16)]
KINDS = ["matcha", "all", "bernoulli", "alternating"]
ITERATIONS = 97
SEED = 9001


def _decomposed(pkg, kind, arg):
    if kind == "zoo":
        return pkg.select_graph(arg), pkg.graph_size(arg)
    edges = pkg.make_graph(kind, arg, seed=SEED)
    return pkg.decompose(edges, arg, seed=SEED), arg


@functools.lru_cache(maxsize=None)
def _schedule(tp, sch, graph, kind):
    dec, size = _decomposed(tp, *graph)
    if kind == "matcha":
        return sch.matcha_schedule(dec, size, ITERATIONS, budget=0.5,
                                   seed=SEED)
    return sch.fixed_schedule(dec, size, ITERATIONS, budget=0.5, mode=kind,
                              seed=SEED)


def _assert_same(port, ref):
    assert port.decomposed == ref.decomposed
    np.testing.assert_array_equal(port.perms, ref.perms)
    assert port.perms.dtype == ref.perms.dtype
    np.testing.assert_array_equal(port.flags, ref.flags)
    assert port.flags.dtype == ref.flags.dtype
    np.testing.assert_allclose(port.probs, ref.probs, rtol=0, atol=1e-12)
    assert abs(float(port.alpha) - float(ref.alpha)) <= 1e-12
    np.testing.assert_allclose(port.laplacians(), ref.laplacians(), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("graph", GRAPHS, ids=lambda g: f"{g[0]}{g[1]}")
def test_schedule_matches_jax(graph, kind):
    try:
        ref = _schedule(jtp, jsch, graph, kind)
    except ValueError as err:
        # "alternating" needs exactly two matchings: the same refusal
        with pytest.raises(ValueError) as port_err:
            _schedule(ptp, psch, graph, kind)
        assert str(port_err.value) == str(err)
        return
    _assert_same(_schedule(ptp, psch, graph, kind), ref)


@pytest.mark.parametrize("graphid", [0, None])
@pytest.mark.parametrize("matcha", [True, False])
def test_build_schedule_matches_jax(graphid, matcha):
    n = 8 if graphid is None else jtp.graph_size(graphid)
    kw = dict(num_workers=n, graphid=graphid, topology="ring", matcha=matcha,
              budget=0.5, seed=SEED)
    _assert_same(build_schedule(TrainConfig(**kw), 41),
                 jax_build_schedule(JaxTrainConfig(**kw), 41))


def test_slice_schedule_alpha_and_activity():
    # the training slice: graph 4 (16 workers, 8 matchings), budget 0.5
    sched = _schedule(ptp, psch, ("zoo", 4), "matcha")
    assert sched.num_workers == 16 and sched.num_matchings == 8
    assert abs(float(sched.alpha) - 0.2833) < 1e-3
    assert 3.0 < float(sched.flags.sum(axis=1).mean()) < 5.0


def test_greedy_decomposition_matches_jax_python_path():
    # above 64 nodes ``decompose`` colors natively in the JAX package; the
    # port runs the greedy pass, which is the JAX package's Python greedy
    edges = jtp.hypercube_graph(128)
    assert ptp.decompose_greedy(edges, 128, seed=3) == \
        jtp.decompose_greedy(edges, 128, seed=3)
    dec = ptp.decompose(edges, 128, seed=3)
    ptp.validate_decomposition(dec, 128, base_edges=edges)


@pytest.mark.parametrize("n", [8, 16, 64])
def test_generators_and_spectra_match_jax(n):
    for kind in jtp.available_topologies():
        assert ptp.make_graph(kind, n, seed=SEED) == \
            jtp.make_graph(kind, n, seed=SEED)
    dec = jtp.decompose(jtp.ring_graph(n), n, seed=SEED)
    lap = ptp.base_laplacian(dec, n)
    np.testing.assert_array_equal(lap, jtp.base_laplacian(dec, n))
    assert ptp.algebraic_connectivity(lap) == pytest.approx(
        jtp.algebraic_connectivity(lap), rel=1e-12)


def test_sample_flags_matches_jax():
    probs = np.array([0.1, 0.5, np.nan, -0.2, 1.0, 0.73])
    np.testing.assert_array_equal(psch.sample_flags(probs, 301, seed=5),
                                  jsch.sample_flags(probs, 301, seed=5))
    with pytest.raises(KeyError):
        psch.sample_flags(probs, 3, seed=0, sampler="native")
