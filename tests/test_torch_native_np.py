"""The port's numpy copy of the JAX package's native graph builder
(``matcha_tpu_torch/topology/native_np.py``) against the native library's
own results.

The digests below (sha256 of the ``int32`` edge→matching array, first 16
hex digits, and the number of matchings) were recorded once from
``matcha_tpu.native``'s ``mg_edge_color`` / ``greedy_decompose`` /
``sample_flag_stream`` on the same graphs, with

    PYTHONPATH=. python -c "
    import ctypes, hashlib, numpy as np
    from matcha_tpu.native import _load, _edges_array, native_sample_flags
    from matcha_tpu_torch.topology import make_graph, hypercube_graph
    lib = _load()
    def digest(a): return hashlib.sha256(np.ascontiguousarray(
        a, np.int32).tobytes()).hexdigest()[:16]
    edges = make_graph('erdos_renyi', 70, seed=1)   # or any graph below
    arr = _edges_array([(min(u, v), max(u, v)) for u, v in edges])
    out, k = np.empty(len(arr), np.int32), ctypes.c_int32()
    lib.mg_edge_color(70, len(arr), arr, out, ctypes.byref(k))
    print(digest(out), k.value)   # greedy: lib.greedy_decompose(70,
    # len(arr), _edges_array(edges), ctypes.c_uint64(seed), out, byref(k))
    print(digest(native_sample_flags(PROBS, 301, 5)))"

This file does not import ``matcha_tpu.native``: each importer can start
another build of its shared library in its own test worker.  The graph
generators are the port's, which ``tests/test_torch_schedule.py`` holds
equal to the JAX package's.
"""

import hashlib

import numpy as np
import pytest

from matcha_tpu_torch.schedule import sample_flags
from matcha_tpu_torch.topology import (
    decompose,
    hypercube_graph,
    make_graph,
    validate_decomposition,
)
from matcha_tpu_torch.topology import native_np

GRAPHS = {
    "er70": lambda: make_graph("erdos_renyi", 70, seed=1),
    "er200": lambda: make_graph("erdos_renyi", 200, seed=2),
    "cube256": lambda: hypercube_graph(256),
    "geo100": lambda: make_graph("geometric", 100, seed=3),
}
SIZES = {"er70": 70, "er200": 200, "cube256": 256, "geo100": 100}
COLOR = {"er70": ("e1eefc02c29b9172", 22), "er200": ("53a50e7b59056c7e", 24),
         "cube256": ("620efa649bd9c834", 9), "geo100": ("77c1ca55c3c93a20", 24)}
GREEDY = {("er70", 0): ("e9a19f3c269ca146", 21),
          ("er70", 7): ("41b98cb0eca48ae1", 21),
          ("er200", 0): ("65a35e0a48a242ef", 23),
          ("er200", 7): ("9659726552dec2e9", 23),
          ("cube256", 0): ("1a4bd3c145010b90", 10),
          ("cube256", 7): ("4f358b022ed9d271", 10),
          ("geo100", 0): ("e932a6c0ed400f06", 23),
          ("geo100", 7): ("78586fa35965ddc0", 23)}
# splitmix64(x) of the C++ function
SPLITMIX = {0: 0xE220A8397B1DCDAF, 1: 0x910A2DEC89025CC1,
            2 ** 63: 0x481EC0A212A9F3DB,
            12345678901234567890: 0xF959D46356AFD6E8}
PROBS = np.array([0.1, 0.5, np.nan, -0.2, 1.0, 0.73, np.inf, 2.0])
FLAGS_DIGEST = "97b1273a4fb31af9"  # sample_flag_stream(PROBS, 301, seed 5)


def _digest(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a, np.int32).tobytes()
                          ).hexdigest()[:16]


def _ids(decomposed, edges) -> np.ndarray:
    """The edge→matching array of a decomposition, in ``edges``' order."""
    where = {e: j for j, match in enumerate(decomposed) for e in match}
    return np.array([where[(min(u, v), max(u, v))] for u, v in edges])


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_edge_color_matches_native(name):
    edges = [(min(u, v), max(u, v)) for u, v in GRAPHS[name]()]
    colors, used = native_np.mg_edge_color(SIZES[name], edges)
    assert (_digest(colors), used) == COLOR[name]


@pytest.mark.parametrize("name,seed", sorted(GREEDY))
def test_greedy_matches_native(name, seed):
    ids, passes = native_np.greedy_decompose(SIZES[name], GRAPHS[name](),
                                             seed)
    assert (_digest(ids), passes) == GREEDY[(name, seed)]


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("method", ["color", "auto", "greedy"])
def test_decompose_entry_point_matches_native(name, method):
    # above 64 nodes "auto" is "color", as in the JAX package
    edges = GRAPHS[name]()
    n = SIZES[name]
    dec = decompose(edges, n, method=method, seed=7)
    validate_decomposition(dec, n, base_edges=[(min(u, v), max(u, v))
                                               for u, v in edges])
    want = GREEDY[(name, 7)] if method == "greedy" else COLOR[name]
    assert (_digest(_ids(dec, edges)), len(dec)) == want


def test_edge_color_stays_within_delta_plus_one_at_4096_workers():
    edges = hypercube_graph(4096)
    colors, used = native_np.mg_edge_color(4096, edges)
    assert used <= 13 and colors.min() == 0
    validate_decomposition(decompose(edges, 4096), 4096, base_edges=edges)


@pytest.mark.parametrize("x", sorted(SPLITMIX))
def test_splitmix64_matches_native(x):
    assert native_np.splitmix64(x) == SPLITMIX[x]
    assert int(native_np.splitmix64_array(np.array([x], np.uint64))[0]) \
        == SPLITMIX[x]


def test_native_sampler_matches_native_stream():
    flags = sample_flags(PROBS, 301, seed=5, sampler="native")
    assert flags.dtype == np.uint8 and flags.shape == (301, 8)
    assert _digest(flags) == FLAGS_DIGEST
    # a seed past 2^63 wraps as the library's uint64 does
    big = sample_flags(PROBS, 4, seed=2 ** 64 + 5, sampler="native")
    np.testing.assert_array_equal(big, flags[:4])


def test_native_sampler_frequencies_match_probs():
    probs = np.array([0.0, 0.05, 0.3, 0.5, 0.9, 1.0])
    flags = sample_flags(probs, 20000, seed=11, sampler="native")
    freq = flags.mean(axis=0)
    # four standard deviations of a Bernoulli mean over 20,000 draws
    tol = 4 * np.sqrt(probs * (1 - probs) / 20000)
    assert np.all(np.abs(freq - probs) <= tol)
    assert freq[0] == 0.0 and freq[-1] == 1.0


def test_native_sampler_refuses_what_the_library_refuses():
    with pytest.raises(RuntimeError, match="code -1"):
        sample_flags(np.zeros(0), 3, seed=0, sampler="native")
