"""The port's gossip-message compressors (``matcha_tpu_torch/ops/compress.py``)
against the JAX package's, and against ``tests/test_ops.py``'s laws.

The deterministic compressors are compared with the JAX ones on the same
inputs: the same selected set per row (``lax.top_k`` and ``torch.topk``
may order it differently, which no consumer sees), the same signed values,
bitwise.  The random paths draw from a ``torch.Generator`` where the JAX
package draws from a PRNG key, so they are held to their properties, not
to the JAX values: k distinct indices a row, an unbiased quantizer within
one level of its input, and a stream fixed by the seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matcha_tpu import ops as jops
from matcha_tpu_torch.ops import (
    COMPRESSOR_NAMES,
    DETERMINISTIC_COMPRESSORS,
    batched_random_k,
    batched_top_k,
    batched_top_k_approx,
    batched_top_k_q8,
    dense_from_sparse,
    quantize_stochastic,
    scatter_rows,
    select_compressor,
    top_k_ratio_size,
)


def _x(n, d, seed):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_registry_matches_the_jax_package():
    assert COMPRESSOR_NAMES == jops.COMPRESSOR_NAMES
    assert DETERMINISTIC_COMPRESSORS == jops.DETERMINISTIC_COMPRESSORS
    assert select_compressor("top_k") is batched_top_k
    assert select_compressor("top_k_q8") is batched_top_k_q8
    with pytest.raises(KeyError):
        select_compressor("zip")


@pytest.mark.parametrize("dim,ratio", [(100, 0.9), (100, 0.5), (10, 0.99),
                                       (273258, 0.9), (21, 0.0), (7, -0.5)])
def test_top_k_ratio_size_is_the_reference_quirk(dim, ratio):
    # int(n·(1−ratio)), at least 1: 9 (not 10) for n = 100 at 0.9
    assert top_k_ratio_size(dim, ratio) == jops.top_k_ratio_size(dim, ratio)
    assert top_k_ratio_size(100, 0.9) == 9


def test_top_k_picks_the_largest_magnitudes():
    x = torch.tensor([[1.0, -5.0, 0.1, 3.0], [0.0, 0.2, -0.1, 0.05]])
    vals, idx = batched_top_k(x, ratio=0.5)
    assert vals.shape == (2, 2) and idx.dtype == torch.int32
    assert set(idx[0].tolist()) == {1, 3}
    np.testing.assert_array_equal(dense_from_sparse(idx, vals, 4)[0].numpy(),
                                  [0, -5.0, 0, 3.0])


def test_top_k_keep_all_is_identity_with_arange():
    x = torch.from_numpy(_x(3, 11, 0))
    vals, idx = batched_top_k(x, ratio=0.0)
    assert vals is x
    np.testing.assert_array_equal(idx.numpy(), np.tile(np.arange(11), (3, 1)))


@pytest.mark.parametrize("name", ["top_k", "top_k_approx"])
@pytest.mark.parametrize("ratio", [0.0, 0.5, 0.9, 0.99])
def test_deterministic_compressors_match_jax(name, ratio):
    x = _x(6, 257, seed=int(ratio * 100))
    jv, ji = jops.select_compressor(name)(jnp.asarray(x), ratio,
                                          jax.random.PRNGKey(0))
    pv, pi = select_compressor(name)(torch.from_numpy(x), ratio, None)
    assert pv.shape == jv.shape and pi.dtype == torch.int32
    for row in range(6):
        assert set(pi[row].tolist()) == set(np.asarray(ji)[row].tolist())
    # the same selection gives the same signed values, bitwise
    np.testing.assert_array_equal(
        dense_from_sparse(pi, pv, 257).numpy(),
        np.asarray(jops.dense_from_sparse(ji, jv, 257)))


def test_random_k_draws_k_distinct_indices_from_its_generator():
    x = torch.ones(4, 50)
    k = top_k_ratio_size(50, 0.8)
    vals, idx = batched_random_k(x, ratio=0.8, gen=_gen(0))
    assert vals.shape == (4, k) and idx.dtype == torch.int32
    for row in idx.tolist():
        assert len(set(row)) == k and all(0 <= i < 50 for i in row)
    again = batched_random_k(x, 0.8, _gen(0))[1]
    other = batched_random_k(x, 0.8, _gen(1))[1]
    assert torch.equal(idx, again) and not torch.equal(idx, other)
    # one generator advances: two draws in a row differ
    g = _gen(0)
    assert not torch.equal(batched_random_k(x, 0.8, g)[1],
                           batched_random_k(x, 0.8, g)[1])


def test_random_k_is_uniform():
    # every coordinate is picked with probability k/D: 4000 rows of D = 20,
    # k = 5, each coordinate's count within 5 standard deviations of 1000
    _, idx = batched_random_k(torch.zeros(4000, 20), 0.75, _gen(3))
    counts = np.bincount(idx.numpy().ravel(), minlength=20)
    assert np.abs(counts - 1000).max() < 5 * np.sqrt(4000 * 0.25 * 0.75)


def test_scatter_rows_per_worker_scale_and_repeats():
    base = torch.zeros(2, 5)
    idx = torch.tensor([[0, 2], [1, 1]], dtype=torch.int32)
    vals = torch.tensor([[1.0, 2.0], [3.0, 4.0]])
    out = scatter_rows(base, idx, vals, torch.tensor([2.0, 0.5])).numpy()
    np.testing.assert_allclose(out[0], [2.0, 0, 4.0, 0, 0])
    np.testing.assert_allclose(out[1], [0, 3.5, 0, 0, 0])  # accumulates
    assert torch.equal(base, torch.zeros(2, 5))  # out of place


@pytest.mark.parametrize("scale", ["scalar", "per_row"])
def test_scatter_rows_matches_jax_bitwise(scale):
    rng = np.random.default_rng(7)
    base = _x(5, 64, 1)
    vals = _x(5, 9, 2)
    idx = np.stack([rng.choice(64, 9, replace=False)
                    for _ in range(5)]).astype(np.int32)
    w = 0.3 if scale == "scalar" else rng.normal(size=5).astype(np.float32)
    want = jops.scatter_rows(jnp.asarray(base), jnp.asarray(idx),
                             jnp.asarray(vals), jnp.asarray(w))
    got = scatter_rows(torch.from_numpy(base), torch.from_numpy(idx),
                       torch.from_numpy(vals), torch.as_tensor(w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_quantize_stochastic_unbiased_and_bounded():
    x = torch.from_numpy(_x(4, 257, 3))
    g = _gen(0)
    qs = torch.stack([quantize_stochastic(x, 4, g) for _ in range(400)])
    # unbiased: the mean of 400 draws recovers x (the bar is
    # tests/test_ops.py's: 3e-2 absolute on unit normals)
    np.testing.assert_allclose(qs.mean(0).numpy(), x.numpy(), atol=3e-2,
                               rtol=0)
    # each draw within one of the 15 levels of x
    scale = x.abs().amax(dim=-1, keepdim=True)
    assert float((qs - x).abs().max()) <= float((scale / 15).max()) + 1e-6
    # zero rows stay exactly zero
    assert torch.equal(quantize_stochastic(torch.zeros(2, 8), 8, _gen(1)),
                       torch.zeros(2, 8))
    # the stream is fixed by the seed
    assert torch.equal(quantize_stochastic(x, 4, _gen(5)),
                       quantize_stochastic(x, 4, _gen(5)))


def test_top_k_q8_keeps_top_k_indices_within_one_level():
    x = torch.from_numpy(_x(3, 40, 4))
    vals, idx = batched_top_k_q8(x, ratio=0.8, gen=_gen(2))
    ref_vals, ref_idx = batched_top_k(x, ratio=0.8)
    assert torch.equal(idx, ref_idx)
    scale = ref_vals.abs().amax(dim=-1, keepdim=True)
    assert float((vals - ref_vals).abs().max()) <= float(
        (scale / 255).max()) + 1e-6


def test_top_k_approx_has_no_keep_all_branch():
    # at k = D the JAX approx_max_k (exact on the CPU) returns a
    # permutation; so does the port
    x = torch.from_numpy(_x(2, 9, 5))
    vals, idx = batched_top_k_approx(x, 0.0)
    assert vals is not x
    for row in idx.tolist():
        assert sorted(row) == list(range(9))
    assert torch.equal(dense_from_sparse(idx, vals, 9), x)
