"""The port's bisection selection (``ops/selection.py``) against the JAX
package's on identical rows: the order statistics are values of the row,
found by the same 32 rounds over the same integer order, so they agree bit
for bit -- negative values, signed zeros, infinities, ties and the edge
indices included.  The weighted quantiles sum float32 masses in each
package's own order; with the weights used here no mass lands within
rounding of a target level, so they agree bit for bit too."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from composablestatespacemodels_torch.ops.selection import (
    kth_smallest_bits, weighted_quantile_bits)
from composablestatespacemodels_tpu.ops import selection as jsel


def _rows(seed, n=1000):
    rng = np.random.default_rng(seed)
    scales = np.array([[1e-3], [1.0], [1e4], [1e-30], [1e30], [1.0]])
    v = (rng.normal(size=(6, n)) * scales).astype(np.float32)
    v[0, :100] = 0.0
    v[1, :50] = -0.0
    v[2, :10], v[2, 10:20] = np.inf, -np.inf
    v[5] = np.round(v[5])                    # many ties
    return v


def _bits(a):
    return np.asarray(a).view(np.int32)


@pytest.mark.parametrize("ks", [[0, 10, 500, 999], [999, 0, 1, 998]])
def test_kth_smallest_matches_jax_and_sort(ks):
    v = _rows(0)
    k = np.array([ks] * v.shape[0], np.int32)
    got = kth_smallest_bits(torch.from_numpy(v), torch.from_numpy(k))
    want = jsel.kth_smallest_bits(jnp.asarray(v), jnp.asarray(k))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    np.testing.assert_array_equal(
        got.numpy(), np.take_along_axis(np.sort(v, axis=1), k, axis=1))


def test_kth_smallest_all_negative_and_per_row_ks():
    v = -np.abs(_rows(1, 257))
    k = np.random.default_rng(1).integers(0, 257, (6, 3)).astype(np.int32)
    got = kth_smallest_bits(torch.from_numpy(v), torch.from_numpy(k)).numpy()
    want = jsel.kth_smallest_bits(jnp.asarray(v), jnp.asarray(k))
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("ps", [[0.025, 0.975], [1e-4, 1.0], [0.5, 0.999]])
def test_weighted_quantile_matches_jax(ps):
    v = _rows(2)
    w = np.random.default_rng(2).uniform(size=v.shape[1]).astype(np.float32)
    p = np.array([ps] * v.shape[0], np.float32)
    got = weighted_quantile_bits(torch.from_numpy(v), torch.from_numpy(w),
                                 torch.from_numpy(p)).numpy()
    want = jsel.weighted_quantile_bits(jnp.asarray(v), jnp.asarray(w),
                                       jnp.asarray(p))
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_weighted_quantile_zero_weight_top():
    """p = 1 lands on the largest value that carries weight."""
    v = np.arange(8, dtype=np.float32)[None] - 3.0
    w = np.array([1, 1, 1, 1, 1, 1, 0, 0], np.float32)
    got = weighted_quantile_bits(torch.from_numpy(v), torch.from_numpy(w),
                                 torch.tensor([[1.0]]))
    assert float(got) == 2.0


def test_rejects_non_float32():
    with pytest.raises(TypeError, match="float32"):
        kth_smallest_bits(torch.zeros(1, 4, dtype=torch.float64),
                          torch.zeros(1, 1, dtype=torch.int32))
    with pytest.raises(TypeError, match="float32"):
        weighted_quantile_bits(torch.zeros(1, 4, dtype=torch.bfloat16),
                               torch.ones(4), torch.ones(1, 1))
