"""The plain versions of kernels K7a (prefix sum) and K7b (int32 running
max), and the stratified counts built from them, against the JAX package;
and K1's plain version where its one-launch scan carries the running max
across tiles.

* K7a's plain version accumulates in float64 (in the CUDA kernel's order)
  and rounds each entry once; the JAX kernel sums float32 blocks on the
  MXU.  They agree within rtol 1e-6 (a few float32 ulps of a prefix).
* K7b is an exact integer running max: equal.
* Stratified counts from the same ``[n]`` uniforms agree except by one at
  entries where ``n*cdf`` (or ``n*cdf - k`` against ``u[k]``) sits within
  the two cdfs' difference (plus 2 ulp: jit may fuse ``n*cdf - k``) of a
  tie, as the systematic counts do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from composablestatespacemodels_torch.inference import resampling as trs
from composablestatespacemodels_torch.ops.scan_kernel import (
    cummax_int32, cummax_int32_ref, prefix_sum, prefix_sum_ref,
    systematic_counts_fused_ref)
from composablestatespacemodels_tpu.inference import resampling as jrs
from composablestatespacemodels_tpu.ops import scan_kernel as jsk

REGIMES = ["uniform", "mild", "heavy", "degenerate"]

# jitted once: eager associative_scan compiles every op of its recursion
_jax_stratified = jax.jit(jrs.stratified_counts)
_jax_cdf = jax.jit(lambda w: jrs._cumsum(w / jnp.sum(w)))


def _weights(regime, n, seed):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=n)
    w = {"uniform": np.ones(n), "mild": np.exp(0.5 * z),
         "heavy": np.exp(z) ** 4}.get(regime)
    if w is None:
        w = np.full(n, 1e-12)
        w[n // 3] = 1.0
    return (w / w.sum()).astype(np.float32)


@pytest.mark.parametrize("regime", REGIMES)
@pytest.mark.parametrize("n", [1000, 8192])
def test_prefix_sum_matches_jax_kernel(regime, n):
    w = _weights(regime, n, n)
    got = prefix_sum_ref(torch.from_numpy(w)).numpy()
    want = np.asarray(jsk.prefix_sum(jnp.asarray(w), interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    # one rounding of the float64 prefix: within half an ulp of it
    exact = np.cumsum(w.astype(np.float64))
    assert (np.abs(got - exact) <= np.spacing(got) / 2 + 1e-300).all()


def test_prefix_sum_signed_values_and_tiles():
    """Negative entries and several 4096-element tiles."""
    x = np.random.default_rng(1).normal(size=3 * 4096 + 5).astype(np.float32)
    got = prefix_sum(torch.from_numpy(x)).numpy()
    want = np.asarray(jsk.prefix_sum(jnp.asarray(x), interpret=True))
    exact = np.cumsum(x.astype(np.float64))
    # the JAX float32 blocks drift by ulps of the largest partial sum
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=4 * np.spacing(np.abs(got).max()))
    assert (np.abs(got - exact) <= np.spacing(np.abs(got)) / 2).all()


def test_prefix_sum_beyond_1024_tiles():
    """More than 1024 tiles: each thread of the tile offsets then adds two
    tile sums (``rounds == 2`` in ``_cumsum_ref``), as K7a's one-launch
    scan does at N = 2^22 + 3.  Within rtol 1e-6 of a float64
    ``np.cumsum`` and within one float32 ulp of it (the two float64 sums
    differ in order)."""
    n = 1025 * 4096 + 3
    x = np.random.default_rng(6).uniform(size=n).astype(np.float32)
    got = prefix_sum_ref(torch.from_numpy(x)).numpy()
    exact = np.cumsum(x.astype(np.float64))
    np.testing.assert_allclose(got, exact, rtol=1e-6)
    assert (np.abs(got - exact) <= np.spacing(got)).all()


@pytest.mark.parametrize("n", [5, 4096, 9000])
def test_cummax_matches_jax_kernel(n):
    rng = np.random.default_rng(n)
    c = np.sort(rng.integers(0, n, n)).astype(np.int32)
    c[rng.integers(0, n, n // 10 + 1)] -= 3       # ulp-style dips
    c = np.maximum(c, 0)
    got = cummax_int32_ref(torch.from_numpy(c)).numpy()
    want = np.asarray(jsk.cummax_int32(jnp.asarray(c), interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(cummax_int32(torch.from_numpy(c)).numpy(),
                                  np.maximum.accumulate(c))


@pytest.mark.parametrize("regime", REGIMES)
def test_stratified_counts_match_jax(regime):
    n = 4096
    w = _weights(regime, n, 3)
    u_key = jax.random.fold_in(jax.random.PRNGKey(0), REGIMES.index(regime))
    want = np.asarray(_jax_stratified(u_key, jnp.asarray(w)))
    u = np.array(jax.random.uniform(u_key, (n,), jnp.float32))
    tw = torch.from_numpy(w)
    got = trs.stratified_counts(tw, torch.from_numpy(u)).numpy()
    assert got[-1] == n and (np.diff(got) >= 0).all()
    diff = got.astype(np.int64) - want
    assert np.abs(diff).max(initial=0) <= 1
    bad = diff != 0
    # every mismatch sits at a tie the two cdfs straddle
    cdf_t = trs._cumsum(tw / tw.sum()).numpy().astype(np.float64)
    cdf_j = np.asarray(_jax_cdf(jnp.asarray(w)), np.float64)
    v = np.float32(n) * cdf_t.astype(np.float32)
    k = np.floor(v).astype(np.int64)
    slack = n * np.abs(cdf_t - cdf_j) + 2 * np.spacing(np.abs(v))
    frac_gap = np.abs((v - k) - u[np.clip(k, 0, n - 1)])
    tie = (np.abs(v - np.round(v)) <= slack) | (frac_gap <= slack)
    assert tie[bad].all(), (bad.sum(), v[bad])


def test_stratified_counts_dyadic_weights_exact():
    """A power-of-two total makes every prefix exact in either package, so
    the counts agree bit for bit."""
    n = 4096
    rng = np.random.default_rng(4)
    k = rng.integers(0, 8, n)
    k[-1] += 2 ** 15 - k.sum()
    w = k.astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = np.asarray(_jax_stratified(key, jnp.asarray(w)))
    u = np.array(jax.random.uniform(key, (n,), jnp.float32))
    got = trs.stratified_counts(torch.from_numpy(w), torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrappers_use_plain_versions_only_on_cpu():
    x = torch.rand(700, generator=torch.Generator().manual_seed(0))
    c = torch.randint(0, 50, (700,), dtype=torch.int32)
    np.testing.assert_array_equal(prefix_sum(x).numpy(),
                                  prefix_sum_ref(x).numpy())
    np.testing.assert_array_equal(cummax_int32(c).numpy(),
                                  cummax_int32_ref(c).numpy())
    with pytest.raises(ValueError, match="no K7a kernel"):
        prefix_sum(x.to("meta"))
    with pytest.raises(ValueError, match="no K7b kernel"):
        cummax_int32(c.to("meta"))
    with pytest.raises(ValueError, match="no resampling path"):
        trs._cumsum(x.to("meta"))
    with pytest.raises(ValueError, match="no resampling path"):
        trs._monotone_counts(c.to("meta"))


@pytest.mark.parametrize("u", [0.0, 0.37, 0.999])
def test_counts_carry_across_tiles_matches_jax_kernel(u):
    """K1's plain version against the JAX K1 (interpret mode) at N = 9000,
    three of the CUDA kernel's 4096-element tiles, on weights whose
    negative runs cross both tile boundaries: the counts fall from one tile
    into the next, so the running-max carry across tiles changes values.
    The weights are multiples of 2^-12 with a power-of-two total, so every
    prefix is exact in both packages and the counts agree bit for bit."""
    n = 9000
    rng = np.random.default_rng(8)
    k = rng.integers(0, 2, n)
    for edge in (4096, 8192):
        k[edge - 150:edge + 150] = -2
    k[-1] += 2 ** 12 - k.sum()
    w = (8 * k).astype(np.float32)
    total = np.float32(2 ** 15)
    got = systematic_counts_fused_ref(torch.from_numpy(w),
                                      torch.tensor(total),
                                      torch.tensor(np.float32(u))).numpy()
    want = np.asarray(jsk.systematic_counts_fused(
        jnp.asarray(w), total, jnp.float32(u), interpret=True))
    np.testing.assert_array_equal(got, want)
    # before the running max, counts in tiles 1 and 2 lie below the
    # maximum of the tiles before them
    cdf = np.cumsum(w.astype(np.float64)) / float(total)
    c0 = np.clip(np.ceil(n * cdf - u), 0, n)
    for edge in (4096, 8192):
        assert c0[edge:edge + 100].max() < c0[:edge].max()
        assert (got[edge:edge + 100] == c0[:edge].max()).all()
