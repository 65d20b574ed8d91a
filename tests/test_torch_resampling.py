"""Parity of the port's systematic counts (the plain version of kernel K1)
and ancestors with the JAX package.

* From the SAME cdf the counts are exact: ``n*cdf - u`` is rounded twice
  in both (eager JAX ops, torch ops).
* From the same WEIGHTS they may differ only by one, where the two cdfs
  (the port's float64-accumulated prefix, JAX's float32 MXU-shaped prefix)
  straddle an integer of ``n*cdf - u``.  With dyadic weights both cdfs are
  exact, so even the JAX kernel (interpret mode) must match bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from composablestatespacemodels_torch.inference import resampling as trs
from composablestatespacemodels_torch.ops import _build
from composablestatespacemodels_torch.ops.scan_kernel import (
    systematic_counts_fused, systematic_counts_fused_ref)
from composablestatespacemodels_tpu.inference import resampling as jrs
from composablestatespacemodels_tpu.ops.scan_kernel import (
    prefix_sum, systematic_counts_fused as jax_counts_fused)

REGIMES = ["uniform", "mild", "heavy", "degenerate"]


def _weights(regime, n, seed):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=n)
    if regime == "uniform":
        w = np.ones(n)
    elif regime == "mild":
        w = np.exp(0.5 * z)
    elif regime == "heavy":
        w = np.exp(z) ** 4
    else:
        w = np.full(n, 1e-12)
        w[n // 3] = 1.0
    w = (w / w.sum()).astype(np.float32)
    return w, np.float32(rng.uniform())


def _jax_counts_from_cdf(cdf, u, n):
    """resampling.systematic_counts (:137-140) of the JAX package, from a
    given cdf, op by op (eager dispatch: no fused multiply-add)."""
    c = jnp.clip(jnp.ceil(n * jnp.asarray(cdf) - jnp.float32(u)), 0, n)
    c = c.astype(jnp.int32).at[-1].set(n)
    return np.asarray(jrs._monotone_counts(c))


@pytest.mark.parametrize("regime", REGIMES)
@pytest.mark.parametrize("n", [1000, 4096])
def test_counts_from_same_cdf_exact(regime, n):
    w, u = _weights(regime, n, n)
    cdf = trs._cumsum(torch.from_numpy(w) / torch.from_numpy(w).sum())
    got = trs._counts_from_cdf(cdf, torch.tensor(u), n).numpy()
    np.testing.assert_array_equal(got, _jax_counts_from_cdf(cdf.numpy(), u, n))


def test_counts_dyadic_weights_match_jax_kernel():
    """Weights with a power-of-two total: w/total and every prefix are exact
    in any order, so the JAX Pallas kernel and the port agree exactly."""
    n = 4096
    rng = np.random.default_rng(3)
    k = rng.integers(0, 8, n).astype(np.int64)
    k[-1] += 2 ** 15 - k.sum()
    w = k.astype(np.float32)
    total = np.float32(2 ** 15)
    for u in (0.0, 0.25, 0.5, 0.999):
        want = np.asarray(jax_counts_fused(jnp.asarray(w), total,
                                           jnp.float32(u), interpret=True))
        got = systematic_counts_fused_ref(torch.from_numpy(w),
                                          torch.tensor(total),
                                          torch.tensor(np.float32(u)))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("regime", REGIMES)
def test_counts_same_weights_differ_only_at_ties(regime):
    n = 4096
    w, u = _weights(regime, n, 11)
    total = np.float32(w.sum(dtype=np.float32))
    want = np.asarray(jax_counts_fused(jnp.asarray(w), total, jnp.float32(u),
                                       interpret=True)).astype(np.int64)
    tw = torch.from_numpy(w)
    got = systematic_counts_fused_ref(tw, torch.tensor(total),
                                      torch.tensor(u)).numpy().astype(np.int64)
    assert got[-1] == n and (np.diff(got) >= 0).all()
    bad = got != want
    assert np.abs(got - want).max(initial=0) <= 1
    cdf_t = trs._cumsum(tw / torch.tensor(total)).numpy().astype(np.float64)
    cdf_j = np.asarray(prefix_sum(jnp.asarray(w) / total, interpret=True),
                       np.float64)
    v = np.float32(n) * cdf_t.astype(np.float32) - u
    gap = np.abs(v - np.round(v))
    ulp = np.spacing(np.abs(v).astype(np.float32)).astype(np.float64)
    slack = n * np.abs(cdf_t - cdf_j) + 2 * ulp
    assert (gap[bad] <= slack[bad]).all(), (bad.sum(), gap[bad], slack[bad])


@pytest.mark.parametrize("regime", REGIMES)
def test_ancestors_from_counts_exact(regime):
    n = 4096
    w, u = _weights(regime, n, 5)
    counts = trs.systematic_counts(torch.from_numpy(w), torch.tensor(u))
    got = trs._ancestors_from_counts(counts, n).numpy()
    want = np.asarray(jrs._ancestors_from_counts(jnp.asarray(counts.numpy()),
                                                 n))
    np.testing.assert_array_equal(got, want)
    # the ancestor of slot j is the first i with counts[i] > j
    np.testing.assert_array_equal(
        got, np.searchsorted(counts.numpy(), np.arange(n), side="right"))


def test_monotone_guard_heavy_tails():
    n = 1 << 15
    w, u = _weights("heavy", n, 9)
    for counts in (trs.systematic_counts(torch.from_numpy(w), u),
                   systematic_counts_fused(torch.from_numpy(w),
                                           torch.tensor(w.sum()),
                                           torch.tensor(u))):
        c = counts.numpy()
        assert c.dtype == np.int32
        assert (np.diff(c) >= 0).all() and c[-1] == n


def test_wrapper_uses_plain_version_only_on_cpu():
    w, u = _weights("mild", 512, 2)
    tw = torch.from_numpy(w)
    np.testing.assert_array_equal(
        systematic_counts_fused(tw, tw.sum(), torch.tensor(u)).numpy(),
        systematic_counts_fused_ref(tw, tw.sum(), torch.tensor(u)).numpy())
    meta = tw.to("meta")
    with pytest.raises(ValueError, match="no K1 kernel"):
        systematic_counts_fused(meta, meta.sum(), torch.tensor(u))


def test_missing_nvcc_is_named(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()
