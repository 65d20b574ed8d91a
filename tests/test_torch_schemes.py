"""The port's generic resampling schemes against the JAX package on
identical draws.

Every scheme of the port takes the JAX package's TPU branch (counts,
search-free) on every device, and each has an inner form that takes its
uniforms (and permutation), so the tests feed it the draws JAX derives from
its key.  Weights are dyadic with a power-of-two total: ``w / total`` and
every prefix are exact in float32 whatever the summation order, so no count
sits at an ulp tie and the two packages must agree exactly.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import composablestatespacemodels_torch as ct
from composablestatespacemodels_torch.inference import resampling as trs
from composablestatespacemodels_tpu.inference import resampling as jrs

from _torch_parity import both, to_torch_series

N = 4096
TOTAL = 2 ** 15
# compiled whole: JAX's eager dispatch compiles each op of the scans apart
_jax_multinomial_counts = jax.jit(jrs.multinomial_counts, static_argnums=2)
_jax_iid_draws = jax.jit(jrs._iid_draws_sorted_permuted, static_argnums=2)
_jax_multinomial_indices = jax.jit(jrs.multinomial_indices, static_argnums=2)


def _dyadic(regime, n=N, seed=0):
    """Integer weights summing to 2^15: every prefix is exact in float32."""
    rng = np.random.default_rng(seed)
    if regime == "flat":
        k = rng.integers(0, 8, n)
    elif regime == "sparse":        # nine in ten particles have no weight
        k = rng.integers(0, 64, n) * (rng.uniform(size=n) < 0.1)
    else:                           # "spike": a handful carry everything
        k = np.zeros(n, np.int64)
        k[rng.choice(n, 5, replace=False)] = 1
    k[-1] += TOTAL - k.sum()
    return k.astype(np.float32)


def _uniforms(key, n):
    """The uniforms JAX's schemes draw from ``key``."""
    return np.array(jax.random.uniform(key, (n,), jnp.float32))


@pytest.mark.parametrize("regime", ["flat", "sparse", "spike"])
@pytest.mark.parametrize("n_out", [N, 1000])
def test_multinomial_counts_match_jax(regime, n_out):
    w = _dyadic(regime, seed=n_out)
    key = jax.random.PRNGKey(n_out + len(regime))
    want = np.asarray(_jax_multinomial_counts(key, jnp.asarray(w), n_out))
    got = trs.multinomial_counts(torch.from_numpy(w),
                                 torch.from_numpy(_uniforms(key, n_out)),
                                 n_out).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and got[-1] == n_out
    # the same multiset of ancestors as JAX's per-position lookup (its
    # off-TPU multinomial_indices, from the same key), in sorted order
    anc = trs._ancestors_from_counts(torch.from_numpy(got), n_out).numpy()
    np.testing.assert_array_equal(
        anc, np.sort(np.asarray(_jax_multinomial_indices(
            key, jnp.asarray(w), n_out))))


def _residual_weights(seed=0):
    """Dyadic weights whose residuals ``n w - floor(n w)`` are 0 or 1/2 and
    sum to a power of two, so the residual fill's own cdf is exact too:
    ``k = 8 q + r`` with r in {0, 4} on exactly N/2 particles."""
    rng = np.random.default_rng(seed)
    r = np.zeros(N, np.int64)
    r[rng.choice(N, N // 2, replace=False)] = 4
    q = rng.multinomial((TOTAL - r.sum()) // 8, np.full(N, 1.0 / N))
    return (8 * q + r).astype(np.float32)


@jax.jit
def _jax_residual_tpu_branch(key, w):
    """``residual_indices`` (:250) of the JAX package down its TPU branch,
    the one the port takes on every device, from JAX's own pieces."""
    n = w.shape[0]
    wn = jrs._normalise(w)
    ki = jnp.floor(wn * n).astype(jnp.int32)
    det = jnp.repeat(jnp.arange(n), ki, total_repeat_length=n)
    residual = jnp.maximum(wn * n - ki, 0.0)
    safe = jnp.where(jnp.sum(residual) > 0, residual, jnp.ones_like(residual))
    multi = jrs._iid_draws_sorted_permuted(key, safe, n)
    return jnp.where(jnp.arange(n) < jnp.sum(ki), det, multi)


@pytest.mark.parametrize("case", ["mixed", "all_deterministic"])
def test_residual_indices_match_jax(case):
    w = (_residual_weights() if case == "mixed"
         else np.full(N, TOTAL / N, np.float32))
    key = jax.random.PRNGKey(7)
    k_mult, k_perm = jax.random.split(key)
    u = _uniforms(k_mult, N)
    perm = np.array(jax.random.permutation(k_perm, N))
    got = trs._residual_from_draws(torch.from_numpy(w), torch.from_numpy(u),
                                   torch.from_numpy(perm)).numpy()
    np.testing.assert_array_equal(got, np.asarray(_jax_residual_tpu_branch(
        key, jnp.asarray(w))))
    # every particle keeps at least its floor(n w) copies
    copies = np.bincount(got, minlength=N)
    assert (copies >= np.floor(w / TOTAL * N)).all()


def test_iid_draws_sorted_permuted_match_jax():
    w = _dyadic("sparse", seed=3)
    key = jax.random.PRNGKey(11)
    k_mult, k_perm = jax.random.split(key)
    got = trs._iid_draws_sorted_permuted(
        torch.from_numpy(w), torch.from_numpy(_uniforms(k_mult, N)),
        torch.from_numpy(np.array(jax.random.permutation(k_perm, N))))
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(_jax_iid_draws(key, jnp.asarray(w), N)))


@pytest.mark.parametrize("n_out", [None, 7, 20])
def test_identity_indices_match_jax(n_out):
    w = np.ones(12, np.float32)
    got = trs.identity_indices(torch.Generator(), torch.from_numpy(w), n_out)
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(jrs.identity_indices(jax.random.PRNGKey(0),
                                        jnp.asarray(w), n_out)))


def test_get_scheme_names_and_error_match_jax():
    assert sorted(trs._SCHEMES) == sorted(jrs._SCHEMES)
    fn = lambda generator, weights: torch.arange(weights.shape[0])  # noqa: E731
    assert trs.get_scheme(fn) is fn
    with pytest.raises(ValueError) as want:
        jrs.get_scheme("nope")
    with pytest.raises(ValueError) as got:
        trs.get_scheme("nope")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("scheme", ["systematic", "stratified",
                                    "multinomial", "residual"])
def test_indices_draw_the_weights(scheme):
    """Each scheme's ancestors from a generator: the offspring counts of
    many draws average to ``n w`` within 4 standard errors (binomial
    bound; every particle expects 10 or more offspring in all, so the
    normal bound holds), and ``resample`` gathers a tree with them."""
    rng = np.random.default_rng(5)
    w = torch.from_numpy((rng.uniform(0.1, 1.0, 50) ** 2).astype(np.float32))
    p = (w / w.sum()).double()
    g = torch.Generator().manual_seed(1)
    reps = 400
    tot = torch.zeros(50, dtype=torch.float64)
    for _ in range(reps):
        idx = trs.get_scheme(scheme)(g, w)
        assert idx.shape == (50,) and int(idx.min()) >= 0
        tot += torch.bincount(idx, minlength=50)
    se = torch.sqrt(p * (1 - p) * 50 / reps)
    assert bool(((tot / reps - 50 * p).abs() <= 4 * se + 1e-9).all())
    tree = (torch.arange(50.0), [torch.arange(50)[:, None]])
    out = trs.resample(torch.Generator().manual_seed(2), tree, w, scheme)
    assert torch.equal(out[0].long(), out[1][0][:, 0])


def test_weight_helpers_match_jax():
    rng = np.random.default_rng(9)
    logw = (rng.normal(size=300) * 20).astype(np.float32)
    np.testing.assert_allclose(
        trs.exp_normalise(torch.from_numpy(logw)).numpy(),
        np.asarray(jrs.exp_normalise(jnp.asarray(logw))), rtol=1e-6,
        atol=1e-12)
    w = np.exp(logw - logw.max())
    assert int(trs.effective_sample_size(torch.from_numpy(w))) == int(
        jrs.effective_sample_size(jnp.asarray(w)))
    stacked = (torch.arange(10.0), torch.arange(20.0).view(10, 2))
    g = torch.Generator().manual_seed(3)
    a, b = trs.sample_one(g, stacked)
    assert b.shape == (2,) and float(b[0]) == 2 * float(a)
    a, b = trs.sample_many(g, 6, stacked)
    assert len(set(a.tolist())) == 6        # without replacement
    a, b = trs.posterior_sample(g, stacked, 25)
    assert a.shape == (25,) and torch.equal(b[:, 0], 2 * a)


def test_custom_scheme_through_the_filter():
    """A callable scheme gets the filter's generator and the step's
    normalised weights, and its indices resample the cloud."""
    _, _, tm, tp = both("oracle")
    series = to_torch_series(np.arange(5.0), np.ones(5), np.ones(5, bool))
    gen = torch.Generator().manual_seed(4)
    seen = []

    def scheme(generator, weights):
        seen.append((generator is gen, tuple(weights.shape),
                     float(weights.sum())))
        return torch.argmax(weights).repeat(weights.shape[0])

    res = ct.bootstrap_filter(tm, tp, series, 256, gen, resample=scheme)
    assert len(seen) == 5
    assert all(g and shape == (256,) and math.isclose(s, 1.0, rel_tol=1e-5)
               for g, shape, s in seen)
    # every particle of the final cloud descends from one ancestor
    assert math.isfinite(float(res.ll))
    assert float(res.summary.state_lower[-1, 0]) == float(
        res.summary.state_upper[-1, 0])


def _custom_scheme(generator, weights):
    return trs.systematic_indices(generator, weights)


@pytest.mark.parametrize("store", ["ll", "summary", "path", "callable"])
@pytest.mark.parametrize("scheme", [
    "systematic", "systematic-pallas", "stratified", "stratified-pallas",
    "multinomial", "residual", "identity", "systematic-fused",
    "systematic-pallas-fused", "custom"])
def test_every_scheme_with_every_store(scheme, store):
    """Every scheme name of the JAX package and a callable, under every
    store mode, with and without an ESS trigger, on a model with a missing
    observation."""
    _, _, tm, tp = both("flagship")
    series = ct.simulate_regular(tm, tp, torch.Generator().manual_seed(1), 8,
                                 dt=1.0).to_timeseries().knock_out(3.0, 3.0)
    seen = []
    for ess_threshold in (None, 0.5):
        res = ct.bootstrap_filter(
            tm, tp, series, 128, torch.Generator().manual_seed(2),
            resample=_custom_scheme if scheme == "custom" else scheme,
            store=(lambda t, x, g: seen.append(x.shape)) if store == "callable"
            else store, ess_threshold=ess_threshold)
        assert math.isfinite(float(res.ll)) and res.ll_history.shape == (8,)
        assert res.final_particles.shape == (128, tm.dim)
        if store == "summary":
            s = res.summary
            assert bool((s.state_lower <= s.state_upper).all())
            assert bool((s.eta_lower <= s.eta_upper).all())
        if store == "path":
            assert res.sampled_path.shape == (8, tm.dim)
    assert seen == ([(128, tm.dim)] * 16 if store == "callable" else [])
