"""The filtering-with-summaries path as a whole: ``bootstrap_filter(...,
store="summary" | "path" | callable)`` under ``"systematic-pallas"``,
``"stratified-pallas"`` and ``"systematic-pallas-fused"`` on the CPU (the
kernels' plain versions) against the JAX package and the Kalman oracle.

* The per-step summary of one identical cloud is deterministic: its order
  statistics are values of the cloud, found by the same bisection, so they
  agree bit for bit; means within rtol 1e-6 (float32 sums in each
  package's order).
* Whole filters draw different random streams in the two packages, so
  log-likelihoods and ESS agree statistically: means within 4 joint
  standard errors, the JAX filter run as its own tests run it (the Pallas
  kernels in interpret mode).
"""

import functools
import math
import statistics

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import composablestatespacemodels_torch as ct
import composablestatespacemodels_tpu as cj
from composablestatespacemodels_torch.inference.filter import (
    _make_save_fn_t)
from composablestatespacemodels_tpu.inference import filter as jfilter

from _torch_parity import both, to_torch_series

N, T = 1024, 30
RUNS_TORCH, RUNS_JAX = 16, 6
SCHEMES = ["systematic-pallas", "stratified-pallas", "systematic-pallas-fused"]


def _mean_se(values):
    return statistics.fmean(values), statistics.stdev(values) / math.sqrt(
        len(values))


def _bits(a):
    return np.asarray(a).view(np.int32)


@functools.lru_cache(maxsize=None)
def _case(name):
    """JAX data and the JAX filter's lls (``systematic-pallas``, interpret
    mode) for model ``name``, computed once per module."""
    jm, jp, tm, tp = both(name)
    dt = 1.0 if name == "flagship" else 0.1
    data = cj.simulate_regular(jm, jp, jax.random.PRNGKey(0), T,
                               dt=dt).to_timeseries()
    with pltpu.force_tpu_interpret_mode():
        lls = [float(cj.bootstrap_filter(
            jm, jp, data, N, jax.random.PRNGKey(10 + r),
            resample="systematic-pallas", store="ll").ll)
            for r in range(RUNS_JAX)]
    return tm, tp, to_torch_series(data.ts, data.ys, data.mask), lls


def _cloud(d, n, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(d, n)) * 0.5 + 0.1).astype(np.float32)
    x[:, :3] = -0.0                         # signed zeros and ties
    wn = rng.uniform(size=n).astype(np.float32)
    return x, wn / wn.sum()


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name,interval", [
    ("oracle", 0.975), ("oracle", 1.0), ("oracle", 1e-4),
    ("flagship", 0.975), ("flagship", 0.9)])
def test_summary_save_matches_jax(name, interval, weighted):
    """One step's summary of one cloud; the edge intervals (1.0, and one
    below 1/n) exercise the index wrap mod n (filter.py:322-331)."""
    jm, _, tm, _ = both(name)
    n = 4096
    x, wn = _cloud(tm.dim, n, 3)
    if not weighted:
        wn = np.full(n, 1.0 / n, np.float32)
    t = 5.0
    want = jfilter._make_save_fn_t(jm, "summary", interval, weighted)(
        jnp.float32(t), jnp.asarray(x), jnp.asarray(wn),
        jax.random.PRNGKey(0))
    save = _make_save_fn_t(tm, "summary", interval, weighted,
                           torch.Generator(), 1, n)
    got = save(0, torch.tensor(t), tm.design_vector(torch.tensor(t)),
               torch.from_numpy(x), torch.from_numpy(wn))
    eta_mean, e_lo, e_hi, mean, s_lo, s_hi = (g.numpy() for g in got)
    np.testing.assert_array_equal(_bits(s_lo), _bits(want[4]))
    np.testing.assert_array_equal(_bits(s_hi), _bits(want[5]))
    np.testing.assert_allclose(mean, want[3], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(eta_mean, want[0], rtol=1e-6)
    if name == "oracle":
        # gamma = 1 * x: the eta row is the cloud itself, bit for bit
        np.testing.assert_array_equal(_bits(e_lo), _bits(want[1]))
        np.testing.assert_array_equal(_bits(e_hi), _bits(want[2]))
    else:
        # exp(F(t) . x) is summed in each package's order: ulps apart
        np.testing.assert_allclose(e_lo, want[1], rtol=1e-6)
        np.testing.assert_allclose(e_hi, want[2], rtol=1e-6)
    if not weighted:
        s = np.sort(x, axis=1)
        k = math.floor(n * interval)
        np.testing.assert_array_equal(s_lo, s[:, (n - k - 1) % n])
        np.testing.assert_array_equal(s_hi, s[:, (k - 1) % n])


@pytest.mark.parametrize("scheme", ["systematic-pallas", "stratified-pallas"])
@pytest.mark.parametrize("name", ["flagship", "oracle"])
def test_ll_matches_jax(name, scheme):
    tm, tp, series, j_lls = _case(name)
    t_mean, t_se = _mean_se([float(ct.bootstrap_filter(
        tm, tp, series, N, torch.Generator().manual_seed(100 + r),
        resample=scheme, store="ll").ll) for r in range(RUNS_TORCH)])
    j_mean, j_se = _mean_se(j_lls)
    assert abs(t_mean - j_mean) <= 4 * math.hypot(t_se, j_se), (
        t_mean, t_se, j_mean, j_se)
    if name == "oracle":
        kf = float(ct.kalman_filter(tm, tp, series).ll)
        assert abs(t_mean - kf) <= 4 * t_se, (t_mean, t_se, kf)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_state_mean_tracks_kalman(scheme):
    """Filtering means within 0.2 posterior sd of Kalman's at every step
    (N = 8192: the Monte Carlo sd of a mean is ~0.02 posterior sd), and
    the Kalman mean inside the 95% state interval."""
    jm, jp, tm, tp = both("oracle")
    data = cj.simulate_regular(jm, jp, jax.random.PRNGKey(1),
                               40).to_timeseries()
    series = to_torch_series(data.ts, data.ys, data.mask)
    kf = ct.kalman_filter(tm, tp, series)
    res = ct.bootstrap_filter(tm, tp, series, 8192,
                              torch.Generator().manual_seed(4),
                              resample=scheme)
    s = res.summary
    assert s.state_mean.shape == (40, 1) and s.eta_mean.shape == (40,)
    sd = kf.covs[:, :, 0].sqrt()
    assert float(((s.state_mean - kf.means).abs() / sd).max()) < 0.2
    assert bool(((s.state_lower <= kf.means)
                 & (kf.means <= s.state_upper)).all())
    np.testing.assert_array_equal(s.ts.numpy(), series.ts.numpy())


@pytest.mark.parametrize("scheme", ["systematic-pallas",
                                    "systematic-pallas-fused"])
def test_ess_threshold_matches_jax(scheme):
    """ESS < 0.5 N triggers a resample; skipped steps carry the weights.
    JAX side: its XLA ``"systematic"`` scheme, which the JAX tests hold
    bit for bit to ``"systematic-pallas"`` under an ESS trigger."""
    jm, jp, tm, tp = both("oracle")
    data = cj.simulate_regular(jm, jp, jax.random.PRNGKey(2),
                               T).to_timeseries()
    series = to_torch_series(data.ts, data.ys, data.mask)
    t_res = [ct.bootstrap_filter(tm, tp, series, N,
                                 torch.Generator().manual_seed(200 + r),
                                 resample=scheme, store="summary",
                                 ess_threshold=0.5)
             for r in range(RUNS_TORCH)]
    j_res = [cj.bootstrap_filter(jm, jp, data, N, jax.random.PRNGKey(30 + r),
                                 resample="systematic", store="ll",
                                 ess_threshold=0.5)
             for r in range(RUNS_TORCH)]
    ess = np.stack([r.ess.numpy() for r in t_res])
    assert (ess >= 0.5 * N).any() and (ess < 0.5 * N).any()
    for pick in (lambda r: float(r.ll),
                 lambda r: float(np.mean(np.asarray(r.ess)))):
        t_mean, t_se = _mean_se([pick(r) for r in t_res])
        j_mean, j_se = _mean_se([pick(r) for r in j_res])
        assert abs(t_mean - j_mean) <= 4 * math.hypot(t_se, j_se), (
            t_mean, t_se, j_mean, j_se)
    kf = ct.kalman_filter(tm, tp, series)
    err = (t_res[0].summary.state_mean - kf.means).abs()
    assert float((err / kf.covs[:, :, 0].sqrt()).max()) < 0.5


@pytest.mark.parametrize("ess_threshold", [None, 0.5])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_store_path(scheme, ess_threshold):
    _, _, tm, tp = both("flagship")
    sim = ct.simulate_regular(tm, tp, torch.Generator().manual_seed(5), 12,
                              dt=1.0)
    res = ct.bootstrap_filter(tm, tp, sim.to_timeseries(), 512,
                              torch.Generator().manual_seed(6),
                              resample=scheme, store="path",
                              ess_threshold=ess_threshold)
    assert res.summary is None
    assert res.sampled_path.shape == (12, tm.dim)
    assert bool(torch.isfinite(res.sampled_path).all())
    # the last step's pick is a particle of the final cloud
    last = res.sampled_path[-1]
    assert bool((res.final_particles == last).all(dim=1).any())


def test_callable_store_receives_rows():
    _, _, tm, tp = both("flagship")
    series = ct.simulate_regular(tm, tp, torch.Generator().manual_seed(7),
                                 9, dt=1.0).to_timeseries()
    gen = torch.Generator().manual_seed(8)
    seen = []
    res = ct.bootstrap_filter(
        tm, tp, series, 256, gen, resample="stratified-pallas",
        store=lambda t, particles, g: seen.append(
            (float(t), tuple(particles.shape), g is gen)))
    assert seen == [(float(t), (256, tm.dim), True) for t in series.ts]
    assert res.summary is None and res.sampled_path is None


def test_default_store_is_summary():
    _, _, tm, tp = both("oracle")
    series = to_torch_series(np.arange(6.0), np.ones(6), np.ones(6, bool))
    res = ct.bootstrap_filter(tm, tp, series, 256, torch.Generator())
    assert isinstance(res.summary, ct.PfSummary)
    assert res.summary.state_lower.shape == (6, 1)
    assert bool((res.summary.state_lower <= res.summary.state_upper).all())


def test_unknown_store_and_scheme_raise():
    _, _, tm, tp = both("oracle")
    series = to_torch_series(np.arange(4.0), np.ones(4), np.ones(4, bool))
    with pytest.raises(ValueError, match="unknown store mode"):
        ct.bootstrap_filter(tm, tp, series, 256, torch.Generator(),
                            resample="systematic-pallas", store="nope")
    with pytest.raises(ValueError, match="unknown resampling scheme"):
        ct.bootstrap_filter(tm, tp, series, 256, torch.Generator(),
                            resample="nope")


@pytest.mark.parametrize("interval", [0.975, 0.5, 1.0])
def test_credible_intervals_match_jax(interval):
    rng = np.random.default_rng(9)
    x = rng.normal(size=(999, 3)).astype(np.float32)
    for got, want in (
            (ct.credible_interval_state(torch.from_numpy(x), interval),
             jfilter.credible_interval_state(jnp.asarray(x), interval)),
            (ct.credible_interval_eta(torch.from_numpy(x[:, 0]), interval),
             jfilter.credible_interval_eta(jnp.asarray(x[:, 0]), interval))):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# floor(N * interval) == 0: the scheme names that the JAX package runs on
# its [N, d] scan clamp the unweighted eta_lower index to n - 1; the names
# it runs on the transposed scan wrap it to 0 (filter.py:260-266, :322-331)
CLAMP_SCHEMES = ["systematic", "stratified", "multinomial", "residual",
                 "identity", "callable"]
WRAP_SCHEMES = ["systematic-pallas", "stratified-pallas",
                "systematic-pallas-fused", "systematic-fused"]


@pytest.mark.parametrize("route", ["clamp", "wrap"])
def test_edge_interval_save_matches_jax_route(route):
    """N = 4 at interval 0.2: one cloud's unweighted summary against the
    save of the JAX route, order statistics bit for bit."""
    jm, _, tm, _ = both("oracle")
    n, interval, t = 4, 0.2, 5.0
    x = np.random.default_rng(12).normal(size=(tm.dim, n)).astype(np.float32)
    wn = np.full(n, 1.0 / n, np.float32)
    if route == "clamp":
        want = jfilter._make_save_fn(jm, "summary", interval, False)(
            jnp.float32(t), jnp.asarray(x.T), jnp.asarray(wn),
            jax.random.PRNGKey(0))
    else:
        want = jfilter._make_save_fn_t(jm, "summary", interval, False)(
            jnp.float32(t), jnp.asarray(x), jnp.asarray(wn),
            jax.random.PRNGKey(0))
    save = _make_save_fn_t(tm, "summary", interval, False, torch.Generator(),
                           1, n, clamp_eta=route == "clamp")
    got = [g.numpy() for g in save(0, torch.tensor(t),
                                   tm.design_vector(torch.tensor(t)),
                                   torch.from_numpy(x), torch.from_numpy(wn))]
    for i in (1, 2, 4, 5):
        np.testing.assert_array_equal(_bits(got[i]), _bits(want[i]))
    for i in (0, 3):
        np.testing.assert_allclose(got[i], want[i], rtol=1e-6, atol=1e-7)
    s = np.sort(x[0])
    assert got[1] == (s[-1] if route == "clamp" else s[0])


@functools.lru_cache(maxsize=None)
def _edge_case():
    """The oracle and its JAX data at T = 5, simulated once per module."""
    jm, jp, tm, tp = both("oracle")
    data = cj.simulate_regular(jm, jp, jax.random.PRNGKey(3),
                               5).to_timeseries()
    return jm, jp, tm, tp, data, to_torch_series(data.ts, data.ys, data.mask)


@pytest.mark.parametrize("scheme", CLAMP_SCHEMES + WRAP_SCHEMES)
def test_edge_interval_eta_lower_follows_jax_route(scheme):
    """The oracle (eta = x) at N = 4, interval 0.2, T = 5.  State levels
    are the cloud's maximum on both routes; eta_lower is the maximum too
    on the clamp route, the minimum (eta_upper) on the wrap route.  The
    JAX package's own ``"systematic"`` filter shows the clamp."""
    jm, jp, tm, tp, data, series = _edge_case()
    resample = ((lambda g, w: torch.arange(w.shape[0]))
                if scheme == "callable" else scheme)
    s = ct.bootstrap_filter(tm, tp, series, 4,
                            torch.Generator().manual_seed(13),
                            resample=resample, interval=0.2).summary
    top = s.state_lower[:, 0]
    assert torch.equal(s.state_upper[:, 0], top)
    if scheme in CLAMP_SCHEMES:
        assert torch.equal(s.eta_lower, top)
        assert bool((s.eta_lower > s.eta_upper).any())
    else:
        assert torch.equal(s.eta_lower, s.eta_upper)
        assert bool((top > s.eta_lower).any())
    if scheme == "systematic":
        j = cj.bootstrap_filter(jm, jp, data, 4, jax.random.PRNGKey(14),
                                resample="systematic", interval=0.2).summary
        np.testing.assert_array_equal(np.asarray(j.eta_lower),
                                      np.asarray(j.state_lower)[:, 0])
        assert (np.asarray(j.eta_lower) > np.asarray(j.eta_upper)).any()
