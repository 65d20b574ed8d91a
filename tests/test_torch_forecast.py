"""Euler-Maruyama and forecasting in the port, against the JAX package
where it has the same function.

An SDE that defines only ``drift`` and ``diffusion`` steps by
Euler-Maruyama; fed the same normals, the port's step equals the JAX
package's ``step_euler_maruyama``.  Forecasting advances a filtering cloud,
or posterior draws, with ``model.step`` and the family's sampler.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import composablestatespacemodels_torch as ct
from composablestatespacemodels_torch.models.tree import tree_map
from composablestatespacemodels_tpu.inference import filter as jfilter

from _torch_parity import both, drift_only_ou


@pytest.mark.parametrize("name", ["flagship", "oracle", "drift_only"])
def test_euler_maruyama_matches_jax(name):
    """``x + a(x) dt + b(x) sqrt(dt) z`` against JAX's
    ``step_euler_maruyama`` fed the same normals, on [N, d]; the drift-only
    OU's [d, N] step is its [N, d] step transposed."""
    jm, jp, tm, tp = both("poisson" if name == "drift_only" else name)
    sde = drift_only_ou()[0].sde if name == "drift_only" else tm.sde
    p = tm.sde_params(tp)
    x = np.random.default_rng(0).normal(size=(64, tm.dim)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jm.sde.step_euler_maruyama(jm.sde_params(jp), key,
                                                  jnp.asarray(x), 0.3))
    z = np.array(jax.random.normal(key, x.shape, jnp.float32))
    got = sde.euler_maruyama(p, torch.from_numpy(x), 0.3, torch.from_numpy(z))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    if name == "drift_only":
        dt = torch.tensor(0.3)
        step = sde.step(p, torch.Generator().manual_seed(4),
                        torch.from_numpy(x), dt)
        step_t = sde.step_t(p, torch.Generator().manual_seed(4),
                            torch.from_numpy(x.T.copy()), dt)
        assert torch.equal(step_t.T, step)


def test_composite_em_steps_each_component():
    """A composition with one EM component steps each side on its own
    slice: the exact side as its exact transition, the other by EM."""
    em, ep = drift_only_ou()
    _, _, _, sp = both("seasonal_linear")
    model = em + ct.seasonal(24, 2, ct.ou_process(4))
    params = ct.branch(ep, sp.right)
    assert not model.sde.exact
    p = model.sde_params(params)
    x = torch.randn(32, model.dim, generator=torch.Generator().manual_seed(1))
    got = model.sde.step(p, torch.Generator().manual_seed(2), x,
                         torch.tensor(0.5))
    g = torch.Generator().manual_seed(2)
    left = model.sde.left.step_euler_maruyama(p[0], g, x[:, :1],
                                              torch.tensor(0.5))
    right = model.sde.right.step(p[1], g, x[:, 1:], torch.tensor(0.5))
    assert torch.equal(got, torch.cat([left, right], dim=-1))
    sim = ct.simulate_regular(model, params, torch.Generator().manual_seed(3),
                              20)
    assert bool(torch.isfinite(sim.xs).all())


# ---------------------------------------------------------------------------
# forecasting
# ---------------------------------------------------------------------------


def _final_cloud():
    _, _, tm, tp = both("flagship")
    series = ct.simulate_regular(tm, tp, torch.Generator().manual_seed(7), 10,
                                 dt=1.0).to_timeseries()
    res = ct.bootstrap_filter(tm, tp, series, 512,
                              torch.Generator().manual_seed(8), store="ll")
    return tm, tp, res.final_particles, float(series.ts[-1])


def test_forecast_is_the_summarised_cloud():
    tm, tp, x, t_last = _final_cloud()
    f = ct.forecast(tm, tp, x, t_last, t_last + 2.0,
                    torch.Generator().manual_seed(5))
    cloud = ct.forecast_cloud(tm, tp, x, t_last, t_last + 2.0,
                              torch.Generator().manual_seed(5))
    assert cloud.state.shape == (512, tm.dim) and cloud.obs.shape == (512,)
    want = cloud.summarise()
    ft = ct.forecast_times(tm, tp, x, t_last, [t_last + 2.0],
                           torch.Generator().manual_seed(5))
    for field in ct.Forecast.__dataclass_fields__:
        assert torch.equal(getattr(f, field), getattr(want, field)), field
        assert torch.equal(getattr(ft, field)[0], getattr(want, field)), field


def test_forecast_times_ordered_bounds():
    tm, tp, x, t_last = _final_cloud()
    f = ct.forecast_times(tm, tp, x, t_last, t_last + torch.arange(1.0, 6.0),
                          torch.Generator().manual_seed(6))
    assert f.state_mean.shape == (5, tm.dim) and f.obs_mean.shape == (5,)
    for lo, hi in ((f.obs_lower, f.obs_upper), (f.eta_lower, f.eta_upper),
                   (f.state_lower, f.state_upper)):
        assert bool(torch.isfinite(lo).all() and (lo <= hi).all())


@pytest.mark.parametrize("k", [4, 3])
def test_forecast_from_posterior_pairing(k):
    """``state_samples`` with one row per parameter draw keeps the pairs
    (row i partners draw i); other counts are drawn on their own.  At
    ``t = t0`` the exact step moves nothing, so the forecast's state mean
    is the mean of the states drawn."""
    _, _, tm, tp = both("oracle")
    stacked = tree_map(lambda v: torch.stack([v] * 4), tp)
    states = torch.arange(float(k))[:, None]
    f = ct.forecast_from_posterior(tm, stacked,
                                   torch.Generator().manual_seed(6), 0.0,
                                   [0.0], 64, state_samples=states)
    g = torch.Generator().manual_seed(6)
    idx = torch.randint(0, 4, (64,), generator=g)
    if k != 4:
        idx = torch.randint(0, k, (64,), generator=g)
    assert float(f.state_mean[0, 0]) == pytest.approx(
        float(states[idx].mean()), rel=1e-6)


@pytest.mark.parametrize("n,interval", [(1, 0.995), (1, 0.2), (3, 0.2),
                                        (999, 5e-4)])
def test_credible_interval_eta_edges_match_jax(n, interval):
    """``n * interval < 1`` (and n = 1): the lower index ``n - 0`` is
    clamped to the maximum, as the JAX package's indexing clamps it."""
    x = np.random.default_rng(n).normal(size=n).astype(np.float32)
    got = ct.credible_interval_eta(torch.from_numpy(x), interval)
    want = jfilter.credible_interval_eta(jnp.asarray(x), interval)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert float(got[0]) == x.max()


def test_forecast_from_posterior_one_sample():
    """One posterior draw: every order statistic of the pooled draws is
    the draw itself, so the bounds equal the means."""
    _, _, tm, tp = both("flagship")
    stacked = tree_map(lambda v: torch.stack([v] * 3), tp)
    f = ct.forecast_from_posterior(tm, stacked,
                                   torch.Generator().manual_seed(9), 0.0,
                                   [1.0, 2.0], 1)
    for mean, lo, hi in ((f.eta_mean, f.eta_lower, f.eta_upper),
                         (f.obs_mean, f.obs_lower, f.obs_upper),
                         (f.state_mean, f.state_lower, f.state_upper)):
        assert torch.equal(lo, mean) and torch.equal(hi, mean)
