"""The observation families through the port's filters, against the JAX
package; the default scheme; PMMH's likelihood under every scheme.

For each pointwise family (the cases of
``tests/test_families_end_to_end.py:14-42``) JAX's ``log_likelihood``
(its default ``"systematic"``) runs on JAX-simulated data, and the port
runs the same data through the kernels' plain versions: the fused ll route
(K1, the K2 + K3 twin), the fused summary filter (K5 + K3 twin), the
multinomial scheme and K8's twin through ``make_pf_loglik(fused_sweep=True)``.
The two packages draw different random streams, so the mean lls agree
statistically: within 4 joint standard errors, with a floor of 0.5 nats
(the standard errors come from a few runs each).
"""

import collections
import functools
import inspect
import math
import statistics

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import composablestatespacemodels_torch as ct
import composablestatespacemodels_tpu as cj
from composablestatespacemodels_torch.inference import filter as tfilter
from composablestatespacemodels_torch.models.tree import tree_map

from _torch_parity import (FAMILY_CASES, both, drift_only_ou,
                           to_torch_series)

N, T = 1000, 60
RUNS_JAX, RUNS_TORCH = 3, 3
FAMILY_NAMES = sorted(FAMILY_CASES)


def _mean_se(values):
    return statistics.fmean(values), statistics.stdev(values) / math.sqrt(
        len(values))


@functools.lru_cache(maxsize=None)
def _case(name):
    """The port's model and parameters, JAX-simulated data as a torch
    series, and JAX's mean ll and its standard error."""
    jm, jp, tm, tp = both(name)
    # compiled whole: eager dispatch compiles the samplers op by op
    data = jax.jit(lambda key: cj.simulate_regular(
        jm, jp, key, T, dt=0.5).to_timeseries())(jax.random.PRNGKey(1))
    lls = [float(cj.log_likelihood(jm, jp, data, N, jax.random.PRNGKey(10 + r)))
           for r in range(RUNS_JAX)]
    return tm, tp, to_torch_series(data.ts, data.ys, data.mask), _mean_se(lls)


def _summary_ll(tm, tp, series, gen):
    res = ct.bootstrap_filter(tm, tp, series, N, gen,
                              resample="systematic-pallas-fused",
                              store="summary")
    s = res.summary
    assert bool((s.state_lower <= s.state_upper).all())
    assert bool((s.eta_lower <= s.eta_upper).all())
    return res.ll


def _k8_lls(tm, tp, series, gen, runs=1):
    """K8's twin through ``make_pf_loglik(fused_sweep=True)``: ``runs``
    independent filters as one call of its chain-batched form."""
    pf = ct.make_pf_loglik(tm, series, N, fused_sweep=True)
    if runs == 1:
        return pf(gen, tp)
    return pf.chains(gen, tree_map(lambda v: torch.stack([v] * runs), tp))


ROUTES = {
    "systematic-fused": lambda tm, tp, series, gen: ct.log_likelihood(
        tm, tp, series, N, gen, resample="systematic-fused"),
    "pallas-fused-summary": _summary_ll,
    "multinomial": lambda tm, tp, series, gen: ct.log_likelihood(
        tm, tp, series, N, gen, resample="multinomial"),
    "k8": _k8_lls,
}


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("name", FAMILY_NAMES)
def test_family_route_matches_jax(name, route):
    tm, tp, series, (j_mean, j_se) = _case(name)
    if route == "k8":
        lls = _k8_lls(tm, tp, series, torch.Generator().manual_seed(100),
                      RUNS_TORCH).tolist()
    else:
        lls = [float(ROUTES[route](tm, tp, series,
                                   torch.Generator().manual_seed(100 + r)))
               for r in range(RUNS_TORCH)]
    assert all(map(math.isfinite, lls)), lls
    t_mean, t_se = _mean_se(lls)
    assert abs(t_mean - j_mean) <= max(4 * math.hypot(t_se, j_se), 0.5), (
        t_mean, t_se, j_mean, j_se)


@pytest.mark.parametrize("route", [
    "systematic", "stratified", "multinomial", "residual", "identity",
    "systematic-fused", "pallas-fused-summary", "k8"])
def test_beta_missing_observation_is_finite(route):
    """Beta's constants at a masked step hold log(0); no route may let them
    reach the ll."""
    tm, tp, series, _ = _case("beta")
    series = series.knock_out(10.0, 11.0)
    assert int((~series.mask).sum()) == 3
    gen = torch.Generator().manual_seed(5)
    if route in ROUTES:
        ll = ROUTES[route](tm, tp, series, gen)
    else:
        ll = ct.log_likelihood(tm, tp, series, N, gen, resample=route)
    assert math.isfinite(float(ll))


@pytest.mark.parametrize("name", FAMILY_NAMES)
def test_simulate_support(name):
    tm, tp, _, _ = _case(name)
    sim = ct.simulate_regular(tm, tp, torch.Generator().manual_seed(2), 200,
                              dt=0.5)
    ys = sim.ys.numpy()
    assert ys.shape == (200,) and np.isfinite(ys).all()
    if name in ("poisson", "negative_binomial", "zero_inflated_poisson"):
        assert (ys >= 0).all() and (ys == np.round(ys)).all()
    if name == "bernoulli":
        assert set(np.unique(ys)) <= {0.0, 1.0}
    if name == "beta":
        assert ((ys > 0) & (ys < 1)).all()


# ---------------------------------------------------------------------------
# the default scheme
# ---------------------------------------------------------------------------


def test_default_scheme_is_systematic(monkeypatch):
    """With no ``resample`` both entry points take the ``"systematic"``
    route, as the JAX package does: K1 counts gathered by K4, no K2 or K5
    call (a spy on the wrappers; their ``.launches`` count CUDA launches
    only).  An SDE without an exact transition runs under the default."""
    for fn in (ct.bootstrap_filter, ct.log_likelihood):
        assert inspect.signature(fn).parameters["resample"].default == (
            inspect.signature(getattr(cj, fn.__name__))
            .parameters["resample"].default) == "systematic"
    calls = collections.Counter()
    for name in ("sorted_gather_resample_t", "resample_propagate",
                 "propagate_weights_t"):
        def spy(*args, _name=name, _real=getattr(tfilter, name), **kwargs):
            calls[_name] += 1
            return _real(*args, **kwargs)
        monkeypatch.setattr(tfilter, name, spy)
    _, _, tm, tp = both("flagship")
    series = ct.simulate_regular(tm, tp, torch.Generator().manual_seed(3), 6,
                                 dt=1.0).to_timeseries()
    res = ct.bootstrap_filter(tm, tp, series, 256, torch.Generator())
    assert res.summary is not None and math.isfinite(float(res.ll))
    assert math.isfinite(float(ct.log_likelihood(tm, tp, series, 256,
                                                 torch.Generator())))
    assert calls == {"sorted_gather_resample_t": 12}

    em, ep = drift_only_ou()
    assert not em.sde.exact
    calls.clear()
    res = ct.bootstrap_filter(em, ep, series, 256, torch.Generator())
    assert math.isfinite(float(res.ll)) and calls == {
        "sorted_gather_resample_t": 6}


@pytest.mark.parametrize("call", ["fused", "summary-fused", "k8", "kalman"])
def test_exact_only_routes_raise_for_em_sde(call):
    """K2, K5, K8 and the Kalman filter need an exact transition; they
    raise the JAX package's error for an SDE without one."""
    em, ep = drift_only_ou()
    series = to_torch_series(np.arange(4.0), np.ones(4), np.ones(4, bool))
    with pytest.raises(NotImplementedError,
                       match="has no exact linear-Gaussian transition"):
        if call == "kalman":
            ct.kalman_filter(em, ep, series)
        elif call == "k8":
            ct.make_pf_loglik(em, series, 64, fused_sweep=True)(
                torch.Generator(), ep)
        else:
            ct.bootstrap_filter(
                em, ep, series, 64, torch.Generator(),
                resample="systematic-fused",
                store="ll" if call == "fused" else "summary")


# ---------------------------------------------------------------------------
# PMMH's likelihood: every scheme name; K8 needs a K3 hook
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scheme", [
    "systematic", "systematic-pallas", "stratified", "stratified-pallas",
    "multinomial", "residual", "identity", "systematic-pallas-fused"])
def test_make_pf_loglik_takes_every_scheme(scheme):
    tm, tp, series, _ = _case("negative_binomial")
    pf = ct.make_pf_loglik(tm, series, 128, resample=scheme)
    assert math.isfinite(float(pf(torch.Generator().manual_seed(1), tp)))


def test_k8_without_hook_raises_as_jax():
    jm, tm = cj.lgcp(cj.ou_process(1)), ct.lgcp(ct.ou_process(1))
    series = to_torch_series(np.arange(4.0), np.ones(4), np.ones(4, bool))
    data = cj.TimeSeries(jnp.arange(4.0), jnp.ones(4), jnp.ones(4, bool))
    with pytest.raises(ValueError) as want:
        cj.make_pf_loglik(jm, data, 64, fused_sweep=True)
    with pytest.raises(ValueError) as got:
        ct.make_pf_loglik(tm, series, 64, fused_sweep=True)
    assert str(got.value) == str(want.value)
