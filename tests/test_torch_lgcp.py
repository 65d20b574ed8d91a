"""``lgcp_filter``, ``simulate_lgcp`` and ``simulate_sde_grid`` of the port
against the JAX package's (``inference/lgcp.py``, ``utils/data.py``) on the
CPU, where every kernel wrapper runs its plain PyTorch version.

* Deterministic pieces are bit-equal: the host-built fine grid, flag for
  flag, and the interval indices.
* The filters draw different random streams, so their lls agree
  statistically: means within 4 joint standard errors.  As in the JAX
  tests, the ll prefers the generating parameters and a zero-dt event
  weighs flat.
"""

import functools
import math
import statistics

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import composablestatespacemodels_torch as ct
import composablestatespacemodels_tpu as cj
from composablestatespacemodels_torch.inference import lgcp as tl
from composablestatespacemodels_tpu.inference import lgcp as jl
from composablestatespacemodels_tpu.utils.data import TimeSeries as JSeries

from _torch_parity import to_torch_series

GRIDS = {
    "irregular": [0.0, 0.3, 0.35, 1.9, 2.0, 5.0],
    "duplicates": [1.0, 1.0, 1.25, 1.25, 1.25, 3.0],
    "single": [0.7],
    "outlier": list(np.arange(0.0, 10.0, 0.5)) + [20.0],
    "exact_multiples": [0.0, 0.1, 0.3, 0.6, 1.0],
}


@pytest.mark.parametrize("precision", [1, 2])
@pytest.mark.parametrize("case", sorted(GRIDS))
def test_fine_grid_matches_jax(case, precision):
    ts = np.asarray(GRIDS[case], np.float64)
    got = tl._build_fine_grid(ts, precision)
    want = jl._build_fine_grid(ts, precision)
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        w = np.asarray(w)
        # float32 times and bool flags as JAX's; obs_idx stays a host
        # int64 index where JAX holds int32
        assert g.dtype.kind == w.dtype.kind and g.shape == w.shape
        assert g.dtype == w.dtype or g.dtype.kind == "i"
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n", [1, 4, 5, 100, 1024])
def test_interval_ks_match_jax(n):
    for interval in (0.0, 1e-4, 0.2, 0.5, 0.9, 0.975, 0.995, 1.0):
        assert tl._interval_ks(n, interval) == jl._interval_ks(n, interval)


def _lgcp_both(mu=1.0):
    jm = cj.lgcp(cj.brownian_motion(1))
    jp = cj.parameters(None, cj.brownian_params(mu, 0.05, 0.05))
    tm = ct.lgcp(ct.brownian_motion(1))
    tp = ct.parameters(None, ct.brownian_params(mu, 0.05, 0.05))
    return jm, jp, tm, tp


def _series(ts):
    ts = np.asarray(ts, np.float32)
    ones = np.ones_like(ts)
    return (JSeries(jnp.asarray(ts), jnp.asarray(ones),
                    jnp.ones(ts.shape, dtype=bool)),
            to_torch_series(ts, ones, np.ones(ts.shape, bool)))


RUNS, N_STAT = 8, 512
EVENTS = [0.0, 0.3, 0.35, 1.9, 2.0, 3.1, 3.15, 4.4]


def _mean_se(values):
    return statistics.fmean(values), statistics.stdev(values) / math.sqrt(
        len(values))


@functools.lru_cache(maxsize=None)
def _jax_lls():
    jm, jp, _, _ = _lgcp_both()
    jdata, _ = _series(EVENTS)
    return [float(jl.lgcp_filter(jm, jp, jdata, N_STAT,
                                 jax.random.PRNGKey(30 + r)).ll)
            for r in range(RUNS)]


@pytest.mark.parametrize("scheme", ["systematic", "stratified"])
def test_ll_matches_jax(scheme):
    """The port's ll under ``scheme`` against the JAX filter's
    (``"systematic"``), within 4 joint standard errors over 8 runs each."""
    _, _, tm, tp = _lgcp_both()
    _, data = _series(EVENTS)
    t_lls = [float(tl.lgcp_filter(tm, tp, data, N_STAT,
                                  torch.Generator().manual_seed(30 + r),
                                  resample=scheme).ll) for r in range(RUNS)]
    (mj, sj), (mt, st) = _mean_se(_jax_lls()), _mean_se(t_lls)
    assert abs(mj - mt) <= 4 * math.hypot(sj, st), (_jax_lls(), t_lls)


def _custom(generator, weights):
    return torch.multinomial(weights, weights.shape[0], replacement=True,
                             generator=generator)


@pytest.mark.parametrize("scheme", ["systematic", "systematic-pallas",
                                    "stratified", "multinomial", "residual",
                                    "identity", "custom"])
def test_filter_runs_every_scheme(scheme):
    """Finite ll, ESS in [1, N], the mean intensity positive and the
    intervals ordered around the means, for every scheme name."""
    _, _, tm, tp = _lgcp_both()
    _, data = _series(EVENTS)
    res = tl.lgcp_filter(tm, tp, data, 300, torch.Generator().manual_seed(1),
                         resample=_custom if scheme == "custom" else scheme)
    t = len(EVENTS)
    assert math.isfinite(float(res.ll))
    assert res.ess.shape == res.ll_history.shape == (t,)
    assert bool(((res.ess >= 1) & (res.ess <= 300)).all())
    assert bool((res.eta_mean > 0).all())
    assert bool((res.eta_lower <= res.eta_upper).all())
    assert res.state_lower.shape == res.state_mean.shape == (t, 1)
    assert bool((res.state_lower <= res.state_mean).all())
    assert bool((res.state_mean <= res.state_upper).all())
    assert res.final_particles.shape == (300, 1)


def test_systematic_pallas_is_systematic():
    """``"systematic-pallas"`` is the JAX name of the K1 + K4 route: the
    same draws and the same result as ``"systematic"``."""
    _, _, tm, tp = _lgcp_both()
    _, data = _series(EVENTS)
    a, b = (tl.lgcp_filter(tm, tp, data, 256,
                           torch.Generator().manual_seed(5), resample=s)
            for s in ("systematic", "systematic-pallas"))
    assert torch.equal(a.ll_history, b.ll_history)
    assert torch.equal(a.final_particles, b.final_particles)


def test_zero_dt_event_weighs_flat():
    """As the JAX test (``tests/test_lgcp.py:108``): a repeated event time
    (and the first event) is a zero-dt segment with flat weights: ESS N and
    no ll increment beyond rounding."""
    _, _, tm, tp = _lgcp_both()
    _, data = _series([0.5, 0.5, 1.0])
    res = tl.lgcp_filter(tm, tp, data, 100, torch.Generator().manual_seed(2))
    assert math.isfinite(float(res.ll))
    assert res.ess[:2].tolist() == [100, 100]
    assert abs(float(res.ll_history[1])) < 1e-5


def test_filter_discriminates_parameters():
    """As the JAX test (``tests/test_lgcp.py:72``): on events simulated by
    the port at mu = 1.5, the ll prefers mu = 1.5 to mu = -2."""
    model = ct.lgcp(ct.gen_brownian_motion(1))
    true_p = ct.parameters(None, ct.gen_brownian_params(1.5, 0.01, 0.0,
                                                        0.01))
    far_p = ct.parameters(None, ct.gen_brownian_params(-2.0, 0.01, 0.0,
                                                       0.01))
    events, _ = ct.simulate_lgcp(model, true_p,
                                 torch.Generator().manual_seed(42), 0.0, 8.0)
    assert len(events) >= 5
    data = events.to_timeseries()
    lls = {name: statistics.fmean(
        float(tl.lgcp_filter(model, p, data, 200,
                             torch.Generator().manual_seed(r)).ll)
        for r in range(3)) for name, p in (("true", true_p), ("far", far_p))}
    assert lls["true"] > lls["far"], lls


def test_simulate_lgcp_events_and_grid():
    """As the JAX test (``tests/test_lgcp.py:25``): increasing event times
    in [start, end] with y = 1, a fine grid over [0, 5] at step 0.01 that
    starts at (start, x0), and more events where the intensity is higher
    (:39)."""
    model = ct.lgcp(ct.brownian_motion(1))
    params = ct.parameters(None, ct.brownian_params(1.0, 0.05, 0.05))
    events, grid = ct.simulate_lgcp(model, params,
                                    torch.Generator().manual_seed(2), 0.0,
                                    5.0, precision=2)
    ts = events.ts.numpy()
    assert len(events) > 0
    assert (ts >= 0).all() and (ts <= 5.0).all() and (np.diff(ts) > 0).all()
    assert bool((events.ys == 1.0).all())
    assert events.xs.shape == (len(events), 1)
    assert len(grid) == 501 and abs(float(grid.ts[0])) < 1e-6
    torch.testing.assert_close(grid.etas, torch.exp(grid.gammas))
    counts = []
    for mu in (0.0, 2.0):
        p = ct.parameters(None, ct.brownian_params(mu, 0.01, 0.01))
        ev, _ = ct.simulate_lgcp(model, p, torch.Generator().manual_seed(3),
                                 0.0, 10.0, 2)
        counts.append(len(ev))
    assert counts[1] > counts[0], counts


def test_simulate_sde_grid_steps():
    sde = ct.brownian_motion(2)
    sp = ct.brownian_params(0.0, 0.0, 0.0)
    x0 = torch.zeros(2)
    ts, xs = ct.utils.data.simulate_sde_grid(
        sde, sp, torch.Generator().manual_seed(0), x0, 1.0, 0.3, 1)
    assert xs.shape == (4, 2) and torch.equal(xs[0], x0)
    torch.testing.assert_close(ts, torch.tensor([1.0, 1.1, 1.2, 1.3]))


def test_lgcp_observation_family_still_raises():
    fam = ct.lgcp(ct.brownian_motion(1)).obs
    with pytest.raises(NotImplementedError, match="lgcp_filter"):
        fam.log_density(torch.zeros(3), torch.ones(3), torch.ones(()))
    with pytest.raises(NotImplementedError, match="simulate_lgcp"):
        fam.sample(torch.Generator(), torch.zeros(3), torch.ones(()))


def test_rejects_unknown_scheme():
    _, _, tm, tp = _lgcp_both()
    _, data = _series(EVENTS)
    with pytest.raises(ValueError, match="unknown resampling scheme"):
        tl.lgcp_filter(tm, tp, data, 8, torch.Generator(),
                       resample="stratified-pallas")
