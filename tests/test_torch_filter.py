"""The port's main path as a whole: ``log_likelihood(...,
resample="systematic-fused")`` on the CPU (the kernels' plain versions)
against the JAX package and the Kalman oracle.

The two packages draw different random streams, so log-likelihoods agree
statistically: the means of 16 runs each lie within 4 joint standard
errors.
"""

import math
import statistics

import jax
import numpy as np
import pytest
import torch

import composablestatespacemodels_torch as ct
import composablestatespacemodels_tpu as cj

from _torch_parity import both, to_torch_series

N = 4096
RUNS = 16


def _mean_se(values):
    return statistics.fmean(values), statistics.stdev(values) / math.sqrt(
        len(values))


def _torch_lls(model, params, data, runs=RUNS, n=N):
    return [float(ct.log_likelihood(model, params, data, n,
                                    torch.Generator().manual_seed(100 + r),
                                    resample="systematic-fused"))
            for r in range(runs)]


def test_flagship_matches_jax():
    jm, jp, tm, tp = both("flagship")
    data = cj.simulate_regular(jm, jp, jax.random.PRNGKey(0), 40,
                               dt=1.0).to_timeseries()
    t_mean, t_se = _mean_se(_torch_lls(tm, tp, to_torch_series(
        data.ts, data.ys, data.mask)))
    j_mean, j_se = _mean_se([
        float(cj.log_likelihood(jm, jp, data, N, jax.random.PRNGKey(r),
                                resample="systematic"))
        for r in range(RUNS)])
    assert abs(t_mean - j_mean) <= 4 * math.hypot(t_se, j_se), (
        t_mean, t_se, j_mean, j_se)


@pytest.mark.parametrize("model", ["oracle", "seasonal_linear"])
def test_matches_kalman_oracle(model):
    jm, jp, tm, tp = both(model)
    data = cj.simulate_regular(jm, jp, jax.random.PRNGKey(1), 40).to_timeseries()
    series = to_torch_series(data.ts, data.ys, data.mask)
    kf = float(ct.kalman_filter(tm, tp, series).ll)
    np.testing.assert_allclose(kf, float(cj.kalman_filter(jm, jp, data).ll),
                               rtol=1e-5)
    mean, se = _mean_se(_torch_lls(tm, tp, series))
    assert abs(mean - kf) <= 4 * se, (mean, se, kf)


def test_all_missing_gives_zero_ll():
    _, _, tm, tp = both("flagship")
    series = to_torch_series(np.arange(12.0), np.zeros(12), np.zeros(12, bool))
    res = ct.bootstrap_filter(tm, tp, series, 1024, torch.Generator(),
                              resample="systematic-fused")
    assert float(res.ll) == 0.0
    assert (res.ess.numpy() == 1024).all()
    assert res.final_particles.shape == (1024, tm.dim)


def test_knocked_out_stretch_runs():
    jm, jp, tm, tp = both("flagship")
    data = cj.simulate_regular(jm, jp, jax.random.PRNGKey(2), 30,
                               dt=1.0).to_timeseries()
    series = to_torch_series(data.ts, data.ys, data.mask).knock_out(8.0, 15.0)
    res = ct.bootstrap_filter(tm, tp, series, 2048, torch.Generator(),
                              resample="systematic-fused")
    hist = res.ll_history.numpy()
    assert np.isfinite(hist).all() and res.ll == hist[-1]
    missing = ~series.mask.numpy()
    assert missing.sum() == 8
    # a missing observation leaves ll and ESS where they were
    idx = np.flatnonzero(missing)
    assert (hist[idx] == hist[idx[0] - 1]).all()
    ess = res.ess.numpy()
    assert (ess[idx] == ess[idx[0] - 1]).all()
    assert ((1 <= ess) & (ess <= 2048)).all()


@pytest.mark.parametrize("init", ["fixed", "cloud"])
def test_initial_state(init):
    _, _, tm, tp = both("oracle")
    series = to_torch_series(np.arange(5.0) * 0.1, np.ones(5), np.ones(5, bool))
    x0 = (torch.tensor([0.3]) if init == "fixed"
          else torch.randn(512, 1, generator=torch.Generator()))
    res = ct.bootstrap_filter(tm, tp, series, 512, torch.Generator(),
                              initial_state=x0, t0=-0.5,
                              resample="systematic-fused")
    assert math.isfinite(float(res.ll))
    assert res.final_particles.shape == (512, 1)


@pytest.mark.parametrize("kwargs", [
    {"resample": "systematic"}, {"resample": "stratified"},
    {"resample": "multinomial"}, {"resample": "residual"},
    {"resample": "identity"},
])
def test_unported_options_raise(kwargs):
    """Every generic scheme runs; what stays unsupported under each, as in
    the JAX package, raises: the log-Gaussian Cox process has no pointwise
    likelihood."""
    _, _, tm, tp = both("oracle")
    series = to_torch_series(np.arange(4.0), np.ones(4), np.ones(4, bool))
    res = ct.bootstrap_filter(tm, tp, series, 256, torch.Generator(), **kwargs)
    assert math.isfinite(float(res.ll))
    lgcp = ct.lgcp(ct.brownian_motion(1))
    with pytest.raises(NotImplementedError, match="no pointwise likelihood"):
        ct.bootstrap_filter(lgcp, tp, series, 256, torch.Generator(),
                            **kwargs)


def test_simulate_regular_shapes():
    _, _, tm, tp = both("flagship")
    sim = ct.simulate_regular(tm, tp, torch.Generator().manual_seed(3), 50,
                              dt=1.0)
    assert sim.xs.shape == (50, 7) and sim.ys.shape == (50,)
    ys = sim.ys.numpy()
    assert (ys >= 0).all() and (ys == np.round(ys)).all()
    np.testing.assert_allclose(
        sim.gammas.numpy(),
        (sim.xs * tm.design_vector(sim.ts)).sum(-1).numpy())
    assert sim.to_timeseries().mask.all()
