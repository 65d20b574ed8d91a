"""The port's Kalman filter (the oracle) against the JAX package's, on the
same series: log-likelihood within rtol 1e-5, filtered moments within
rtol 1e-4 (float32 recursions in two libraries)."""

import jax
import numpy as np
import pytest

import composablestatespacemodels_torch as ct
import composablestatespacemodels_tpu as cj

from _torch_parity import both, to_torch_series


@pytest.mark.parametrize("model", ["oracle", "seasonal_linear"])
@pytest.mark.parametrize("missing", [False, True])
def test_kalman_matches_jax(model, missing):
    jm, jp, tm, tp = both(model)
    data = cj.simulate_regular(jm, jp, jax.random.PRNGKey(4), 60).to_timeseries()
    if missing:
        data = data.knock_out(2.0, 3.5)
    want = cj.kalman_filter(jm, jp, data)
    got = ct.kalman_filter(tm, tp, to_torch_series(data.ts, data.ys,
                                                   data.mask))
    np.testing.assert_allclose(float(got.ll), float(want.ll), rtol=1e-5)
    for g, w in ((got.means, want.means), (got.covs, want.covs),
                 (got.pred_obs, want.pred_obs),
                 (got.pred_obs_var, want.pred_obs_var)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)


def test_kalman_refuses_non_gaussian():
    tm, tp = ct.poisson(ct.brownian_motion(1)), ct.parameters(
        None, ct.brownian_params(0.0, 1.0, 0.4))
    data = to_torch_series(np.arange(3.0), np.ones(3), np.ones(3, bool))
    with pytest.raises(TypeError, match="Gaussian"):
        ct.kalman_filter(tm, tp, data)
