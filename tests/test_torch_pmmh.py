"""PMMH in the port (``inference/pmmh.py``), on the CPU: the behaviour
tests of ``tests/test_pmmh.py`` and ``tests/test_sweep_kernel.py:157-270``
at small sizes (N <= 128, T <= 80, <= 300 iterations), the diagnostics and
the acceptance step against the JAX package on identical inputs, and the
chain-axis filter against the single-chain filter.

The two packages draw different random streams, so chains compare by
their statistics; ``gelman_rubin``, ``effective_chain_size`` and the
acceptance log-ratio are deterministic and compare to rtol 1e-5 (float32,
sums in another order) or bit for bit.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import composablestatespacemodels_torch as ct
from composablestatespacemodels_torch.inference import filter as tf
from composablestatespacemodels_torch.inference import pmmh as pm
from composablestatespacemodels_torch.models import params as tp_
from composablestatespacemodels_torch.models import perturb
from composablestatespacemodels_torch.models.tree import tree_map
from composablestatespacemodels_tpu.inference import pmmh as jpm

from _torch_parity import both

LOG_HALF = math.log(0.5)


def _lg(t_len=60, seed=0):
    """The JAX tests' linear-Gaussian setup (tests/test_pmmh.py:18-24)."""
    model = ct.linear(ct.brownian_motion(1))
    p0 = ct.parameters(LOG_HALF, ct.brownian_params(0.2, 0.25, 0.3))
    sim = ct.simulate_regular(model, p0, torch.Generator().manual_seed(seed),
                              t_len, dt=0.5)
    return model, p0, sim.to_timeseries()


def _gen(seed=42):
    return torch.Generator().manual_seed(seed)


def test_pmmh_runs_and_accepts():
    model, p0, data = _lg()
    res = ct.pmmh(_gen(), p0, ct.make_pf_loglik(model, data, 64),
                  perturb(0.01), 150)
    rate = float(res.acceptance_rate())
    assert 0.01 < rate < 0.95
    assert res.lls.shape == (150,) and res.n_iters == 150
    assert torch.isfinite(res.lls).all()
    # the first proposal is always accepted (init ll = -1e30)
    assert int(res.accepted[0]) == 1


def test_pmmh_posterior_near_truth():
    model, _, data = _lg(60)
    start = ct.parameters(math.log(2.0), ct.brownian_params(0.2, 0.25, 0.3))
    res = ct.pmmh(_gen(1), start, ct.make_pf_loglik(model, data, 64),
                  perturb(0.02), 250)
    scales = res.thin(burn_in=100, thin=2).params.value.scale
    mean, sd = float(scales.mean()), float(scales.std())
    assert abs(mean - LOG_HALF) < max(4 * sd, 0.5), (mean, sd)


def test_pmmh_chains_shapes_and_isolation():
    """Chain axis: shapes and chains that differ; and row b of the
    chain-axis filter step, given fed draws, equals the step run on row b
    alone (the step and K6 batched keep chains apart)."""
    model, p0, data = _lg(40)
    res = ct.pmmh_chains(_gen(), p0, ct.make_pf_loglik(model, data, 64),
                         perturb(0.01), 40, 4)
    assert res.lls.shape == (4, 40) and res.accepted.shape == (4, 40)
    assert res.params.value.scale.shape == (4, 40)
    rates = res.acceptance_rate()
    assert rates.shape == (4,) and (rates > 0).all()
    assert float(res.lls[:, -1].std()) > 0

    # the chain-axis step: row b given fed draws equals the step on row b
    pb = tree_map(lambda t: t.expand((4,) + t.shape).clone(), p0)
    pb = tp_.add_flat(pb, 0.1 * torch.randn((4, tp_.param_size(p0)),
                                            generator=_gen(2)))
    g = _gen(3)
    x = torch.randn((4, 1, 64), generator=g)
    z = torch.randn((4, 1, 64), generator=g)
    u = torch.rand(4, generator=g)
    a, bb, q = model.sde.transition_coeffs(model.sde_params(pb),
                                           torch.tensor(0.5))
    coef = torch.stack([a, bb, torch.sqrt(q)], -1)
    scale = model.obs_scale(pb)
    wn = torch.full((64,), 1 / 64)
    design = torch.ones(1)
    xb, _, inc = tf._ll_step_chains(model, x, wn, coef, design,
                                    torch.tensor(0.3), scale, True, z, u)
    for i in range(4):
        xi, _, inc_i = tf._ll_step_chains(
            model, x[i:i + 1], wn, coef[i:i + 1], design, torch.tensor(0.3),
            scale[i:i + 1], True, z[i:i + 1], u[i:i + 1])
        assert torch.equal(xb[i], xi[0]) and torch.equal(inc[i], inc_i[0])


def test_chain_filter_repeats_single_chain_filter():
    """With B = 1 the chain-axis filter draws what the single-chain filter
    draws and returns its ll and cloud bit for bit (flagship, a stretch of
    missing observations)."""
    _, _, tm, tp = both("flagship")
    sim = ct.simulate_regular(tm, tp, _gen(0), 30, dt=1.0)
    data = sim.to_timeseries().knock_out(5.0, 8.0)
    res = ct.bootstrap_filter(tm, tp, data, 64, _gen(5),
                              resample="systematic", store="ll")
    ll, x = tf._filter_ll_chains(tm, tree_map(lambda t: t[None], tp), data,
                                 64, _gen(5), data.mask.tolist())
    assert torch.equal(ll[0], res.ll)
    assert torch.equal(x[0], res.final_particles.T)


def test_approx_pmmh_runs():
    model, p0, data = _lg(40)
    res = ct.pmmh(_gen(), p0, ct.make_pf_loglik(model, data, 64),
                  perturb(0.01), 30, approx=True)
    assert torch.isfinite(res.lls).all()


def test_prior_influences_acceptance():
    model, p0, data = _lg(40)
    pf_ll = ct.make_pf_loglik(model, data, 64)

    def tight_prior(params):
        return -1e4 * (params.value.scale - 5.0) ** 2

    flat = ct.pmmh(_gen(), p0, pf_ll, perturb(0.01), 60)
    tight = ct.pmmh(_gen(), p0, pf_ll, perturb(0.01), 60,
                    prior=tight_prior)
    assert int(tight.accepted[-1]) <= int(flat.accepted[-1])


@pytest.mark.parametrize("fused_sweep", [False, True])
def test_pilot_run_variance_falls_with_n(fused_sweep):
    model, p0, data = _lg(40)
    out = ct.pilot_run(model, p0, data, _gen(), particle_counts=(16, 256),
                       n_reps=24, fused_sweep=fused_sweep)
    (n1, m1, v1), (n2, m2, v2) = out
    assert (n1, n2) == (16, 256)
    assert v2 < v1
    assert abs(m1 - m2) < 3.0


def test_thin_shapes():
    model, p0, data = _lg(30)
    res = ct.pmmh(_gen(), p0, ct.make_pf_loglik(model, data, 32),
                  perturb(0.01), 40)
    kept = res.thin(burn_in=8, thin=4)
    assert kept.lls.shape == (8,) and kept.accepted.shape == (8,)
    assert kept.params.value.scale.shape == (8,)
    assert kept.params.value.sde.m0.shape == (8, 1)


@pytest.mark.parametrize("tier", ["single", "single-fused", "chains",
                                  "chains-fused"])
def test_store_state_every_tier(tier):
    model, p0, data = _lg(30)
    n_iters = 12
    if tier.startswith("single"):
        pf_ll = ct.make_pf_loglik(model, data, 64, store_state=True,
                                  fused_sweep=tier.endswith("fused"))
        res = ct.pmmh(_gen(), p0, pf_ll, perturb(0.02), n_iters,
                      store_state=True)
        assert res.states.shape == (n_iters, model.dim)
        inc = np.diff(res.accepted.numpy())
        same = (res.states[1:] == res.states[:-1]).all(1).numpy()
        # rejected iterations carry the state; accepted ones draw anew
        np.testing.assert_array_equal(same, inc == 0)
    else:
        kw = {}
        pf_ll = ct.make_pf_loglik(model, data, 64, store_state=True)
        if tier.endswith("fused"):
            kw["pf_ll_chains"] = ct.make_pf_loglik_chains(model, data, 64,
                                                          store_state=True)
            pf_ll = None
        res = ct.pmmh_chains(_gen(), p0, pf_ll, perturb(0.02), n_iters,
                             3, store_state=True, **kw)
        assert res.states.shape == (3, n_iters, model.dim)
        assert res.thin(burn_in=4, thin=2).states.shape == (3, 4, model.dim)
    assert torch.isfinite(res.states).all()
    plain = ct.pmmh(_gen(), p0, ct.make_pf_loglik(model, data, 32),
                    perturb(0.02), 3)
    assert plain.states is None


def test_store_state_requires_state_evaluator():
    model, p0, data = _lg(8)
    with pytest.raises(ValueError, match="store_state"):
        ct.pmmh(_gen(), p0, ct.make_pf_loglik(model, data, 32),
                perturb(0.02), 3, store_state=True)
    with pytest.raises(ValueError, match="store_state"):
        ct.pmmh_chains(_gen(), p0, None, perturb(0.02), 3, 8,
                       pf_ll_chains=ct.make_pf_loglik_chains(model, data, 32),
                       store_state=True)


def test_store_state_checkpoint_resumed_without_flag():
    model, p0, data = _lg(8)
    res, fin = ct.pmmh(_gen(), p0, ct.make_pf_loglik(model, data, 32,
                                                     store_state=True),
                       perturb(0.02), 4, store_state=True,
                       return_state=True)
    assert res.states.shape == (4, model.dim)
    assert fin.state.shape == (model.dim,)
    cont = ct.pmmh(_gen(1), p0, ct.make_pf_loglik(model, data, 32),
                   perturb(0.02), 3, init_state=fin)
    assert cont.states is None and torch.isfinite(cont.lls).all()
    # resumed: the count goes on from the checkpoint's
    assert int(cont.accepted[0]) >= int(fin.accepted)


def test_adaptive_pmmh_runs():
    model, p0, data = _lg(40)
    start = ct.parameters(math.log(1.0), ct.brownian_params(0.2, 0.25, 0.3))
    res, pilot = ct.adaptive_pmmh(_gen(), start,
                                  ct.make_pf_loglik(model, data, 64), 60,
                                  pilot_iters=60, pilot_delta=0.02,
                                  return_pilot=True)
    assert pilot.lls.shape == (60,) and res.lls.shape == (60,)
    assert torch.isfinite(res.lls).all()
    assert 0.0 < float(res.acceptance_rate()) < 1.0


def test_adaptive_pmmh_degenerate_pilot_does_not_freeze():
    """A pilot that accepts (almost) nothing still gives a main chain whose
    proposals move (the diagonal nugget)."""
    model, p0, data = _lg(30)
    res = ct.adaptive_pmmh(_gen(), p0, ct.make_pf_loglik(model, data, 32),
                           40, pilot_iters=20, pilot_delta=500.0)
    assert torch.isfinite(res.lls).all()
    assert int(res.accepted[-1]) >= 1


def test_pmmh_fused_tiers_run():
    """make_pf_loglik(fused_sweep=True) gives a scalar ll for one chain;
    pmmh_chains(pf_ll_chains=) drives the batched MH loop through K8's
    plain version (flagship-style composed model)."""
    _, _, tm, tp = both("flagship")
    data = ct.simulate_regular(tm, tp, _gen(0), 12, dt=1.0).to_timeseries()
    pf_ll = ct.make_pf_loglik(tm, data, 64, fused_sweep=True)
    v = pf_ll(_gen(), tp)
    assert v.shape == () and torch.isfinite(v)
    res = ct.pmmh(_gen(), tp, pf_ll, perturb(0.02), 4)
    assert res.lls.shape == (4,) and torch.isfinite(res.lls).all()
    res = ct.pmmh_chains(_gen(), tp, None, perturb(0.02), 5, 8,
                         pf_ll_chains=ct.make_pf_loglik_chains(tm, data, 64))
    assert res.lls.shape == (8, 5) and torch.isfinite(res.lls).all()


def test_pmmh_chains_without_batched_form_runs_chain_by_chain():
    model, p0, data = _lg(20)
    inner = ct.make_pf_loglik(model, data, 32)
    calls = []

    def pf_ll(generator, params):
        calls.append(params.value.scale.shape)
        return inner(generator, params)

    res = ct.pmmh_chains(_gen(), p0, pf_ll, perturb(0.01), 5, 2)
    assert res.lls.shape == (2, 5)
    assert set(calls) == {torch.Size([])}   # one chain's tree per call


# ---------------------------------------------------------------------------
# against the JAX package on identical inputs
# ---------------------------------------------------------------------------


def test_gelman_rubin_and_ess_match_jax():
    rng = np.random.default_rng(0)
    same = rng.normal(size=(4, 500)).astype(np.float32)
    apart = same + 5.0 * np.arange(4, dtype=np.float32)[:, None]
    for v in (same, apart):
        np.testing.assert_allclose(float(ct.gelman_rubin(torch.from_numpy(v))),
                                   float(jpm.gelman_rubin(jnp.asarray(v))),
                                   rtol=1e-5)
    assert float(ct.gelman_rubin(torch.from_numpy(same))) < 1.1
    assert float(ct.gelman_rubin(torch.from_numpy(apart))) > 1.5
    iid = same[0]
    corr = np.cumsum(iid) / 10
    for v in (iid, corr):
        np.testing.assert_allclose(
            ct.effective_chain_size(torch.from_numpy(v)),
            jpm.effective_chain_size(jnp.asarray(v)), rtol=1e-4)
    assert ct.effective_chain_size(torch.from_numpy(iid)) > 300
    with pytest.raises(ValueError, match="at least 2 chains"):
        ct.gelman_rubin(torch.zeros((1, 10)))


def test_acceptance_step_matches_jax_formula():
    """The log-ratio and the select of pmmh.py:283-292 of the JAX package,
    on the same lls, trees, prior, transition density and uniforms."""
    _, jp, _, tp = both("seasonal_linear")
    rng = np.random.default_rng(3)
    p = tp_.param_size(tp)
    delta = (0.1 * rng.normal(size=(6, p))).astype(np.float32)
    ll_prop = rng.normal(-50, 2, 6).astype(np.float32)
    ll_cur = rng.normal(-50, 2, 6).astype(np.float32)
    log_u = np.log(rng.uniform(size=6)).astype(np.float32)

    def prior_t(q):
        return -0.5 * (tp_.flatten_params(q) ** 2).sum(-1)

    def lt_t(a, b):
        return -(tp_.flatten_params(b) - 0.9 * tp_.flatten_params(a)).abs(
        ).sum(-1)

    from composablestatespacemodels_tpu.models import params as jp_

    def prior_j(q):
        return -0.5 * (jp_.flatten_params(q) ** 2).sum(-1)

    def lt_j(a, b):
        return -jnp.abs(jp_.flatten_params(b) - 0.9 * jp_.flatten_params(a)
                        ).sum(-1)

    cur_t = tp_.add_flat(tree_map(lambda t: t.expand((6,) + t.shape), tp),
                         torch.zeros(6, p))
    prop_t = tp_.add_flat(cur_t, torch.from_numpy(delta))
    a_t = pm._log_ratio(torch.from_numpy(ll_prop), torch.from_numpy(ll_cur),
                        prop_t, cur_t, prior_t, lt_t)
    accept = torch.from_numpy(log_u) < a_t
    sel = pm._select(accept, cur_t, prop_t)
    for i in range(6):
        cur_j = jp
        prop_j = jp_.add_flat(jp, jnp.asarray(delta[i]))
        a_j = (ll_prop[i] + lt_j(prop_j, cur_j) + prior_j(prop_j)
               - lt_j(cur_j, prop_j) - ll_cur[i] - prior_j(cur_j))
        np.testing.assert_allclose(float(a_t[i]), float(a_j), rtol=1e-6)
        acc_j = bool(log_u[i] < a_j)
        assert bool(accept[i]) == acc_j
        new_j = jax.tree_util.tree_map(lambda c, q: jnp.where(acc_j, q, c),
                                       cur_j, prop_j)
        np.testing.assert_array_equal(
            tp_.flatten_params(sel)[i].numpy(),
            np.asarray(jp_.flatten_params(new_j)))
    assert 0 < int(accept.sum()) < 6
