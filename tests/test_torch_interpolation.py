"""``interpolation_filter`` of the port against the JAX package's
(``inference/interpolation.py``) on the CPU, where every kernel wrapper
runs its plain PyTorch version and the JAX filter runs as its own tests
run it.

* Deterministic pieces are bit-equal: the genealogy that the port builds
  from counts with ``torch.searchsorted`` and the JAX back-scan over the
  ancestors of the same counts; ``interpolation_memory_bytes``; the eta
  lower order statistic of each tier where ``floor(N * interval) == 0``.
* Port-internal: the summary tier's replay gives the path tier's summaries
  (order statistics bit-equal, means within rtol 1e-6), the paths are
  genealogically consistent, and the forward pass's ll and ESS are
  ``bootstrap_filter``'s on the same generator and scheme.
* Statistical against JAX (different random streams): the ll within 4
  joint standard errors, and the smoothed intervals bridge a gap.
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
from composablestatespacemodels_torch.inference import interpolation as ti
from composablestatespacemodels_tpu.inference import interpolation as ji
from composablestatespacemodels_tpu.inference import resampling as jrs

from _torch_parity import both, drift_only_ou, jax_params_to_numpy
from _torch_parity import to_torch_series

SCHEMES = ["systematic", "stratified", "multinomial", "residual",
           "identity", "custom"]


def _custom(generator, weights):
    """A user's scheme: multinomial draws by ``torch.multinomial``."""
    return torch.multinomial(weights, weights.shape[0], replacement=True,
                             generator=generator)


def _scheme(name):
    return _custom if name == "custom" else name


def _gap_case(t_len=60, seed=0):
    """The JAX test's gap case (``tests/test_interpolation.py:19``): a
    linear OU model, its JAX simulation and the series with [40, 60]
    knocked out, in both packages."""
    jm = cj.linear(cj.ou_process(1))
    jp = cj.parameters(jnp.log(0.3), cj.ou_params(1.0, 0.5, 0.3, 1.0, 0.4))
    sim = cj.simulate_regular(jm, jp, jax.random.PRNGKey(seed), t_len,
                              dt=1.0)
    gappy = sim.to_timeseries().knock_out(40.0, 60.0)
    tm = ct.linear(ct.ou_process(1))
    tp = ct.params_from_numpy(jax_params_to_numpy(jp))
    return jm, jp, tm, tp, sim, gappy, to_torch_series(gappy.ts, gappy.ys,
                                                       gappy.mask)


@functools.lru_cache(maxsize=None)
def _flagship_gappy(t_len=40):
    """The flagship model, simulated by the port, [10, 20] knocked out."""
    _, _, tm, tp = both("flagship")
    data = ct.simulate_regular(tm, tp, torch.Generator().manual_seed(3),
                               t_len, dt=1.0).to_timeseries()
    return tm, tp, data.knock_out(10.0, 20.0)


# -- deterministic pieces ---------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_genealogy_from_counts_matches_jax_back_scan(seed, t_len=9, n=500):
    """Random monotone counts (heavy weights, so many particles die; some
    steps the identity counts of a missing observation): the port's
    searchsorted genealogy equals the JAX back-scan
    (``interpolation.py:117-121``) over the ancestors that
    ``_ancestors_from_counts`` gives for the same counts."""
    rng = np.random.default_rng(seed)
    counts = np.empty((t_len, n), np.int32)
    for k in range(t_len):
        if k % 4 == 2:
            counts[k] = np.arange(1, n + 1)
            continue
        w = rng.exponential(size=n) ** 3
        counts[k] = np.floor(np.cumsum(w) / w.sum() * n
                             + rng.uniform()).clip(0, n)
        counts[k, -1] = n
    anc = jax.vmap(lambda c: jrs._ancestors_from_counts(c, n))(
        jnp.asarray(counts))

    def back(j, a):
        p = a[j]
        return p, p

    _, want = jax.lax.scan(back, jnp.arange(n), anc, reverse=True)
    j = torch.arange(n, dtype=torch.int32)
    got = np.empty((t_len, n), np.int32)
    for k in reversed(range(t_len)):
        j = ti._parents(torch.from_numpy(counts[k]), j, True)
        got[k] = j.numpy()
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("store", ["path", "summary"])
@pytest.mark.parametrize("t_len,n,d", [(25, 64, 1), (1000, 280_000, 7),
                                       (1000, 2 ** 20, 7), (3, 5, 13)])
def test_memory_bytes_match_jax(t_len, n, d, store):
    assert (ti.interpolation_memory_bytes(t_len, n, d, store=store)
            == ji.interpolation_memory_bytes(t_len, n, d, store=store))


def test_edge_eta_lower_follows_jax_per_tier():
    """At N = 4, interval 0.2 (``floor(N * interval) == 0``) the JAX path
    tier clamps the eta lower index to the largest smoothed eta and its
    summary tier wraps it to the smallest; the port's tiers do the same."""
    n, interval = 4, 0.2
    jm, jp, tm, tp = both("oracle")
    data = cj.simulate_regular(jm, jp, jax.random.PRNGKey(1), 6,
                               dt=0.5).to_timeseries()
    key = jax.random.PRNGKey(2)
    jpath = ji.interpolation_filter(jm, jp, data, n, key, interval=interval)
    jsum = ji.interpolation_filter(jm, jp, data, n, key, interval=interval,
                                   store="summary")
    jeta = np.asarray(jax.vmap(lambda x, t: jm.link(jm.f(x, t)))(
        jpath.paths, data.ts))
    np.testing.assert_array_equal(np.asarray(jpath.eta_lower),
                                  jeta.max(axis=1))
    np.testing.assert_array_equal(np.asarray(jsum.eta_lower),
                                  jeta.min(axis=1))

    tdata = to_torch_series(data.ts, data.ys, data.mask)
    tpath = ct.interpolation_filter(tm, tp, tdata, n,
                                    torch.Generator().manual_seed(2),
                                    interval=interval)
    tsum = ct.interpolation_filter(tm, tp, tdata, n,
                                   torch.Generator().manual_seed(2),
                                   interval=interval, store="summary")
    teta = tm.link(tpath.paths[..., 0] * tm.design_vector(tdata.ts))
    assert torch.equal(tpath.eta_lower, teta.max(dim=1).values)
    assert torch.equal(tsum.eta_lower, teta.min(dim=1).values)
    assert torch.equal(tpath.eta_upper, tsum.eta_upper)
    assert torch.equal(tpath.state_lower, tsum.state_lower)


# -- port-internal ----------------------------------------------------------


def _summary_columns_agree(rp, rs):
    """The path tier's and the summary tier's results on one seed."""
    assert rs.paths is None
    for name in ("ll", "ess", "eta_lower", "eta_upper", "state_lower",
                 "state_upper"):
        assert torch.equal(getattr(rp, name), getattr(rs, name)), name
    for name in ("eta_mean", "state_mean"):
        torch.testing.assert_close(getattr(rs, name), getattr(rp, name),
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_summary_tier_replays_path_tier(scheme):
    tm, tp, data = _flagship_gappy()
    runs = [ti.interpolation_filter(tm, tp, data, 300,
                                    torch.Generator().manual_seed(11),
                                    resample=_scheme(scheme), store=store)
            for store in ("path", "summary")]
    _summary_columns_agree(*runs)


def test_summary_tier_replays_euler_maruyama():
    """An SDE without an exact transition: the replay redraws the
    Euler-Maruyama normals from the saved generator states."""
    model, params = drift_only_ou()
    data = ct.simulate_regular(model, params, torch.Generator().manual_seed(0),
                               30, dt=0.5).to_timeseries().knock_out(5., 9.)
    runs = [ti.interpolation_filter(model, params, data, 256,
                                    torch.Generator().manual_seed(4),
                                    store=store)
            for store in ("path", "summary")]
    _summary_columns_agree(*runs)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_ll_and_ess_equal_bootstrap_filter(scheme):
    tm, tp, data = _flagship_gappy()
    res = ti.interpolation_filter(tm, tp, data, 300,
                                  torch.Generator().manual_seed(21),
                                  resample=_scheme(scheme), store="summary")
    ref = ct.bootstrap_filter(tm, tp, data, 300,
                              torch.Generator().manual_seed(21),
                              resample=_scheme(scheme), store="ll")
    assert torch.equal(res.ll, ref.ll)
    assert torch.equal(res.ess, ref.ess)


def test_paths_are_genealogically_consistent():
    """As the JAX test (``tests/test_interpolation.py:71``): the smoothed
    cloud collapses toward the past.  Each lineage alive at step k + 1 has
    one parent at step k, so the distinct smoothed states never grow
    backward, from t = T down to t = 0."""
    model = ct.linear(ct.brownian_motion(1))
    params = ct.parameters(math.log(0.5), ct.brownian_params(0.0, 1.0, 0.2))
    data = ct.simulate_regular(model, params,
                               torch.Generator().manual_seed(42),
                               30).to_timeseries()
    res = ti.interpolation_filter(model, params, data, 200,
                                  torch.Generator().manual_seed(42))
    assert res.paths.shape == (30, 200, 1)
    distinct = [len(torch.unique(res.paths[k, :, 0])) for k in range(30)]
    assert distinct == sorted(distinct), distinct
    assert distinct[0] < distinct[-1]


def test_rejects_bad_store_and_scheme():
    tm, tp, data = _flagship_gappy(5)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="store must be"):
        ti.interpolation_filter(tm, tp, data, 8, gen, store="paths")
    with pytest.raises(ValueError, match="unknown resampling scheme"):
        ti.interpolation_filter(tm, tp, data, 8, gen, resample="sorted")


# -- statistical, against JAX -----------------------------------------------


RUNS, N_STAT = 8, 512


def _mean_se(values):
    return statistics.fmean(values), statistics.stdev(values) / math.sqrt(
        len(values))


def test_ll_matches_jax():
    jm, jp, tm, tp, _, gappy, data = _gap_case(40)
    j_lls = [float(ji.interpolation_filter(
        jm, jp, gappy, N_STAT, jax.random.PRNGKey(100 + r),
        store="summary").ll) for r in range(RUNS)]
    t_lls = [float(ti.interpolation_filter(
        tm, tp, data, N_STAT, torch.Generator().manual_seed(100 + r),
        store="summary").ll) for r in range(RUNS)]
    (mj, sj), (mt, st) = _mean_se(j_lls), _mean_se(t_lls)
    assert abs(mj - mt) <= 4 * math.hypot(sj, st), (j_lls, t_lls)


def test_interpolation_bridges_gap():
    """As the JAX test (``tests/test_interpolation.py:35``): the smoothed
    intervals in the gap hold the true state and are no wider than the
    filtered ones (within 10%)."""
    _, _, tm, tp, sim, gappy, data = _gap_case(100)
    res = ti.interpolation_filter(tm, tp, data, 2000,
                                  torch.Generator().manual_seed(42))
    gap = ~np.asarray(gappy.mask)
    truth = np.asarray(sim.xs[:, 0])
    lo = res.state_lower[:, 0].numpy()
    hi = res.state_upper[:, 0].numpy()
    assert ((lo <= truth) & (truth <= hi))[gap].mean() > 0.8
    filt = ct.bootstrap_filter(tm, tp, data, 2000,
                               torch.Generator().manual_seed(42),
                               store="summary")
    w_filt = (filt.summary.state_upper[:, 0]
              - filt.summary.state_lower[:, 0]).numpy()[gap].mean()
    assert (hi - lo)[gap].mean() < w_filt * 1.1
