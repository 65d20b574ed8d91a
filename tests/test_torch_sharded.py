"""The port's particle-sharded filter (``parallel/sharded_filter.py``)
against the JAX package's, in gloo worlds of 2 and 4 ranks on the CPU.

The JAX side runs in this process under ``shard_map`` on the virtual CPU
devices of ``conftest.py``; the port's side runs in one world per shard
count (``_torch_dist.run_world``), every case in it.  Bit for bit, on the
same per-shard weights and the uniform ``u = jax.random.uniform(key)``:
the window counts and ``c_prev``, both distributed resamplers (the plain
fill and K4's plain version), the all-gather route, the degenerate
multi-hop cases and the identity at uniform weights (as
``tests/test_sharded.py``), the sharded order statistics, and the
weighted pick and summary.  Exact in both packages wherever every sum
is exact: weights that are small integers (the dyadic cases: a
power-of-two total).  The float weights at 2 shards add in different
orders in the two packages (the port's one-prefix order, JAX's
``associative_scan``), so they are held equal on a seed whose counts no
ulp moves.  Statistically: the sharded ll within 4 se of Kalman and within
4 joint se of the JAX sharded ll (8 seeds each), under the systematic and
the fused route.  Every rank ends each route with the same ll bits and the
same generator state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import PartitionSpec as P

import composablestatespacemodels_tpu as cj
from composablestatespacemodels_tpu.ops.selection import kth_smallest_bits
from composablestatespacemodels_tpu.parallel import (PARTICLE_AXIS,
                                                     make_mesh,
                                                     sharded_log_likelihood)
from composablestatespacemodels_tpu.parallel import sharded_filter as jsf

from _torch_dist import run_world

N_LOCAL, D = 32, 3
INTERVAL = 0.9
SEEDS = list(range(8))
N_FILTER, T_FILTER = 256, 30
AX = PARTICLE_AXIS


def _case_weights(name, n, rng):
    """The weights of a case: small integers (exact sums in any order),
    with a power-of-two total for ``dyadic``; lognormal floats; one or two
    owners; uniform."""
    if name in ("dyadic", "randint"):
        k = rng.integers(0, 8, n).astype(np.int64)
        if name == "dyadic":
            k[-1] += 2 ** int(np.ceil(np.log2(k.sum() + 8))) - k.sum()
        return k.astype(np.float32)
    if name == "float":
        return np.exp(rng.normal(size=n)).astype(np.float32)
    w = np.zeros(n, np.float32)
    if name == "first_owner":
        w[0] = 1.0
    elif name == "last_owner":
        w[n - 1] = 1.0
    elif name == "mid_owner":
        w[n // 2 + 3] = 1.0
    elif name == "two_owners":
        w[3] = w[n - 7] = 0.5
    else:
        w[:] = 1.0 / n
    return w


def _cases(n_shards):
    names = ["dyadic", "randint", "first_owner", "last_owner", "mid_owner",
             "two_owners", "uniform"] + (["float"] if n_shards == 2 else [])
    n = N_LOCAL * n_shards
    rng = np.random.default_rng(100 + n_shards)
    inputs, keys = {"cases": np.array(names), "n": np.array(n),
                    "interval": np.array(INTERVAL)}, {}
    for i, name in enumerate(names):
        key = jax.random.PRNGKey(1000 * n_shards + i)
        keys[name] = key
        inputs[f"{name}/w"] = _case_weights(name, n, rng)
        inputs[f"{name}/x"] = rng.normal(size=(n, D)).astype(np.float32)
        inputs[f"{name}/u"] = np.asarray(
            jax.random.uniform(key, (), jnp.float32))
    c = 2
    inputs["vals"] = (rng.normal(size=(c, n)) * 10).astype(np.float32)
    inputs["ks"] = rng.integers(0, n, (c, 2)).astype(np.int32)
    inputs["wn"] = (rng.integers(1, 8, n) / 64.0).astype(np.float32)
    inputs["cols"] = rng.normal(size=(2, n)).astype(np.float32)
    inputs["mean"] = rng.normal(size=(1,)).astype(np.float32)
    kpick = jax.random.PRNGKey(77 + n_shards)
    inputs["u_pick"] = np.asarray(jax.random.uniform(kpick, (), jnp.float32))
    inputs["edge_x"] = rng.integers(-8, 8, (D, n)).astype(np.float32)
    inputs["edge_interval"] = np.array(0.5 / n)
    return inputs, keys, kpick


def _jax_resample(n_shards):
    mesh = make_mesh(1, n_shards, devices=jax.devices()[:n_shards])

    def body(w, x, key):
        counts, c_prev = jsf._systematic_window_counts(w, key, AX)
        return (counts, c_prev[None],
                jsf.distributed_systematic_resample(x, w, key, AX),
                jsf.distributed_systematic_resample_t(x.T, w, key, AX,
                                                      pallas_fill=False),
                jsf._all_gather_systematic_resample(x, w, key, AX))

    return jax.jit(shard_map(body, mesh=mesh, in_specs=(P(AX), P(AX), P()),
                             out_specs=(P(AX), P(AX), P(AX), P(None, AX),
                                        P(AX)), check_vma=False))


def _jax_selection(n_shards, n):
    mesh = make_mesh(1, n_shards, devices=jax.devices()[:n_shards])
    model = cj.linear(cj.brownian_motion(1))

    def body(vals, ks, wn, cols, mean, kpick):
        kth = jsf._kth_smallest_sharded(vals, ks, AX)
        pick = jsf._sharded_weighted_pick(wn, kpick, AX, n // n_shards, n)
        summary = jsf._sharded_weighted_summary(model, cols, wn, mean, 0.0,
                                                INTERVAL, n, AX)
        return kth, pick, summary

    return jax.jit(shard_map(
        body, mesh=mesh,
        in_specs=(P(None, AX), P(), P(AX), P(None, AX), P(), P()),
        out_specs=(P(), P(), (P(),) * 6), check_vma=False))


def _oracle_data():
    model = cj.linear(cj.brownian_motion(1))
    params = cj.parameters(np.log(0.5), cj.brownian_params(0.0, 1.0, 0.4))
    sim = cj.simulate_regular(model, params, jax.random.PRNGKey(3), T_FILTER,
                              dt=1.0)
    return model, params, sim.to_timeseries()


@pytest.fixture(scope="module", params=[2, 4], ids=["2shards", "4shards"])
def resample_world(request, tmp_path_factory):
    s = request.param
    inputs, keys, kpick = _cases(s)
    n = int(inputs["n"])
    ranks = run_world("resample", s, inputs, tmp_path_factory.mktemp("w"))
    fn = _jax_resample(s)
    want = {}
    for name, key in keys.items():
        out = fn(jnp.asarray(inputs[f"{name}/w"]),
                 jnp.asarray(inputs[f"{name}/x"]), key)
        want[name] = [np.asarray(o) for o in out]
    sel = _jax_selection(s, n)(*(jnp.asarray(inputs[k]) for k in (
        "vals", "ks", "wn", "cols", "mean")), kpick)
    return s, inputs, ranks, want, sel


def _assembled(ranks, key, axis=0):
    return np.concatenate([r[key] for r in ranks], axis=axis)


def test_window_counts_and_c_prev_bit_equal(resample_world):
    s, inputs, ranks, want, _ = resample_world
    for name in inputs["cases"]:
        counts, c_prev = want[name][:2]
        np.testing.assert_array_equal(
            _assembled(ranks, f"{name}/counts"), counts, err_msg=name)
        np.testing.assert_array_equal(
            np.array([r[f"{name}/c_prev"] for r in ranks]), c_prev,
            err_msg=name)


@pytest.mark.parametrize("fill", ["plain", "k4"])
def test_distributed_resample_bit_equal(resample_world, fill):
    """Both fills against both JAX resamplers ([N, d] rows and the plain
    [d, N] fill), on every case, multi-hop ones included."""
    s, inputs, ranks, want, _ = resample_world
    for name in inputs["cases"]:
        got = _assembled(ranks, f"{name}/{fill}", axis=1)        # [d, N]
        np.testing.assert_array_equal(got.T, want[name][2], err_msg=name)
        np.testing.assert_array_equal(got, want[name][3], err_msg=name)


def test_allgather_route_bit_equal(resample_world):
    s, inputs, ranks, want, _ = resample_world
    for name in inputs["cases"]:
        got = _assembled(ranks, f"{name}/allgather", axis=1)
        np.testing.assert_array_equal(got.T, want[name][4], err_msg=name)


def test_uniform_weights_identity_and_single_owner(resample_world):
    s, inputs, ranks, _, _ = resample_world
    x = inputs["uniform/x"]
    np.testing.assert_array_equal(_assembled(ranks, "uniform/k4", 1).T, x)
    for name in ("first_owner", "last_owner", "mid_owner"):
        w, x = inputs[f"{name}/w"], inputs[f"{name}/x"]
        got = _assembled(ranks, f"{name}/k4", 1).T
        np.testing.assert_array_equal(got, np.repeat(x[[np.argmax(w)]],
                                                     len(w), axis=0))


def test_public_resample_draws_its_uniform_alike(resample_world):
    _, _, ranks, _, _ = resample_world
    for r in ranks:
        assert r["public_equal"] and r["gen_agree"]


def test_kth_smallest_sharded_bit_equal(resample_world):
    s, inputs, ranks, _, sel = resample_world
    srt = np.sort(inputs["vals"], axis=1)
    want = np.take_along_axis(srt, inputs["ks"], axis=1)
    unsharded = np.asarray(kth_smallest_bits(
        jnp.asarray(inputs["vals"]), jnp.asarray(inputs["ks"])))
    for r in ranks:
        np.testing.assert_array_equal(r["kth"], want)
        np.testing.assert_array_equal(r["kth"], np.asarray(sel[0]))
        np.testing.assert_array_equal(r["kth"], unsharded)


def test_weighted_pick_and_summary_bit_equal(resample_world):
    """On weights that are multiples of 1/64 every mass sum is exact, so
    the pick and the weighted quantiles agree at 4 shards too."""
    s, inputs, ranks, _, sel = resample_world
    for r in ranks:
        assert int(r["pick"]) == int(sel[1])
        for i in range(6):
            np.testing.assert_array_equal(r[f"summary/{i}"],
                                          np.asarray(sel[2][i]), str(i))


def test_unweighted_summary_at_edge_interval(resample_world):
    """At ``floor(N * interval) == 0`` the JAX sharded route asks for k = -1
    and k = N, where its bisection gives NaN; the port wraps both indices,
    and its sharded summary is the single-device transposed route's, bit
    for bit (small-integer states: every sum exact)."""
    got = np.asarray(kth_smallest_bits(jnp.asarray([[3.0, 1.0, 2.0, 5.0]]),
                                       jnp.asarray([[-1, 4, 0, 3]])))
    assert np.isnan(got[0, :2]).all()
    np.testing.assert_array_equal(got[0, 2:], [1.0, 5.0])

    import torch

    import composablestatespacemodels_torch as ct
    from composablestatespacemodels_torch.inference.filter import \
        _make_save_fn_t

    s, inputs, ranks, _, _ = resample_world
    x, interval, n = inputs["edge_x"], float(inputs["edge_interval"]), int(
        inputs["n"])
    assert np.floor(n * interval) == 0
    model = ct.linear(ct.brownian_motion(x.shape[0]))
    want = _make_save_fn_t(model, "summary", interval, False,
                           torch.Generator(), 1, n)(
        0, 0.0, model.design_vector(0.0), torch.from_numpy(x), None)
    for r in ranks:
        for i, w in enumerate(want):
            assert np.isfinite(r[f"edge/{i}"]).all()
            np.testing.assert_array_equal(r[f"edge/{i}"], w.numpy(), str(i))


# ---------------------------------------------------------------------------
# the sharded filter at 2 shards
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def filter_world(tmp_path_factory):
    model, params, data = _oracle_data()
    inputs = {"ts": np.asarray(data.ts), "ys": np.asarray(data.ys),
              "mask": np.asarray(data.mask), "n": np.array(N_FILTER),
              "seeds": np.array(SEEDS)}
    ranks = run_world("filter", 2, inputs, tmp_path_factory.mktemp("f"))
    mesh = make_mesh(1, 2, devices=jax.devices()[:2])
    jax_lls = np.array([float(sharded_log_likelihood(
        model, params, data, N_FILTER, jax.random.PRNGKey(50 + s), mesh)[0])
        for s in SEEDS])
    kf = float(cj.kalman_filter(model, params, data).ll)
    return ranks, jax_lls, kf


def _se(v):
    return np.std(v, ddof=1) / np.sqrt(len(v))


@pytest.mark.parametrize("scheme", ["systematic", "systematic-pallas-fused"])
def test_sharded_ll_against_kalman_and_jax(filter_world, scheme):
    ranks, jax_lls, kf = filter_world
    lls = ranks[0][f"{scheme}/ll"]
    assert np.isfinite(lls).all()
    assert abs(lls.mean() - kf) <= 4 * _se(lls), (lls.mean(), kf)
    assert abs(jax_lls.mean() - kf) <= 4 * _se(jax_lls)
    joint = np.sqrt(_se(lls) ** 2 + _se(jax_lls) ** 2)
    assert abs(lls.mean() - jax_lls.mean()) <= 4 * joint


def test_every_rank_same_ll_bits_and_generator(filter_world):
    ranks = filter_world[0]
    for key in ranks[0]:
        if key.endswith(("/ll", "/ess", "/path")) or "/eta" in key or \
                "/state" in key:
            np.testing.assert_array_equal(ranks[1][key], ranks[0][key], key)
    assert all(r["gen_agree"] for r in ranks)


def test_ess_and_final_particles(filter_world):
    ranks = filter_world[0]
    for r in ranks:
        for key in r:
            if key.endswith("/ess"):
                assert ((r[key] >= 1) & (r[key] <= N_FILTER)).all(), key
        assert tuple(r["systematic/final_shape"]) == (N_FILTER, 1)
        assert r["systematic/final_local"].shape == (N_FILTER // 2, 1)
    assert not np.array_equal(ranks[0]["systematic/final_local"],
                              ranks[1]["systematic/final_local"])


@pytest.mark.parametrize("tag", ["summary", "weighted"])
def test_summaries_ordered(filter_world, tag):
    r = filter_world[0][0]
    assert r[f"{tag}/state_mean"].shape == (T_FILTER, 1)
    assert (r[f"{tag}/state_lower"] <= r[f"{tag}/state_upper"]).all()
    assert (r[f"{tag}/eta_lower"] <= r[f"{tag}/eta_upper"]).all()
    assert np.isfinite(r[f"{tag}/ll"])


def test_paths_ess_trigger_and_allgather(filter_world):
    r = filter_world[0][0]
    for tag in ("path", "path_weighted"):
        assert r[f"{tag}/path"].shape == (T_FILTER, 1)
        assert np.isfinite(r[f"{tag}/path"]).all()
    # the trigger skips resamples: the ESS falls below N somewhere and the
    # weighted save keeps its order
    assert (r["weighted/ess"] < N_FILTER).any()
    assert np.isfinite(r["allgather/ll"])


def test_k5_seeds_differ_between_shards_and_repeat(filter_world):
    r0, r1 = (r["k5_seeds"] for r in filter_world[0])
    np.testing.assert_array_equal(r0[0], r0[1])
    np.testing.assert_array_equal(r1[0], r1[1])
    assert not np.isin(r0[0], r1[0]).any()
    assert len(set(r0[0].tolist())) == r0.shape[1]


def test_errors_raise_on_every_rank(filter_world):
    for r in filter_world[0]:
        not_divisible, scheme, comm = r["errors"]
        assert "not divisible by 2 shards" in not_divisible
        assert "requires resample='systematic'" in scheme
        assert "resample_comm" in comm
