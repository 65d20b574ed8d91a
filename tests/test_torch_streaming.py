"""The port's streaming tools and checkpoints
(``composablestatespacemodels_torch.utils.streaming`` / ``checkpoint``)
against the JAX package's, the Kalman oracle and themselves.

Tolerances: the chunked filters' mean ll within 4 standard errors of
Kalman (8 runs each); the monitored chain resumed from a checkpoint equal
to the uninterrupted chain bit for bit; checkpoints and the stream
helpers exact.
"""

from __future__ import annotations

import io as pyio
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import composablestatespacemodels_torch as ct
import composablestatespacemodels_tpu as cj
from composablestatespacemodels_torch.models import perturb, tree_map
from composablestatespacemodels_torch.utils import checkpoint as tck
from composablestatespacemodels_torch.utils import streaming as tst
from composablestatespacemodels_tpu.utils import checkpoint as jck
from composablestatespacemodels_tpu.utils import streaming as jst

from _torch_parity import both, to_torch_series

T_ORACLE, CHUNK, N_ORACLE, RUNS = 40, 10, 512, 8


@pytest.fixture(scope="module")
def oracle_case():
    jm, jp, tm, tp = both("oracle")
    sim = cj.simulate_regular(jm, jp, jax.random.PRNGKey(3), T_ORACLE)
    ts, ys = np.asarray(sim.ts), np.asarray(sim.ys)
    mask = np.ones(T_ORACLE, bool)
    mask[[5, 17, 18]] = False
    jdata = cj.TimeSeries(jnp.asarray(ts), jnp.asarray(np.where(mask, ys, 0)),
                          jnp.asarray(mask))
    tdata = to_torch_series(ts, np.where(mask, ys, 0), mask)
    kf = float(ct.kalman_filter(tm, tp, tdata).ll)
    assert abs(kf - float(cj.kalman_filter(jm, jp, jdata).ll)) < 1e-3
    return jm, jp, jdata, tm, tp, tdata, kf


def _chunks(data, step):
    return [type(data)(data.ts[i:i + step], data.ys[i:i + step],
                       data.mask[i:i + step])
            for i in range(0, len(data), step)]


def _within(lls, ref, what):
    mean = float(np.mean(lls))
    se = float(np.std(lls, ddof=1)) / math.sqrt(len(lls))
    assert abs(mean - ref) <= 4 * se, (what, mean, se, ref)


@pytest.mark.parametrize("store", ["summary", "ll"])
def test_online_filter_oracle_matches_kalman(oracle_case, store):
    _, _, _, tm, tp, tdata, kf = oracle_case
    lls = []
    for r in range(RUNS):
        f = tst.OnlineFilter(tm, tp, N_ORACLE,
                             torch.Generator().manual_seed(r),
                             t0=float(tdata.ts[0]), store=store)
        for chunk in _chunks(tdata, CHUNK):
            res = f.step(chunk)
            if store == "summary":
                assert res.summary.ts.shape == (CHUNK,)
        assert f.n_observed == T_ORACLE
        lls.append(float(f.ll))
    _within(lls, kf, "port OnlineFilter")


def test_jax_online_filter_oracle_matches_kalman(oracle_case):
    jm, jp, jdata, _, _, _, kf = oracle_case
    lls = []
    for r in range(RUNS):
        f = jst.OnlineFilter(jm, jp, N_ORACLE, jax.random.PRNGKey(r),
                             t0=float(jdata.ts[0]), store="ll")
        for chunk in _chunks(jdata, CHUNK):
            f.step(chunk)
        lls.append(float(f.ll))
    _within(lls, kf, "JAX OnlineFilter")


def test_online_filter_one_chunk_is_bootstrap_filter(oracle_case):
    """One chunk from the first observation time is one filter call: the
    same draws, bit for bit."""
    _, _, _, tm, tp, tdata, _ = oracle_case
    f = tst.OnlineFilter(tm, tp, 64, torch.Generator().manual_seed(9),
                         t0=float(tdata.ts[0]))
    res = f.step(tdata)
    ref = ct.bootstrap_filter(tm, tp, tdata, 64,
                              torch.Generator().manual_seed(9))
    assert float(f.ll) == float(ref.ll)
    assert torch.equal(res.final_particles, ref.final_particles)
    assert float(f.t) == float(tdata.ts[-1])


def test_online_filter_mesh_not_ported(oracle_case):
    """``OnlineFilter(mesh=)`` is ported: on a world of one rank (gloo, in
    this process) its chunks are the sharded filter's calls, the carried
    cloud a sharded ``DTensor``."""
    import torch.distributed as dist
    from composablestatespacemodels_torch.parallel import (
        initialize_distributed, particle_mesh, sharded_bootstrap_filter)
    _, _, _, tm, tp, tdata, _ = oracle_case
    initialize_distributed("cpu", timeout=60)
    try:
        mesh = particle_mesh("cpu")
        f = tst.OnlineFilter(tm, tp, 64, torch.Generator().manual_seed(9),
                             t0=float(tdata.ts[0]), store="ll", mesh=mesh)
        res = f.step(tdata)
        ref = sharded_bootstrap_filter(tm, tp, tdata, 64,
                                       torch.Generator().manual_seed(9), mesh,
                                       t0=float(tdata.ts[0]), store="ll")
        assert float(f.ll) == float(ref.ll)
        assert type(f.particles).__name__ == "DTensor"
        assert torch.equal(res.final_particles.to_local(),
                           ref.final_particles.to_local())
    finally:
        dist.destroy_process_group()


# -- monitored PMMH: exact resume ---------------------------------------------


@pytest.mark.parametrize("store_state", [False, True])
def test_pmmh_monitored_resume_is_bit_exact(oracle_case, tmp_path,
                                            store_state):
    """3 chunks with a checkpoint, then a second call resumes to 4 chunks;
    the result equals one uninterrupted 4-chunk run bit for bit."""
    _, _, _, tm, tp, tdata, _ = oracle_case
    data = tdata.take(20)
    pf_ll = ct.make_pf_loglik(tm, data, 32, store_state=store_state)
    prop = perturb(0.05)
    path = str(tmp_path / "chain.npz")

    def run(n_iters, checkpoint_path, out=None):
        return tst.pmmh_monitored(
            torch.Generator().manual_seed(5), tp, pf_ll, prop, n_iters,
            chunk_size=5, store_state=store_state,
            checkpoint_path=checkpoint_path, out=out)

    first = run(15, path)
    log = pyio.StringIO()
    resumed = run(20, path, out=log)
    full = run(20, None)
    assert "resumed from" in log.getvalue() and "at chunk 3/4" in \
        log.getvalue()
    assert "[pmmh] iter 20/20  acceptance" in log.getvalue()
    for a, b in ((resumed, full), (first, tree_map(lambda x: x[:15], full))):
        assert torch.equal(a.lls, b.lls)
        assert torch.equal(a.accepted, b.accepted)
        assert torch.equal(ct.models.stack_flat(a.params),
                           ct.models.stack_flat(b.params))
        if store_state:
            assert a.states.shape == (a.lls.shape[0], tm.dim)
            assert torch.equal(a.states, b.states)
        else:
            assert a.states is None


def test_pmmh_monitored_log_lines_match_jax_format():
    """The same ``[pmmh] iter`` progress lines as the JAX package."""
    out = pyio.StringIO()
    model = ct.linear(ct.brownian_motion(1))
    params = ct.parameters(math.log(0.5), ct.brownian_params(0.0, 1.0, 0.4))
    data = ct.simulate_regular(model, params, torch.Generator().manual_seed(1),
                               8).to_timeseries()
    res = tst.pmmh_monitored(torch.Generator().manual_seed(2), params,
                             ct.make_pf_loglik(model, data, 16), perturb(0.1),
                             7, chunk_size=3, out=out)
    lines = out.getvalue().splitlines()
    assert [ln.split("  ")[0] for ln in lines] == [
        "[pmmh] iter 3/7", "[pmmh] iter 6/7", "[pmmh] iter 7/7"]
    acc = int(res.accepted[-1])
    assert lines[-1].split("  ")[1] == f"acceptance {acc / 7:.3f}"


# -- checkpoints --------------------------------------------------------------


def test_checkpoint_round_trip_and_validation(tmp_path):
    path = str(tmp_path / "ck.npz")
    params = ct.parameters(0.3, ct.ou_params(0.5, 0.2, 0.3, 0.1, 0.4))
    state = {"params": params, "ll": torch.tensor(-12.5),
             "n": torch.tensor(7, dtype=torch.int32),
             "x": (torch.arange(6.0).reshape(2, 3), None, ()),
             "seed": np.int64(2 ** 62 + 5)}
    tck.save_checkpoint(path, state)
    back = tck.restore_checkpoint(path, state)
    for a, b in zip(tck.tree_leaves(state), tck.tree_leaves(back)):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert int(back["seed"]) == 2 ** 62 + 5
    assert back["x"][1] is None and back["x"][2] == ()
    assert isinstance(back["params"], ct.models.Leaf)
    bad_shape = dict(state, ll=torch.zeros(2))
    with pytest.raises(ValueError, match="shape"):
        tck.restore_checkpoint(path, bad_shape)
    bad_dtype = dict(state, n=torch.tensor(7, dtype=torch.int64))
    with pytest.raises(ValueError, match="dtype"):
        tck.restore_checkpoint(path, bad_dtype)
    assert open(path + ".tree").read().startswith("{'ll': *")


def test_params_checkpoint_crosses_packages(tmp_path):
    """A params-only checkpoint written by either package restores in the
    other to the same values (the same leaf order); the ``.tree`` side
    files differ (JAX writes its PyTreeDef)."""
    jm, jp, tm, tp = both("flagship")
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    rng = np.random.default_rng(0)
    jp = jax.tree_util.tree_map(
        lambda x: x + jnp.asarray(rng.normal(size=x.shape), x.dtype), jp)
    jck.save_checkpoint(jpath, {"params": jp, "ll": jnp.float32(-3.0)})
    got = tck.restore_checkpoint(jpath, {"params": tp,
                                         "ll": torch.tensor(0.0)})
    np.testing.assert_array_equal(
        ct.models.flatten_params(got["params"]).numpy(),
        np.asarray(cj.models.params.flatten_params(jp)))
    tck.save_checkpoint(tpath, got)
    back = jck.restore_checkpoint(tpath, {"params": jp,
                                          "ll": jnp.float32(0.0)})
    np.testing.assert_array_equal(
        np.asarray(cj.models.params.flatten_params(back["params"])),
        np.asarray(cj.models.params.flatten_params(jp)))
    assert float(back["ll"]) == -3.0
    assert [np.asarray(x).shape for x in jax.tree_util.tree_leaves(jp)] == \
        [tuple(x.shape) for x in tck.tree_leaves(tp)]


# -- stream helpers -----------------------------------------------------------


def test_stream_helpers_match_jax():
    rng = np.random.default_rng(4)
    vals = rng.normal(1.0, 2.0, 200).astype(np.float32)
    for fn_j, fn_t in ((jst.ascii_histogram, tst.ascii_histogram),):
        oj, ot = pyio.StringIO(), pyio.StringIO()
        fn_j(jnp.asarray(vals), bins=12, width=30, out=oj)
        fn_t(torch.tensor(vals), bins=12, width=30, out=ot)
        assert oj.getvalue() == ot.getvalue()
    for xs in (vals, np.abs(vals) + 1.0):
        assert jst.min_sink(jnp.asarray(xs)) == tst.min_sink(torch.tensor(xs))
    assert tst.min_sink([3.0, 2.0]) == 0.0     # the reference's 0.0 seed
    recs = [(i, i // 3) for i in range(1, 251)]
    oj, ot = pyio.StringIO(), pyio.StringIO()
    assert list(jst.monitor_stream(recs, every=50, out=oj)) == \
        list(tst.monitor_stream(recs, every=50, out=ot)) == recs
    assert oj.getvalue() == ot.getvalue() != ""

    jm, jp, tm, tp = both("flagship")
    stacked_j = jax.tree_util.tree_map(
        lambda x: jnp.stack([x + 0.1 * i for i in range(11)]), jp)
    stacked_t = tree_map(lambda x: torch.stack([x + 0.1 * i
                                                for i in range(11)]), tp)
    for window in (1, 3, 11):
        np.testing.assert_allclose(
            ct.models.stack_flat(tst.windowed_mean_params(stacked_t,
                                                          window)).numpy(),
            np.asarray(cj.models.params.stack_flat(
                jst.windowed_mean_params(stacked_j, window))),
            rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        ct.models.stack_flat(tst.thin_stream(stacked_t, 4)).numpy(),
        np.asarray(cj.models.params.stack_flat(
            jst.thin_stream(stacked_j, 4))))
