"""The port's IO (``composablestatespacemodels_torch.utils.io``, ``native``
and the rest of ``utils/data.py``) against the JAX package's.

The file formats are the contract: for the same numpy-made values each
writer of the port writes the JAX writer's bytes, on the native tier and
on the pure-Python one, and each package's reader reads the other's file
to the same values (bit for bit: the values are float32 in both).  The
``.tree`` side file of a checkpoint is the one exception
(``test_torch_streaming.py``).  Two faults of the JAX package's native
CSV tier are repaired in the port's copy; the tests below show both.
"""

from __future__ import annotations

import json
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import composablestatespacemodels_torch as ct
from composablestatespacemodels_torch import native as tnative
from composablestatespacemodels_torch.inference.filter import (FilterResult,
                                                                Forecast,
                                                                PfSummary)
from composablestatespacemodels_torch.inference.pmmh import (
    PmmhResult as TPmmhResult)
from composablestatespacemodels_torch.utils import data as tdata
from composablestatespacemodels_torch.utils import io as tio
from composablestatespacemodels_tpu import native as jnative
from composablestatespacemodels_tpu.inference.pmmh import (
    PmmhResult as JPmmhResult)
from composablestatespacemodels_tpu.models import params as jparams
from composablestatespacemodels_tpu.models import tree as jtree
from composablestatespacemodels_tpu.utils import data as jdata
from composablestatespacemodels_tpu.utils import io as jio

ROOT = Path(__file__).resolve().parent.parent
F32 = np.float32


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _eq(a, b):
    np.testing.assert_array_equal(_np(a), _np(b))


def _series_eq(a, b):
    for f in ("ts", "ys", "mask"):
        _eq(getattr(a, f), getattr(b, f))


@pytest.fixture(params=["native", "python"])
def tier(request, monkeypatch):
    """Run each test on the native tier of both packages, then on their
    pure-Python fallbacks (both native tiers switched off)."""
    if request.param == "native":
        assert tnative.available() and jnative.available()
    else:
        for mod in (tnative.loader, jnative.loader):
            monkeypatch.setattr(mod, "_lib", None)
            monkeypatch.setattr(mod, "_tried", True)
    return request.param


def _series(rng, n=25):
    ts = np.cumsum(rng.uniform(0.05, 2.0, n))
    ys = rng.normal(3.0, 2.0, n)
    ys[rng.uniform(size=n) < 0.3] = np.nan
    return ts, ys


def _both_series(rng, n=25):
    ts, ys = _series(rng, n)
    return (jdata.TimeSeries.from_arrays(ts, ys),
            tdata.TimeSeries.from_arrays(ts, ys, device="cpu"))


def _write_both(tmp_path, name, jwrite, twrite):
    jp, tp = tmp_path / f"jax_{name}", tmp_path / f"torch_{name}"
    jwrite(str(jp))
    twrite(str(tp))
    assert jp.read_bytes() == tp.read_bytes()
    return str(jp), str(tp)


# -- time series --------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 25])
def test_from_arrays_thin_take_equal_jax(n):
    """Bit for bit (float32 in both): NaN and None become missing."""
    rng = np.random.default_rng(n)
    ts, ys = _series(rng, n)
    ys_obj = [None if np.isnan(y) else y for y in ys]
    for vals in (ys, ys_obj, None):
        js = jdata.TimeSeries.from_arrays(ts, vals)
        tseries = tdata.TimeSeries.from_arrays(ts, vals, device="cpu")
        _series_eq(js, tseries)
        _series_eq(js.thin(3), tseries.thin(3))
        _series_eq(js.take(4), tseries.take(4))
    assert tseries.to("cpu").ts.device.type == "cpu"


def test_timestamps_equal_jax():
    stamps = np.datetime64("2024-03-01T00:00") + np.arange(0, 50, 7) \
        * np.timedelta64(90, "m")
    ys = [1.0, None, 2.5, np.nan, 4.0, 0.5, 7.0, 1.0]
    for unit, epoch in (("h", None), ("D", "2024-02-28"), ("s", None)):
        js, je = jdata.timeseries_from_timestamps(stamps, ys, unit, epoch)
        tseries, te = tdata.timeseries_from_timestamps(stamps, ys, unit,
                                                       epoch, device="cpu")
        assert je == te
        _series_eq(js, tseries)
        _eq(jdata.timestamps_of(js.ts, je, unit),
            tdata.timestamps_of(tseries.ts, te, unit))


def test_readers_default_to_cuda(tmp_path):
    """No silent CPU fallback: without a card the default device raises."""
    p = str(tmp_path / "s.csv")
    tio.write_timeseries_csv(p, _both_series(np.random.default_rng(0))[1])
    if torch.cuda.is_available():
        assert tio.read_timeseries_csv(p).ts.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            tio.read_timeseries_csv(p)


@pytest.mark.parametrize("fmt", ["csv", "json"])
def test_timeseries_files_cross_packages(tmp_path, tier, fmt):
    js, tseries = _both_series(np.random.default_rng(1))
    jw, tw = {"csv": (jio.write_timeseries_csv, tio.write_timeseries_csv),
              "json": (jio.write_timeseries_json,
                       tio.write_timeseries_json)}[fmt]
    jr, tr = {"csv": (jio.read_timeseries_csv, tio.read_timeseries_csv),
              "json": (jio.read_timeseries_json,
                       tio.read_timeseries_json)}[fmt]
    jp, tp = _write_both(tmp_path, fmt, lambda p: jw(p, js),
                         lambda p: tw(p, tseries))
    _series_eq(jr(tp), tr(jp, device="cpu"))
    _series_eq(tr(tp, device="cpu"), tseries)


def test_timestamped_json_cross_packages(tmp_path):
    stamps = np.datetime64("2023-12-31T22:00") + np.arange(12) \
        * np.timedelta64(45, "m")
    ys = [None if i % 4 == 1 else 0.25 * i for i in range(12)]
    js, epoch = jdata.timeseries_from_timestamps(stamps, ys)
    tseries, _ = tdata.timeseries_from_timestamps(stamps, ys, device="cpu")
    jp, tp = _write_both(
        tmp_path, "stamped.json",
        lambda p: jio.write_timestamped_json(p, js, epoch),
        lambda p: tio.write_timestamped_json(p, tseries, epoch))
    (js2, je), (ts2, te) = (jio.read_timestamped_json(tp),
                            tio.read_timestamped_json(jp, device="cpu"))
    assert je == te
    _series_eq(js2, ts2)


def test_simulated_csv_bytes(tmp_path):
    rng = np.random.default_rng(2)
    cols = [rng.normal(size=9).astype(F32) for _ in range(4)]
    xs = rng.normal(size=(9, 3)).astype(F32)
    jsim = jdata.SimulatedData(*map(jnp.asarray, cols), jnp.asarray(xs))
    tsim = tdata.SimulatedData(*map(torch.tensor, cols), torch.tensor(xs))
    _write_both(tmp_path, "sim.csv",
                lambda p: jio.write_simulated_csv(p, jsim),
                lambda p: tio.write_simulated_csv(p, tsim))


# -- the native tier ----------------------------------------------------------


def test_native_and_python_parsers_agree_on_na_and_blank_lines(tmp_path,
                                                               monkeypatch):
    """The port's two tiers, bit for bit, on NA and empty fields, blank,
    whitespace-only and CRLF lines and spaces around fields."""
    p = tmp_path / "na.csv"
    p.write_text("0.0,1.5\n\n1.0,NA\n2.0,\n   \n3.0,4.0\r\n4.5 , 2.25\n"
                 "\t\n5.0,\r\n  6.0,-1e-3\n7.0\n")
    native = tio.read_timeseries_csv(str(p), device="cpu")
    monkeypatch.setattr(tnative.loader, "_lib", None)
    monkeypatch.setattr(tnative.loader, "_tried", True)
    python = tio.read_timeseries_csv(str(p), device="cpu")
    _series_eq(native, python)
    _eq(native.ts, np.asarray([0, 1, 2, 3, 4.5, 5, 6, 7], F32))
    _eq(native.mask, [1, 0, 0, 1, 1, 0, 1, 0])


def test_jax_native_csv_faults_repaired_in_port(tmp_path):
    """Two faults of the JAX package's native CSV parser against its own
    Python parser, repaired in the port (ROADMAP Queue 3): a
    whitespace-only line became a missing observation at the next line's
    time, and a ``nan`` field a present NaN observation."""
    p = tmp_path / "faults.csv"
    p.write_text("0.0,1.5\n   \n1.0,2.0\n2.0,nan\n3.0,NaN\n")
    ts, ys, mask = jnative.parse_timeseries_csv(str(p))
    np.testing.assert_array_equal(ts, [0.0, 1.0, 1.0, 2.0, 3.0])
    js = jio.read_timeseries_csv(str(p))
    assert bool(np.isnan(np.asarray(js.ys)).any())
    tseries = tio.read_timeseries_csv(str(p), device="cpu")
    _eq(tseries.ts, np.asarray([0, 1, 2, 3], F32))
    _eq(tseries.mask, [True, True, False, False])
    _eq(tseries.ys, np.asarray([1.5, 2.0, 0, 0], F32))


def test_native_source_is_the_ports_own():
    """The port builds its own copy of fastio.cpp into its own build
    directory, and its loader names no path of the JAX package."""
    loader = tnative.loader
    pkg = ROOT / "composablestatespacemodels_torch"
    assert loader._SRC == pkg / "native" / "fastio.cpp"
    assert loader._SRC.is_file()
    assert loader.library_path().is_relative_to(pkg / "_build")
    assert "composablestatespacemodels_tpu" not in \
        (pkg / "native" / "loader.py").read_text()
    assert tnative.available()


def test_native_missing_file_returns_none():
    assert tnative.parse_timeseries_csv("/nonexistent/file.csv") is None


def test_write_matrix_csv_roundtrip(tmp_path):
    path = str(tmp_path / "m.csv")
    mat = np.arange(12.0).reshape(4, 3) / 7.0
    assert tnative.write_matrix_csv(path, "a,b,c", mat)
    lines = open(path).read().strip().split("\n")
    assert lines[0] == "a,b,c"
    np.testing.assert_array_equal(
        [[float(v) for v in ln.split(",")] for ln in lines[1:]], mat)


# -- parameters and posteriors ------------------------------------------------


def _stacked_values(rng, n):
    """A stacked (n iterations) NB + seasonal parameter tree's values:
    a scale and two OU records, the second with 2-vectors."""
    def rec(k):
        return {f: rng.normal(size=(n, k)).astype(F32)
                for f in ("m0", "c0", "phi", "mu", "sigma")}
    return {"scale": rng.normal(size=n).astype(F32), "ou1": rec(1),
            "ou2": rec(2)}


def _stacked_trees(vals):
    def build(tree, node, ou, arr):
        return tree.Branch(
            tree.Leaf(node(arr(vals["scale"]),
                           ou(**{k: arr(v) for k, v in vals["ou1"].items()}))),
            tree.Leaf(node(None,
                           ou(**{k: arr(v) for k, v in vals["ou2"].items()}))))
    from composablestatespacemodels_torch.models import params as tparams
    from composablestatespacemodels_torch.models import tree as ttree
    return (build(jtree, jparams.ParamNode, jparams.OuParams, jnp.asarray),
            build(ttree, tparams.ParamNode, tparams.OuParams, torch.tensor))


def _results(rng, n=7, d=3):
    jp, tp = _stacked_trees(_stacked_values(rng, n))
    lls = rng.normal(-100.0, 5.0, n).astype(F32)
    acc = np.cumsum(rng.uniform(size=n) < 0.5).astype(np.int32)
    states = rng.normal(size=(n, d)).astype(F32)
    return (JPmmhResult(jp, jnp.asarray(lls), jnp.asarray(acc),
                        jnp.asarray(states)),
            TPmmhResult(tp, torch.tensor(lls), torch.tensor(acc),
                        torch.tensor(states)))


def test_params_json_bytes_and_cross_read(tmp_path):
    rng = np.random.default_rng(3)
    jp, tp = _stacked_trees(_stacked_values(rng, 1))
    import jax
    jp = jax.tree_util.tree_map(lambda x: x[0], jp)
    tp = ct.models.tree_map(lambda x: x[0], tp)
    jpath, tpath = _write_both(tmp_path, "params.json",
                               lambda p: jio.write_params_json(p, jp),
                               lambda p: tio.write_params_json(p, tp))
    _eq(jparams.flatten_params(jio.read_params_json(tpath)),
        ct.models.flatten_params(tio.read_params_json(jpath, device="cpu")))
    assert tio.params_to_json(ct.models.Empty) == jio.params_to_json(
        jtree.Empty)
    assert tio.params_from_json({"empty": True}) is ct.models.Empty


def test_posterior_json_bytes_and_cross_read(tmp_path):
    jres, tres = _results(np.random.default_rng(4))
    jp, tp = _write_both(tmp_path, "post.json",
                         lambda p: jio.write_posterior_json(p, jres),
                         lambda p: tio.write_posterior_json(p, tres))
    for burn_in, thin in ((0, 1), (2, 2)):
        jst, jll, jacc = jio.read_posterior_json(tp, burn_in, thin)
        tst, tll, tacc = tio.read_posterior_json(jp, burn_in, thin,
                                                 device="cpu")
        _eq(jparams.stack_flat(jst), ct.models.stack_flat(tst))
        _eq(jll, tll)
        _eq(jacc, tacc)
        assert tacc.dtype == torch.int32


def test_posterior_to_csv_bytes(tmp_path, tier):
    jres, tres = _results(np.random.default_rng(5))
    post = str(tmp_path / "post.json")
    jio.write_posterior_json(post, jres)
    template = jtree.Branch(*[jtree.Leaf(v) for v in (
        jparams.ParamNode(jnp.zeros(()), jparams.OuParams(
            *[jnp.zeros(1)] * 5)),
        jparams.ParamNode(None, jparams.OuParams(*[jnp.zeros(2)] * 5)))])
    ttemplate = ct.params_from_numpy(
        {"left": {"scale": 0.0, "sde": {"kind": "ou", **{
            f: np.zeros(1) for f in ("m0", "c0", "phi", "mu", "sigma")}}},
         "right": {"scale": None, "sde": {"kind": "ou", **{
             f: np.zeros(2) for f in ("m0", "c0", "phi", "mu", "sigma")}}}})
    _write_both(tmp_path, "post.csv",
                lambda p: jio.posterior_to_csv(post, p, template),
                lambda p: tio.posterior_to_csv(post, p, ttemplate))


def test_metrop_and_pf_state_records(tmp_path):
    jres, tres = _results(np.random.default_rng(6))
    jp, tp = _write_both(
        tmp_path, "metrop.json",
        lambda p: jio.write_metrop_states_json(p, jres, 12.5),
        lambda p: tio.write_metrop_states_json(p, tres,
                                               torch.tensor(12.5)))
    j = jio.read_metrop_states_json(tp, 1, 2)
    t = tio.read_metrop_states_json(jp, 1, 2, device="cpu")
    _eq(jparams.stack_flat(j[0]), ct.models.stack_flat(t[0]))
    assert j[2] == t[2] == 12.5
    for a, b in ((j[1], t[1]), (j[3], t[3]), (j[4], t[4])):
        _eq(a, b)
    with pytest.raises(ValueError, match="store_state"):
        tio.write_metrop_states_json(str(tmp_path / "x"),
                                     TPmmhResult(tres.params, tres.lls,
                                                 tres.accepted), 1.0)
    rng = np.random.default_rng(7)
    recs = [(float(i), None if i == 1 else 0.5 * i,
             rng.normal(size=(4, 2)).astype(F32), F32(-3.25 * i), 4 - i)
            for i in range(3)]
    jp, tp = _write_both(
        tmp_path, "pf.json", lambda p: jio.write_pf_states_json(p, recs),
        lambda p: tio.write_pf_states_json(
            p, [(t, o, torch.tensor(x), ll, e) for t, o, x, ll, e in recs]))
    for a, b in zip(jio.read_pf_states_json(tp),
                    tio.read_pf_states_json(jp, device="cpu")):
        assert (a[0], a[1], a[3], a[4]) == (b[0], b[1], b[3], b[4])
        _eq(a[2], b[2])


def test_filter_and_forecast_writers_bytes(tmp_path):
    rng = np.random.default_rng(8)
    t_len, d = 6, 3

    def v(*shape):
        return rng.normal(size=shape).astype(F32)

    summ = {"ts": v(t_len), "eta_mean": v(t_len), "eta_lower": v(t_len),
            "eta_upper": v(t_len), "state_mean": v(t_len, d),
            "state_lower": v(t_len, d), "state_upper": v(t_len, d)}
    ess = rng.integers(1, 100, t_len).astype(np.int32)
    llh = v(t_len)
    jres = types.SimpleNamespace(summary=types.SimpleNamespace(**summ),
                                 ess=ess, ll_history=llh)
    tres = FilterResult(torch.tensor(0.0), torch.tensor(llh),
                        torch.tensor(ess), torch.zeros(2, d),
                        PfSummary(**{k: torch.tensor(x)
                                     for k, x in summ.items()}))
    _write_both(tmp_path, "filter.json",
                lambda p: jio.write_filter_json(p, jres),
                lambda p: tio.write_filter_json(p, tres))
    fc = {k: v(t_len) for k in ("t", "obs_mean", "obs_lower", "obs_upper",
                                "eta_mean", "eta_lower", "eta_upper")}
    fc.update(state_mean=v(t_len, d), state_lower=v(t_len, d),
              state_upper=v(t_len, d))
    _write_both(tmp_path, "forecast.csv",
                lambda p: jio.write_forecast_csv(p,
                                                 types.SimpleNamespace(**fc)),
                lambda p: tio.write_forecast_csv(
                    p, Forecast(**{k: torch.tensor(x)
                                   for k, x in fc.items()})))
    with pytest.raises(ValueError, match="summary"):
        tio.write_filter_json(str(tmp_path / "x"), FilterResult(
            tres.ll, tres.ll_history, tres.ess, tres.final_particles))
    assert json.loads(open(tmp_path / "torch_filter.json").readline())[
        "ess"] == int(ess[0])
