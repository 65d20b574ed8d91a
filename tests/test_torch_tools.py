"""The port's profiling harness and figures
(``composablestatespacemodels_torch.utils.profiling`` / ``plots``) at a
tiny size on the CPU: each timer returns positive medians of its repeats,
the trace is a Chrome trace file, each plot writes a PNG, and
``plot_posterior`` labels its rows with the JAX package's
``param_names``."""

from __future__ import annotations

import json
import math

import numpy as np
import pytest
import torch

import composablestatespacemodels_torch as ct
from composablestatespacemodels_torch.models import perturb
from composablestatespacemodels_torch.utils import plots, profiling
from composablestatespacemodels_tpu.models.params import param_names

from _torch_parity import both


@pytest.fixture(scope="module")
def pipeline():
    model = ct.linear(ct.brownian_motion(1))
    params = ct.parameters(math.log(0.5), ct.brownian_params(0.2, 0.25, 0.3))
    gen = torch.Generator().manual_seed(11)
    sim = ct.simulate_regular(model, params, gen, 30, dt=0.5)
    data = sim.to_timeseries().knock_out(5.0, 6.0)
    res = ct.bootstrap_filter(model, params, data, 128, gen)
    return model, params, sim, data, res


def test_time_fn_median_and_fresh_args(pipeline):
    model, params, _, data, _ = pipeline
    seen = []

    def make_args(i):
        seen.append(i)
        return (torch.Generator().manual_seed(100 + i),)

    med, times = profiling.time_fn(
        lambda g: ct.log_likelihood(model, params, data, 64, g), repeats=3,
        warmup=2, make_args=make_args)
    assert seen == [-1, -2, 0, 1, 2]
    assert len(times) == 3 and times == sorted(times) and med == times[1] > 0


def test_benchmark_filter_rates(pipeline):
    model, params, _, data, _ = pipeline
    out = profiling.benchmark_filter(model, params, data,
                                     torch.Generator().manual_seed(3),
                                     particle_counts=(32, 64), repeats=2)
    assert [n for n, _, _ in out] == [32, 64]
    for n, s, rate in out:
        assert s > 0 and rate == pytest.approx(n * len(data) / s)


def test_trace_writes_chrome_trace(pipeline, tmp_path):
    model, params, _, data, _ = pipeline
    with profiling.trace(str(tmp_path / "tr")) as prof:
        ct.log_likelihood(model, params, data, 32, torch.Generator())
    assert prof.key_averages()
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert events["traceEvents"]


def _png(path):
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and len(data) > 2000


def test_plots_write_pngs(pipeline, tmp_path):
    model, params, sim, data, res = pipeline
    plots.plot_simulation(sim, str(tmp_path / "sim.png"))
    plots.plot_filtering(res.summary, data, str(tmp_path / "filt.png"),
                         show_states=True)
    fc = ct.forecast_times(model, params, res.final_particles,
                           data.ts[-1], data.ts[-1] + torch.arange(1.0, 6.0),
                           torch.Generator())
    plots.plot_forecast(fc, data, str(tmp_path / "fc.png"))
    plots.plot_pilot_run([100, 200, 500], [4.0, 2.0, 0.8],
                         str(tmp_path / "pilot.png"))
    for name in ("sim", "filt", "fc", "pilot"):
        _png(tmp_path / f"{name}.png")


@pytest.mark.parametrize("chains", [1, 3])
def test_plot_posterior_names_equal_jax(tmp_path, chains):
    jm, jp, tm, tp = both("seasonal_linear")
    data = ct.simulate_regular(tm, tp, torch.Generator().manual_seed(2),
                               12).to_timeseries()
    pf_ll = ct.make_pf_loglik(tm, data, 16)
    gen = torch.Generator().manual_seed(4)
    res = (ct.pmmh(gen, tp, pf_ll, perturb(0.02), 6) if chains == 1 else
           ct.pmmh_chains(gen, tp, pf_ll, perturb(0.02), 6, chains))
    fig = plots.plot_posterior(res, path=str(tmp_path / "post.png"),
                               burn_in=1, max_params=40)
    names = param_names(jp)
    assert [ax.get_ylabel() for ax in fig.axes[::2]] == names
    # every chain drawn on each trace, its thinned values in order
    flat = ct.models.stack_flat(res.thin(1).params).reshape(
        chains, 5, len(names)).numpy()
    np.testing.assert_array_equal(
        np.stack([ln.get_ydata() for ln in fig.axes[0].lines]),
        flat[:, :, 0])
    _png(tmp_path / "post.png")
    plots.plot_diagnostics(res, path=str(tmp_path / "diag.png"))
    _png(tmp_path / "diag.png")
