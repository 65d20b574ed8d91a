"""Figure output for simulations, filtering, forecasts and posteriors.

PyTorch port of ``composablestatespacemodels_tpu/utils/plots.py``: the
same figures from the port's results, tensors on any device copied to
the host.  The reference delegates all plotting to R (``R/Plots.R:1-107``:
simulated series, filtered ribbons, pilot-run variance, coda/ggmcmc posterior
diagnostics).  This module is the in-library matplotlib equivalent so the
rebuild produces figures end-to-end:

* :func:`plot_simulation`    -- observation/eta/state facets
  (Plots.R:9-56, the ouProcess / sims sections);
* :func:`plot_filtering`     -- filtered eta with credible ribbon over the
  observations (Plots.R:58-75, the geom_ribbon figure);
* :func:`plot_forecast`      -- forecast fan: observation + eta intervals;
* :func:`plot_pilot_run`     -- pseudo-ll variance vs particle count,
  log-x line + points (Plots.R:77-87);
* :func:`plot_posterior`     -- per-parameter trace + histogram grid
  (Plots.R:89-107, the mcmc.list |> ggs |> ggmcmc pipeline).

All functions return the matplotlib ``Figure`` and, when ``path`` is given,
write a PNG (the R script's ``ggsave``).  matplotlib is imported lazily
with the Agg backend so headless use never needs a display; a machine
without matplotlib can import this module but not draw.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .data import to_numpy as _np


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def _save(fig, path):
    if path is not None:
        fig.savefig(path, dpi=120, bbox_inches="tight")
    return fig


def plot_simulation(sim, path: Optional[str] = None, max_states: int = 6):
    """Faceted simulated series: observations, eta, and latent state
    components (Plots.R:9-56)."""
    plt = _plt()
    ts = _np(sim.ts)
    xs = _np(sim.xs)
    n_states = min(xs.shape[1], max_states)
    fig, axes = plt.subplots(2 + n_states, 1, sharex=True,
                             figsize=(8, 1.6 * (2 + n_states)))
    axes[0].plot(ts, _np(sim.ys), lw=0.8, color="C0")
    axes[0].set_ylabel("y")
    axes[1].plot(ts, _np(sim.etas), lw=0.8, color="C1")
    axes[1].set_ylabel("eta")
    for i in range(n_states):
        axes[2 + i].plot(ts, xs[:, i], lw=0.8, color="C2")
        axes[2 + i].set_ylabel(f"x{i}")
    axes[-1].set_xlabel("time")
    fig.tight_layout()
    return _save(fig, path)


def plot_filtering(summary, data=None, path: Optional[str] = None,
                   show_states: bool = False):
    """Filtered eta mean with its credible ribbon, observations overlaid
    (the geom_ribbon figure, Plots.R:58-75).  ``summary`` is a
    :class:`~..inference.filter.PfSummary`; ``data`` an optional
    :class:`~.data.TimeSeries` of the observations."""
    plt = _plt()
    ts = _np(summary.ts)
    n_rows = 1 + (_np(summary.state_mean).shape[1]
                  if show_states else 0)
    fig, axes = plt.subplots(n_rows, 1, sharex=True,
                             figsize=(8, 2.5 * n_rows), squeeze=False)
    ax = axes[0, 0]
    ax.fill_between(ts, _np(summary.eta_lower),
                    _np(summary.eta_upper), alpha=0.35,
                    color="#1f5081", lw=0, label="credible interval")
    ax.plot(ts, _np(summary.eta_mean), color="#1f5081", lw=1.0,
            label="filtered eta")
    if data is not None:
        mask = _np(data.mask).astype(bool)
        ax.plot(_np(data.ts)[mask], _np(data.ys)[mask], ".",
                ms=3, color="C1", label="observations")
    ax.legend(loc="best", fontsize=8)
    ax.set_ylabel("eta")
    if show_states:
        sm = _np(summary.state_mean)
        sl = _np(summary.state_lower)
        su = _np(summary.state_upper)
        for i in range(sm.shape[1]):
            axs = axes[1 + i, 0]
            axs.fill_between(ts, sl[:, i], su[:, i], alpha=0.3,
                             color="C2", lw=0)
            axs.plot(ts, sm[:, i], color="C2", lw=0.8)
            axs.set_ylabel(f"x{i}")
    axes[-1, 0].set_xlabel("time")
    fig.tight_layout()
    return _save(fig, path)


def plot_forecast(forecast, data=None, path: Optional[str] = None):
    """Forecast fan: predictive observation and eta intervals over time
    (the reference forecasts through getForecast then plots in R)."""
    plt = _plt()
    ts = _np(forecast.t)
    fig, ax = plt.subplots(figsize=(8, 3.2))
    ax.fill_between(ts, _np(forecast.obs_lower),
                    _np(forecast.obs_upper), alpha=0.2,
                    color="C0", lw=0, label="obs interval")
    ax.fill_between(ts, _np(forecast.eta_lower),
                    _np(forecast.eta_upper), alpha=0.35,
                    color="C0", lw=0, label="eta interval")
    ax.plot(ts, _np(forecast.obs_mean), color="C0", lw=1.2,
            label="mean forecast")
    if data is not None:
        mask = _np(data.mask).astype(bool)
        ax.plot(_np(data.ts)[mask], _np(data.ys)[mask], ".",
                ms=3, color="C1", label="observations")
    ax.legend(loc="best", fontsize=8)
    ax.set_xlabel("time")
    fig.tight_layout()
    return _save(fig, path)


def plot_pilot_run(particles, variances, path: Optional[str] = None):
    """Variance of the pseudo log-likelihood vs particle count, log-x
    (Plots.R:77-87)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 3.2))
    ax.plot(_np(particles), _np(variances), "-o", ms=4)
    ax.set_xscale("log")
    ax.set_xlabel("particles")
    ax.set_ylabel("mll variance")
    ax.set_title("Variance of Pseudo log-likelihood")
    fig.tight_layout()
    return _save(fig, path)


def plot_posterior(result, names: Optional[Sequence[str]] = None,
                   path: Optional[str] = None, burn_in: int = 0,
                   thin: int = 1, max_params: int = 12):
    """Per-parameter trace plot + histogram grid for a PMMH chain (the
    mcmc.list -> ggs -> ggmcmc diagnostics of Plots.R:89-107).

    ``result`` is a :class:`~..inference.pmmh.PmmhResult` (single chain or
    stacked chains -- chains are overlaid on the traces); ``names`` default
    to :func:`~..models.params.param_names` of the parameter tree.
    """
    from ..models.params import flatten_params, param_names
    from ..models.tree import tree_map

    plt = _plt()
    thinned = result.thin(burn_in, thin)
    lead = thinned.lls.ndim                    # 1 chain axis? + iter axis
    flat = _np(flatten_params(thinned.params))  # [(chains,) iters, k]
    if flat.ndim == 2:
        flat = flat[None]                       # [chains, iters, k]
    if names is None:
        p0 = thinned.params
        for _ in range(lead):
            p0 = tree_map(lambda x: x[0], p0)
        names = param_names(p0)
    k = min(flat.shape[-1], max_params)
    fig, axes = plt.subplots(k, 2, figsize=(9, 1.8 * k), squeeze=False)
    for i in range(k):
        for c in range(flat.shape[0]):
            axes[i, 0].plot(flat[c, :, i], lw=0.5)
            axes[i, 1].hist(flat[c, :, i], bins=40, histtype="step",
                            density=True)
        axes[i, 0].set_ylabel(names[i] if i < len(names) else f"p{i}",
                              fontsize=8)
    axes[-1, 0].set_xlabel("iteration")
    axes[-1, 1].set_xlabel("value")
    fig.tight_layout()
    return _save(fig, path)


def plot_diagnostics(result, path: Optional[str] = None):
    """Chain ll trace + running acceptance rate (monitorStream analogue)."""
    plt = _plt()
    lls = _np(result.lls)
    accs = _np(result.accepted)
    if lls.ndim == 1:
        lls, accs = lls[None], accs[None]
    fig, axes = plt.subplots(2, 1, sharex=True, figsize=(8, 4.5))
    it = np.arange(1, lls.shape[-1] + 1)
    for c in range(lls.shape[0]):
        axes[0].plot(it, lls[c], lw=0.6)
        axes[1].plot(it, accs[c] / it, lw=0.8)
    axes[0].set_ylabel("log-likelihood")
    axes[1].set_ylabel("acceptance rate")
    axes[1].set_xlabel("iteration")
    fig.tight_layout()
    return _save(fig, path)
