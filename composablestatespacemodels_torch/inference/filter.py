"""Bootstrap particle filter on the ``[d, N]`` particle cloud, and
forecasting.

PyTorch port of ``composablestatespacemodels_tpu/inference/filter.py``:
the summaries (:47-344), the filter scans ``_filter_impl_t`` (:347),
``_filter_impl_t_fused`` (:494) and ``_filter_impl`` (:670),
``bootstrap_filter`` (:784), ``log_likelihood`` (:868) and forecasting
(:885-1073).  The schemes keep the JAX names, so one string drives both
packages.  ``[d, N]`` is the only internal layout (the JAX package keeps a
second ``[N, d]`` scan only because the TPU could not block-copy ``[N,
d]``); the user-facing API takes and returns ``[N, d]``.

* :func:`_filter_impl_t` serves every scheme name of the JAX package and a
  custom scheme, with every store mode and ``ess_threshold``.  Each step
  propagates the cloud to the observation time (the exact transition in
  torch ops, Euler-Maruyama for an SDE without one, or K5 + K3 under the
  fused scheme), weights it (``ll += max + log(total)``,
  ParticleFilter.scala:124-127), resamples and saves the step's summary,
  path or callable.  A counts scheme resamples through the K4 gather:
  ``"systematic"`` / ``"systematic-pallas"`` (the default; counts by K1),
  ``"stratified"`` / ``"stratified-pallas"`` and ``"multinomial"`` (counts
  through K7a/K7b).  An index scheme resamples by an index gather along
  the particle axis: ``"residual"``, ``"identity"`` and a callable
  ``(generator, weights) -> indices``.  The JAX package bit-compares its
  ``[N, d]`` scan against the ``-pallas`` names (its ``filter.py:803-808``),
  so one route serves both.  The two JAX routes part only at the unweighted
  ``eta_lower`` when ``floor(N * interval) == 0``: the port takes the
  index rule of the route that the JAX package runs for the scheme name
  (``clamp_eta``).
* ``"systematic-pallas-fused"`` (alias ``"systematic-fused"``): with
  ``store`` ``"ll"``/None and no ESS trigger, :func:`_filter_impl_t_fused`,
  which folds each step's propagate and next weights into the resample
  (K1, then K2 + K3).  Otherwise (a store mode needs the unpropagated
  resampled cloud) :func:`_filter_impl_t` with the propagate and weights
  in K5 + K3.  Both need an exact transition.

The per-step inputs that are one value per step (transition coefficients,
design vector, observation constants, seeds, systematic uniforms, the
store's draws) are computed in one batched pass before the loop; the
``[N]`` draws of the other schemes are made at the step.  The mask is read
on the host once, and ``ll``/``ess`` stay on the device until the end: the
loop never waits for the device -- except under ``ess_threshold``, where
whether to resample depends on the step's ESS: one host read per observed
step on that path only.  A missing observation propagates only and carries
the weights (ParticleFilter.scala:120-121).

:func:`_filter_ll_chains` is the systematic ll filter for B chains at once
on a ``[B, d, N]`` cloud (``pmmh_chains`` and ``pilot_run``, where the JAX
package ``vmap``s the filter): per-chain parameters, the counts of every
chain in one K6 batched call, the row gather in torch.

Forecasting (:func:`forecast_cloud`, :func:`forecast`,
:func:`forecast_times`, :func:`forecast_from_posterior`) advances a
filtering cloud, or posterior draws, with ``model.step`` on ``[N, d]`` and
samples observations with the family's sampler.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..models.model import Model
from ..models.observation import KERNEL_CONSTS
from ..models.params import params_to
from ..models.tree import Tree, tree_map
from ..ops.resample_kernel import (propagate_weights_t, resample_propagate,
                                   sorted_gather_resample_t)
from ..ops.scan_kernel import systematic_counts_fused
from ..ops.selection import kth_smallest_bits, weighted_quantile_bits
from ..utils.data import TimeSeries
from . import resampling as rs

_FUSED = ("systematic-pallas-fused", "systematic-fused")
_ALIASES = {"systematic-pallas": "systematic",
            "stratified-pallas": "stratified"}
# schemes whose counts K4 gathers with; the others give ancestor indices
_COUNTS = ("systematic", "stratified", "multinomial")
_SCHEMES = sorted((*rs._SCHEMES, *_ALIASES, *_FUSED))


# ---------------------------------------------------------------------------
# summaries
# ---------------------------------------------------------------------------


def credible_interval_eta(samples: torch.Tensor, interval: float = 0.975):
    """Order-statistic interval, eta flavour (ParticleFilter.scala:455-460):
    ``sorted[n - idx]``, ``sorted[min(idx, n - 1)]``,
    ``idx = floor(n * interval)``; at ``idx == 0`` the lower index is
    clamped to ``n - 1``, as the JAX package's indexing clamps it."""
    n = samples.shape[0]
    idx = math.floor(n * interval)
    s = torch.sort(samples, dim=0).values
    return s[min(n - idx, n - 1)], s[min(idx, n - 1)]


def credible_interval_state(samples: torch.Tensor, interval: float = 0.975):
    """Order-statistic interval, state flavour, off by one as in the
    reference (ParticleFilter.scala:488-502): ``sorted[n - idx - 1]``,
    ``sorted[idx - 1]``.  Works on ``[N]`` or ``[N, d]`` (per column)."""
    n = samples.shape[0]
    idx = math.floor(n * interval)
    s = torch.sort(samples, dim=0).values
    return s[n - idx - 1], s[idx - 1]


def _interval_levels(n: int, interval: float):
    """Weighted-CDF levels equivalent to the unweighted order-statistic
    indices of :func:`credible_interval_state` / :func:`credible_interval_eta`
    (for uniform weights the smallest x with weighted CDF >= (j+1)/n is
    ``sorted[j]``), indices wrapped mod n as the transposed path does.
    Returns ``(state_levels, eta_levels)``, each ``(lower, upper)``."""
    idx = math.floor(n * interval)
    j_s = ((n - idx - 1) % n, (idx - 1) % n)        # state flavour
    j_e = ((n - idx) % n, min(idx, n - 1))          # eta flavour
    return (tuple((j + 1) / n for j in j_s),
            tuple((j + 1) / n for j in j_e))


def _weighted_pick(wn: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Index of one particle sampled with probability proportional to
    ``wn`` by inverse CDF at the uniform ``u``: the weighted ``sampleOne``
    of ``store='path'`` when ``ess_threshold`` leaves the carried weights
    non-uniform."""
    j = torch.searchsorted(torch.cumsum(wn, dim=0), u * torch.sum(wn))
    return torch.clamp(j, 0, wn.shape[0] - 1)


@dataclasses.dataclass(frozen=True)
class PfSummary:
    """Per-step filtering summaries (the reference ``PfOut``,
    ParticleFilter.scala:53-59 + getIntervals :415-424)."""

    ts: torch.Tensor           # [T]
    eta_mean: torch.Tensor     # [T]     link(f(mean state, t))
    eta_lower: torch.Tensor    # [T]
    eta_upper: torch.Tensor    # [T]
    state_mean: torch.Tensor   # [T, d]
    state_lower: torch.Tensor  # [T, d]
    state_upper: torch.Tensor  # [T, d]


@dataclasses.dataclass(frozen=True)
class FilterResult:
    """Output of :func:`bootstrap_filter` (reference ``PfState``,
    ParticleFilter.scala:32-37)."""

    ll: torch.Tensor                        # scalar
    ll_history: torch.Tensor                # [T]
    ess: torch.Tensor                       # [T] int32
    final_particles: torch.Tensor           # [N, d]
    summary: Optional[PfSummary] = None     # store='summary'
    sampled_path: Optional[torch.Tensor] = None  # [T, d], store='path'


def _make_save_fn_t(model: Model, store, interval: float, weighted: bool,
                    generator: torch.Generator, n_steps: int, n: int,
                    clamp_eta: bool = False):
    """The per-step save of the ``[d, N]`` cloud after resampling:
    ``save(i, t, g, x_t, wn)`` with ``g`` the design vector at ``t`` and
    ``wn`` the carried normalised weights.  With ``weighted`` (an
    ``ess_threshold`` can skip resamples, leaving ``wn`` non-uniform) the
    summaries and paths are weight-aware; otherwise ``wn`` is uniform at
    every save and the reference's unweighted semantics apply
    (ParticleFilter.scala:415-424).  Random draws (``store='path'``) are
    made here, for every step at once.

    ``clamp_eta`` picks the unweighted ``eta_lower`` index at
    ``floor(n * interval) == 0`` as the JAX package's route for the scheme
    does: its ``[N, d]`` scan (the plain scheme names and a callable)
    clamps ``n - k`` to ``n - 1`` through :func:`credible_interval_eta`;
    its transposed scan (the ``-pallas`` and fused names) wraps it mod n
    (``filter.py:260-266`` and ``:322-331`` of the JAX package)."""
    if store == "ll" or store is None:
        return lambda i, t, g, x_t, wn: None
    device = generator.device
    if store == "path":
        if weighted:
            u = torch.rand(n_steps, generator=generator, device=device)
            return lambda i, t, g, x_t, wn: x_t[:, _weighted_pick(wn, u[i])]
        # one uniformly sampled particle per step (reference filter(),
        # ParticleFilter.scala:152-158 + Resampling.sampleOne)
        pick = torch.randint(0, n, (n_steps,), generator=generator,
                             device=device)
        return lambda i, t, g, x_t, wn: x_t[:, pick[i]]
    if store == "summary":
        d = model.dim
        # bisection selection in place of a [d, N] sort per step: exact,
        # bit-identical order statistics; state indices wrap mod n, as the
        # sort path's negative indices do at edge intervals
        # (filter.py:322-331)
        if weighted:
            ps_s, ps_e = _interval_levels(n, interval)
            levels = torch.tensor([list(ps_s)] * d + [list(ps_e)],
                                  dtype=torch.float32, device=device)
        else:
            k = math.floor(n * interval)
            e_lo = min(n - k, n - 1) if clamp_eta else (n - k) % n
            levels = torch.tensor([[(n - k - 1) % n, (k - 1) % n]] * d
                                  + [[e_lo, min(k, n - 1)]],
                                  dtype=torch.int32, device=device)

        def save(i, t, g, x_t, wn):
            cols = torch.cat([x_t, model.link(g @ x_t)[None]])
            if weighted:
                mean = torch.sum(wn[None, :] * x_t, dim=1) / torch.sum(wn)
                sel = weighted_quantile_bits(cols, wn, levels)
            else:
                mean = torch.mean(x_t, dim=1)
                sel = kth_smallest_bits(cols, levels)          # [d + 1, 2]
            return (model.link(mean @ g), sel[d, 0], sel[d, 1],
                    mean, sel[:d, 0], sel[:d, 1])
        return save
    if callable(store):
        # the documented (t, particles [N, d], key) contract, with the
        # filter's generator for the key; its value is dropped, as the JAX
        # package drops it (FilterResult has no field for it)
        return lambda i, t, g, x_t, wn: store(t, x_t.T, generator)
    raise ValueError(f"unknown store mode {store!r}")


# ---------------------------------------------------------------------------
# the filter
# ---------------------------------------------------------------------------


def _step_seeds(generator: torch.Generator, n_steps: int) -> torch.Tensor:
    """Distinct int32 kernel seeds: one random base per call, then
    ``base ^ (step * 0x9E3779B9) mod 2^32`` (``_step_seed``, filter.py:213
    of the JAX package) -- odd multiplication is a bijection mod 2^32, so
    no two steps of a call share a noise stream."""
    device = generator.device
    base = torch.randint(0, 2 ** 32, (), generator=generator, device=device,
                         dtype=torch.int64)
    steps = torch.arange(n_steps, dtype=torch.int64, device=device)
    s = base ^ ((steps * 0x9E3779B9) & 0xFFFFFFFF)
    return torch.where(s >= 2 ** 31, s - 2 ** 32, s).to(torch.int32)


def _weigh(logw: torch.Tensor, wn: torch.Tensor):
    """Weigh the carried normalised weights ``wn`` by ``logw`` along the
    last axis: the ll increment ``max + log(total)``
    (ParticleFilter.scala:124-127) and the new normalised weights.  The one
    weighing of every ``[d, N]`` route, one chain or B."""
    maxw = torch.amax(logw, dim=-1, keepdim=True)
    u = wn * torch.exp(logw - maxw)
    total = torch.sum(u, dim=-1, keepdim=True)
    return (maxw + torch.log(total)).squeeze(-1), u / total


def _weights(model, params, x_t, t, y, mask):
    return model.log_density(params, model.f_t(x_t, t),
                             torch.where(mask, y, 0.0))


def _initial_cloud(model: Model, params: Tree, generator, n: int, x_init):
    """The initial ``[d, N]`` cloud: drawn, a fixed state ``[d]`` for every
    particle (FilterInit, ParticleFilter.scala:252-271) or a cloud
    ``[N, d]``."""
    if x_init is None:
        return model.initial_state_t(params, generator, n)
    x_init = torch.as_tensor(x_init, dtype=torch.float32,
                             device=generator.device)
    return (x_init[:, None].expand(model.dim, n) if x_init.ndim == 1
            else x_init.T).contiguous()


def _resample_step(scheme, generator, x1, wn1, u_i):
    """The resampled cloud and what chose it: K4 with the counts of a
    counts scheme (``u_i`` the step's systematic uniform), or an index
    gather along dim 1 with the scheme's ancestor indices.  Returns ``(x,
    counts or indices)``."""
    n = x1.shape[1]
    if scheme == "systematic":
        counts = rs.systematic_counts(wn1, u_i)
    elif scheme in _COUNTS:
        u = torch.rand(n, generator=generator, device=x1.device)
        counts_fn = (rs.stratified_counts if scheme == "stratified"
                     else rs.multinomial_counts)
        counts = counts_fn(wn1, u)
    else:
        idx = rs.get_scheme(scheme)(generator, wn1)
        return x1[:, idx.long()], idx
    return sorted_gather_resample_t(x1, counts), counts


def _propagate(model: Model, params: Tree, coef_i, dt_i, x, generator):
    """The ``[d, N]`` cloud ``x`` propagated over one step: the exact
    transition with the step's ``coef_i [d, 3]`` (a, b, sqrt q) and normals
    from ``generator``, or Euler-Maruyama over ``dt_i`` where ``coef_i`` is
    None (no exact transition)."""
    if coef_i is None:
        return model.step_t(params, generator, x, dt_i)
    z = torch.randn(x.shape, generator=generator, device=x.device)
    return coef_i[:, 0:1] * x + coef_i[:, 1:2] + coef_i[:, 2:3] * z


def _filter_impl_t(model: Model, params: Tree, data: TimeSeries,
                   n_particles: int, generator: torch.Generator, t0, x_init,
                   store, ess_threshold, interval: float,
                   fused_propagate: bool, scheme,
                   observed: list, clamp_eta: bool) -> FilterResult:
    """Per step: propagate to the observation time (torch ops, Euler-
    Maruyama without an exact transition, or K5 with ``fused_propagate``),
    weight, update ll and ESS, resample with ``scheme`` (a name of
    ``resampling._SCHEMES`` or a callable), save.  ``observed`` is the
    mask as a host list; ``clamp_eta`` as in :func:`_make_save_fn_t`."""
    device = generator.device
    params = params_to(params, device)
    sp = model.sde_params(params)
    n = n_particles
    ts, ys, mask = data.ts, data.ys, data.mask
    n_steps = len(observed)
    save = _make_save_fn_t(model, store, interval, ess_threshold is not None,
                           generator, n_steps, n, clamp_eta)

    x = _initial_cloud(model, params, generator, n, x_init)
    t_start = ts[:1] if t0 is None else torch.tensor(
        [t0], dtype=torch.float32, device=device)
    dts = ts - torch.cat([t_start, ts[:-1]])
    # every step's inputs, in one batched pass
    exact = fused_propagate or model.sde.exact
    if exact:  # raises for an SDE without an exact transition
        a, b, q = model.sde.transition_coeffs(sp, dts)           # [T, d]
        cols = [a, b, torch.sqrt(q)]
    design = model.design_vector(ts)                             # [T, d]
    y_safe = torch.where(mask, ys, 0.0)
    family_id = None
    if fused_propagate:
        wspec = model.obs.kernel_log_density()
        if wspec is not None:
            make_consts, family_id = wspec
            cols.append(design)
            c = make_consts(y_safe, model.obs_scale(params))
            consts = torch.zeros((n_steps, KERNEL_CONSTS),
                                 dtype=torch.float32, device=device)
            consts[:, :c.shape[-1]] = c
        seeds = _step_seeds(generator, n_steps)
    if exact:
        coef = torch.stack(cols, dim=-1).contiguous()            # [T, d, 3|4]
    uniforms = (torch.rand(n_steps, generator=generator, device=device)
                if scheme == "systematic" else [None] * n_steps)
    scale = model.obs_scale(params)

    uniform_w = torch.full((n,), 1.0 / n, dtype=torch.float32, device=device)
    wn = uniform_w
    ll = torch.zeros((), dtype=torch.float32, device=device)
    ess = torch.tensor(n, dtype=torch.int32, device=device)
    saved, ll_hist, ess_hist = [], [], []
    for i in range(n_steps):
        logw = None
        if fused_propagate:
            x1, logw = propagate_weights_t(
                x, coef[i], None if family_id is None else consts[i],
                seeds[i], family_id)
        else:
            x1 = _propagate(model, params, coef[i] if exact else None,
                            dts[i], x, generator)
        resample = False
        if observed[i]:
            if logw is None:
                logw = model.obs.log_density(design[i] @ x1, y_safe[i], scale)
            inc, wn1 = _weigh(logw, wn)
            ll = ll + inc
            ess = torch.floor(1.0 / torch.sum(wn1 * wn1)).to(torch.int32)
            # the one host read per step, and only under an ESS trigger
            resample = (ess_threshold is None
                        or int(ess) < ess_threshold * n)
        else:
            wn1 = wn / torch.sum(wn)
        if resample:
            x, _ = _resample_step(scheme, generator, x1, wn1, uniforms[i])
            wn = uniform_w
        else:
            x, wn = x1, wn1
        saved.append(save(i, ts[i], design[i], x, wn))
        ll_hist.append(ll)
        ess_hist.append(ess)

    summary = path = None
    if store == "summary":
        summary = PfSummary(ts, *(torch.stack(v) for v in zip(*saved)))
    elif store == "path":
        path = torch.stack(saved)
    return FilterResult(ll, torch.stack(ll_hist), torch.stack(ess_hist), x.T,
                        summary, path)


def _filter_impl_t_fused(model: Model, params: Tree, data: TimeSeries,
                         n_particles: int, generator: torch.Generator,
                         t0, x_init, observed: list) -> FilterResult:
    """The carried cloud is already propagated to the step's time: weight
    it, build the systematic counts (K1), then resample, propagate to the
    next observation time and weight there in one kernel (K2 + K3).  The
    last step uses ``dt = 0``, so ``final_particles`` is the filtering
    cloud at the last time."""
    device = generator.device
    make_consts, family_id = model.obs.kernel_log_density()
    params = params_to(params, device)
    sp = model.sde_params(params)
    d, n = model.dim, n_particles
    ts, ys, mask = data.ts, data.ys, data.mask
    n_steps = len(observed)

    x = _initial_cloud(model, params, generator, n, x_init)
    t_start = ts[0] if t0 is None else torch.as_tensor(
        t0, dtype=torch.float32, device=device)
    # pre-propagate to the first observation time
    x = model.step_t(params, generator, x, ts[0] - t_start)
    logw = _weights(model, params, x, ts[0], ys[0], mask[0])

    # every step's inputs for the NEXT interval, in one batched pass
    zero = torch.zeros(1, dtype=torch.float32, device=device)
    dt_next = torch.cat([ts[1:] - ts[:-1], zero])
    t_next = torch.cat([ts[1:], ts[-1:]])
    y_next = torch.cat([ys[1:], zero])
    m_next = torch.cat([mask[1:], torch.zeros(1, dtype=torch.bool,
                                              device=device)])
    a, b, q = model.sde.transition_coeffs(sp, dt_next)          # [T, d]
    design = model.design_vector(t_next)                         # [T, d]
    coef = torch.stack([a, b, torch.sqrt(q), design], dim=-1).contiguous()
    c = make_consts(torch.where(m_next, y_next, 0.0), model.obs_scale(params))
    consts = torch.zeros((n_steps, KERNEL_CONSTS), dtype=torch.float32,
                         device=device)
    consts[:, :c.shape[-1]] = c
    seeds = _step_seeds(generator, n_steps)
    uniforms = torch.rand(n_steps, generator=generator, device=device)

    uniform_w = torch.full((n,), 1.0 / n, dtype=torch.float32, device=device)
    wn = uniform_w
    ll = torch.zeros((), dtype=torch.float32, device=device)
    ess = torch.tensor(n, dtype=torch.int32, device=device)
    ll_hist, ess_hist = [], []
    for i in range(n_steps):
        if observed[i]:
            inc, wn1 = _weigh(logw, wn)
            ll = ll + inc
            ess = torch.floor(1.0 / torch.sum(wn1 * wn1)).to(torch.int32)
            counts = systematic_counts_fused(wn1, torch.sum(wn1), uniforms[i])
            x, logw = resample_propagate(x, counts, coef[i], consts[i],
                                         seeds[i], family_id)
            wn = uniform_w
        else:
            wn = wn / torch.sum(wn)
            x = model.step_t(params, generator, x, dt_next[i])
            logw = _weights(model, params, x, t_next[i], y_next[i],
                            m_next[i])
        ll_hist.append(ll)
        ess_hist.append(ess)
    return FilterResult(ll, torch.stack(ll_hist), torch.stack(ess_hist), x.T)


def _ll_step_chains(model: Model, x, wn, coef_i, design_i, y_i, scale,
                    observed: bool, z, u):
    """One step of the systematic ll filter for B chains, with its draws
    fed: ``x [B, d, N]`` the clouds, ``wn`` the carried normalised weights
    (``[N]`` or ``[B, N]``), ``coef_i [B, d, 3]``, ``design_i [d]``,
    ``y_i`` the observation, ``scale [B]``, ``z [B, d, N]`` the normals and
    ``u [B]`` the resampling uniforms.  Returns ``(x, wn, ll increment
    [B])``; a missing observation propagates only, carries the weights and
    gives the increment None.  Row b computes what :func:`_filter_impl_t`
    computes for one chain."""
    x1 = coef_i[..., 0:1] * x + coef_i[..., 1:2] + coef_i[..., 2:3] * z
    if not observed:
        return x1, wn / torch.sum(wn, dim=-1, keepdim=True), None
    n = x.shape[-1]
    inc, wn1 = _weigh(
        model.obs.log_density(design_i @ x1, y_i, scale[:, None]), wn)
    anc = rs._ancestors_from_counts(rs.systematic_counts(wn1, u), n)
    x = torch.gather(x1, 2, anc[:, None, :].long().expand_as(x1))
    return x, torch.full((n,), 1.0 / n, dtype=x.dtype, device=x.device), inc


def _filter_ll_chains(model: Model, params_b: Tree, data: TimeSeries,
                      n_particles: int, generator: torch.Generator,
                      observed: list):
    """The ``resample="systematic"``, ``store="ll"`` filter for B chains at
    once: ``params_b`` carries a leading chain axis on every tensor.  The
    counts of all chains come from one K6 batched call per step; no step
    reads the device from the host (``observed`` is the mask as a host
    list).  Returns ``(ll [B], final clouds [B, d, N])``.  It draws as
    :func:`_filter_impl_t` does, chain axis first, so with B = 1 it
    repeats that filter's ll from the same generator state."""
    device = generator.device
    params_b = params_to(params_b, device)
    sp = model.sde_params(params_b)
    ts, ys, mask = data.ts, data.ys, data.mask
    x = model.initial_state_t(params_b, generator, n_particles)  # [B, d, N]
    b, d, n = x.shape
    dt = ts - torch.cat([ts[:1], ts[:-1]])
    a, bb, q = model.sde.transition_coeffs(sp, dt[:, None])       # [T, B, d]
    coef = torch.stack([a, bb, torch.sqrt(q)], dim=-1)
    design = model.design_vector(ts)
    y_safe = torch.where(mask, ys, 0.0)
    scale = model.obs_scale(params_b)
    uniforms = torch.rand((len(observed), b), generator=generator,
                          device=device)
    wn = torch.full((n,), 1.0 / n, dtype=torch.float32, device=device)
    ll = torch.zeros(b, dtype=torch.float32, device=device)
    for i, obs in enumerate(observed):
        z = torch.randn((b, d, n), generator=generator, device=device)
        x, wn, inc = _ll_step_chains(model, x, wn, coef[i], design[i],
                                     y_safe[i], scale, obs, z, uniforms[i])
        if inc is not None:
            ll = ll + inc
    return ll, x


def bootstrap_filter(model: Model, params: Tree, data: TimeSeries,
                     n_particles: int, generator: torch.Generator, *,
                     resample="systematic",
                     t0: Optional[float] = None,
                     initial_state=None,
                     store="summary",
                     ess_threshold: Optional[float] = None,
                     interval: float = 0.975) -> FilterResult:
    """Run the bootstrap particle filter over a time series.

    Args:
      model: a (possibly composed) model with any pointwise observation
        family.
      params: parameter tree matching the model composition.
      data: observations on the generator's device.
      n_particles: N.
      generator: ``torch.Generator`` for every random draw; the filter
        runs on its device (CUDA kernels on a card, their plain PyTorch
        versions on the CPU).
      resample: ``"systematic"`` (the default, as in the JAX package),
        ``"stratified"``, ``"multinomial"``, ``"residual"``,
        ``"identity"`` or a custom ``(generator, weights) -> indices``
        scheme; ``"systematic-pallas"`` and ``"stratified-pallas"`` (the
        same routes as ``"systematic"`` and ``"stratified"``); or
        ``"systematic-pallas-fused"`` (alias ``"systematic-fused"``: the
        propagate with in-kernel noise, folded into the resample under
        ``store="ll"``; statistically, not bitwise, equivalent to the
        others; exact-transition SDEs only).
      t0: start time (default: the first observation time).
      initial_state: optional fixed initial state ``[d]`` or cloud ``[N, d]``.
      store: ``"summary"`` (per-step :class:`PfSummary`), ``"path"`` (one
        sampled state per step, ``[T, d]``), ``"ll"`` or None (ll and ESS
        only), or a callable ``(t, particles [N, d], generator)`` called
        after every step.
      ess_threshold: if set, resample only when ESS < threshold * N (the
        reference always resamples; summaries and paths then weigh the
        carried weights).  Costs one host read per observed step.
      interval: credible-interval level of the summaries.
    """
    _check_scheme(resample, store)
    if data.ts.device != generator.device:
        raise ValueError(f"data on {data.ts.device} but generator on "
                         f"{generator.device}")
    model.validate_params(params)
    return _run(model, params, data, n_particles, generator, resample, t0,
                initial_state, store, ess_threshold, interval,
                data.mask.tolist())  # the mask on the host, read once


def _check_scheme(resample, store) -> None:
    if not (store in ("ll", "summary", "path", None) or callable(store)):
        raise ValueError(f"unknown store mode {store!r}")
    if not (callable(resample) or resample in _SCHEMES):
        raise ValueError(f"unknown resampling scheme {resample!r}; choose "
                         f"from {_SCHEMES}")


def _run(model, params, data, n_particles, generator, resample, t0,
         initial_state, store, ess_threshold, interval,
         observed: list) -> FilterResult:
    """The route of ``resample`` and ``store`` (checked), with the mask as
    the host list ``observed``."""
    fused = not callable(resample) and resample in _FUSED
    if (fused and store in ("ll", None) and ess_threshold is None
            and model.obs.kernel_log_density() is not None):
        return _filter_impl_t_fused(model, params, data, n_particles,
                                    generator, t0, initial_state, observed)
    scheme = ("systematic" if fused else resample if callable(resample)
              else _ALIASES.get(resample, resample))
    # the names that the JAX package runs on its [N, d] scan
    clamp_eta = callable(resample) or resample in rs._SCHEMES
    return _filter_impl_t(model, params, data, n_particles, generator, t0,
                          initial_state, store, ess_threshold, interval,
                          fused_propagate=fused, scheme=scheme,
                          observed=observed, clamp_eta=clamp_eta)


def log_likelihood(model: Model, params: Tree, data: TimeSeries,
                   n_particles: int, generator: torch.Generator, *,
                   resample="systematic", **kwargs) -> torch.Tensor:
    """Log marginal-likelihood estimate only (reference ``llFilter``,
    ParticleFilter.scala:137-140)."""
    return bootstrap_filter(model, params, data, n_particles, generator,
                            resample=resample, store="ll", **kwargs).ll


# ---------------------------------------------------------------------------
# forecasting (reference: ParticleFilter.scala:368-410)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Forecast:
    """Reference ``ForecastOut`` (ParticleFilter.scala:71-78); every field
    gains a leading ``[T]`` axis over several forecast times."""

    t: torch.Tensor
    obs_mean: torch.Tensor
    obs_lower: torch.Tensor
    obs_upper: torch.Tensor
    eta_mean: torch.Tensor
    eta_lower: torch.Tensor
    eta_upper: torch.Tensor
    state_mean: torch.Tensor
    state_lower: torch.Tensor
    state_upper: torch.Tensor




@dataclasses.dataclass(frozen=True)
class ForecastCloud:
    """Per-particle predictive draws at one future time: the reference
    ``getForecast``'s per-particle ``Vector[ObservationWithState]``
    (ParticleFilter.scala:368-390); :meth:`summarise` gives its pooled
    ``getMeanForecast`` view (:392-410)."""

    t: torch.Tensor      # scalar forecast time
    state: torch.Tensor  # [N, d] propagated latent states
    gamma: torch.Tensor  # [N] linear predictor f(x, t)
    eta: torch.Tensor    # [N] link(gamma)
    obs: torch.Tensor    # [N] sampled observations

    def summarise(self, interval: float = 0.995) -> Forecast:
        """Pool the cloud into the :class:`Forecast` summary."""
        s_lo, s_hi = credible_interval_state(self.state, interval)
        e_lo, e_hi = credible_interval_eta(self.eta, interval)
        o_lo, o_hi = credible_interval_eta(self.obs, interval)
        return Forecast(self.t, torch.mean(self.obs), o_lo, o_hi,
                        torch.mean(self.eta), e_lo, e_hi,
                        torch.mean(self.state, dim=0), s_lo, s_hi)


def _forecast_step(model, params, generator, x, t_prev, t) -> ForecastCloud:
    """Advance ``x [..., d]`` from ``t_prev`` to ``t`` with ``model.step``
    and sample one observation per state."""
    x1 = model.step(params, generator, x, t - t_prev)
    gamma = model.f(x1, t)
    return ForecastCloud(t, x1, gamma, model.link(gamma),
                         model.sample_obs(generator, params, gamma))


def _forecast_steps(model, params, generator, x, t_prev, ts,
                    interval) -> Forecast:
    """Advance ``x`` from time to time over ``ts [T]``, each step's cloud
    summarised; the summaries stacked along a leading ``[T]`` axis."""
    outs = []
    for t in ts:
        cloud = _forecast_step(model, params, generator, x, t_prev, t)
        outs.append(cloud.summarise(interval))
        x, t_prev = cloud.state, t
    return Forecast(*(torch.stack([getattr(f, fl.name) for f in outs])
                      for fl in dataclasses.fields(Forecast)))


def _times(t, device) -> torch.Tensor:
    return torch.as_tensor(t, dtype=torch.float32).to(device)


def forecast_cloud(model: Model, params: Tree, particles, t_prev, t,
                   generator: torch.Generator) -> ForecastCloud:
    """Advance a filtering particle cloud ``[N, d]`` (exchangeable,
    post-resampling, e.g. ``FilterResult.final_particles``) to time ``t``
    and return the per-particle predictive draws (reference
    ``getForecast``, ParticleFilter.scala:368-390)."""
    device = generator.device
    params = params_to(params, device)
    return _forecast_step(model, params, generator, particles,
                          _times(t_prev, device), _times(t, device))


def forecast(model: Model, params: Tree, particles, t_prev, t,
             generator: torch.Generator,
             interval: float = 0.995) -> Forecast:
    """:func:`forecast_cloud` summarised (reference getForecast /
    getMeanForecast, ParticleFilter.scala:368-410): the same generator
    state gives the same draws."""
    return forecast_cloud(model, params, particles, t_prev, t,
                          generator).summarise(interval)


def forecast_times(model: Model, params: Tree, particles, t_prev, ts,
                   generator: torch.Generator,
                   interval: float = 0.995) -> Forecast:
    """Iterated forecast over the future times ``ts [T]``: the cloud
    advances from time to time, each summarised."""
    device = generator.device
    return _forecast_steps(model, params_to(params, device), generator,
                           particles, _times(t_prev, device),
                           _times(ts, device), interval)


def forecast_from_posterior(model: Model, stacked_params,
                            generator: torch.Generator, t0, ts,
                            n_samples: int, state_samples=None,
                            interval: float = 0.995) -> Forecast:
    """Forecast driven by posterior parameter (and optionally state) draws
    (SimulateData.forecast, Data.scala:202-231): ``n_samples`` parameter
    draws, uniformly with replacement from ``stacked_params`` (a tree with
    a leading sample axis, e.g. a thinned ``PmmhResult.params``), each
    with its own latent trajectory over ``ts``; summaries pool over draws.

    ``state_samples [k, d]``: when ``k`` equals the number of parameter
    draws available, row ``i`` is the joint posterior partner of parameter
    draw ``i`` (a ``pmmh(store_state=True)`` result) and the pairing is
    kept; otherwise (an exchangeable filtering cloud) states are drawn
    uniformly and independently of the parameters.  Default: fresh draws
    from each parameter set's initial distribution.  The draws run as one
    chain-batched step per time, parameters ``[S, ...]`` against states
    ``[S, d]``."""
    device = generator.device
    stacked_params = params_to(stacked_params, device)
    ts = _times(ts, device)
    n_avail = rs._leading(stacked_params)
    idx = torch.randint(0, n_avail, (n_samples,), generator=generator,
                        device=device)
    picked = tree_map(lambda v: v[idx], stacked_params)
    if state_samples is None:
        m0, c0 = model.sde.initial_moments(model.sde_params(picked))
        x = m0 + torch.sqrt(c0) * torch.randn(m0.shape, generator=generator,
                                              device=device)
    else:
        state_samples = torch.as_tensor(state_samples, dtype=torch.float32,
                                        device=device)
        if state_samples.shape[0] == n_avail:
            x = state_samples[idx]           # joint draws: keep the pairs
        else:
            x = state_samples[torch.randint(
                0, state_samples.shape[0], (n_samples,), generator=generator,
                device=device)]
    return _forecast_steps(model, picked, generator, x, _times(t0, device),
                           ts, interval)
