"""Path-storing particle filter for interpolation / missing-data smoothing.

PyTorch port of ``composablestatespacemodels_tpu/inference/interpolation.py``
(reference ``FilterInterpolate``, ParticleFilter.scala:273-311, and the
``Interpolate`` example).  One forward pass filters the ``[d, N]`` cloud and
keeps what each step's resample chose; the surviving ancestral paths are
then rebuilt backward from that genealogy, with no path copied inside the
filter loop.

* The forward pass is :func:`.filter._filter_impl_t`'s step with every
  observed step resampled: the same propagate (exact, or Euler-Maruyama),
  weights, ll and ESS (unchanged at a missing observation), and the same
  draws from the generator in the same order, so its ll is
  ``bootstrap_filter(..., store="ll")``'s on the same generator and scheme.
  It resamples through the counts schemes and K4 (``"systematic"``: K1 +
  K4; ``"stratified"`` and ``"multinomial"``: K7a + K7b + K4), where the
  JAX package gathers rows ``x1[idx]``; residual, identity and a callable
  give ancestor indices and an index gather.  Each step keeps its counts
  ``[N]`` int32 (at a missing observation the identity counts ``1..N``),
  or its indices.
* The genealogy: from ``arange(N)`` backward, ``ps[k] = anc_k[ps[k+1]]``,
  where a counts step's ``anc_k[j]`` is the first ``i`` with
  ``counts[k, i] > j`` -- ``torch.searchsorted(counts[k], j,
  right=True)``, the ancestor that K4 (bit-exact to
  ``resampling._ancestors_from_counts``) gathered.
* ``store="path"`` keeps the pre-resample clouds ``[T, d, N]`` and gathers
  them along ``ps``.  ``store="summary"`` keeps only the ``[T, N]`` counts
  and ``ps`` and replays the propagation step by step, reducing each
  smoothed cloud in place.  The replay restores the generator's state
  saved before each step's propagate, so it draws the very normals of the
  forward pass and rebuilds its pre-resample clouds bit for bit (K4 again
  for the resample); the JAX package replays from its per-step keys.

Both tiers select their order statistics with
:func:`..ops.selection.kth_smallest_bits` (exact, the values of
``sort(row)[k]``) at the JAX package's indices for the tier: the path tier
clamps the eta lower index as ``credible_interval_eta`` does (JAX
``interpolation.py:123-134``), the summary tier wraps it, ``(n - k) % n``
(JAX :150-157).  They part only where ``floor(N * interval) == 0``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..models.model import Model
from ..models.params import params_to
from ..models.tree import Tree
from ..ops.resample_kernel import sorted_gather_resample_t
from ..ops.selection import kth_smallest_bits
from ..utils.data import TimeSeries
from . import resampling as rs
from .filter import _COUNTS, _initial_cloud, _propagate, _resample_step, _weigh
from .lgcp import _interval_ks


@dataclasses.dataclass(frozen=True)
class InterpolationResult:
    """Smoothed (ancestral-path) particle clouds at every observation time.

    ``paths[t, j]`` is the state at time ``ts[t]`` of the j-th surviving
    lineage (the reference's reversed path particles,
    ParticleFilter.scala:303-310); None under ``store="summary"``."""

    ll: torch.Tensor                 # scalar
    ess: torch.Tensor                # [T] int32
    paths: Optional[torch.Tensor]    # [T, N, d] smoothed clouds
    ts: torch.Tensor                 # [T]
    eta_mean: torch.Tensor           # [T]
    eta_lower: torch.Tensor          # [T]
    eta_upper: torch.Tensor          # [T]
    state_mean: torch.Tensor         # [T, d]
    state_lower: torch.Tensor        # [T, d]
    state_upper: torch.Tensor        # [T, d]


def interpolation_memory_bytes(n_steps: int, n_particles: int,
                               dim: int, itemsize: int = 4,
                               store: str = "path") -> int:
    """Peak device footprint of :func:`interpolation_filter`'s history.

    ``store='path'``: the pre-resample clouds ``[T, d, N]``, the smoothed
    paths ``[T, N, d]`` and the ``[T, N]`` int32 genealogy.
    ``store='summary'``: the ``[T, N]`` int32 genealogy and the ``[T, N]``
    int32 ``ps``; the clouds are replayed, never stored.  The JAX
    package's formula (``interpolation.py:180-195``)."""
    if store == "summary":
        return n_steps * n_particles * 8
    return n_steps * n_particles * (2 * dim * itemsize + 4)


def _parents(genealogy_k: torch.Tensor, j: torch.Tensor,
             counts: bool) -> torch.Tensor:
    """The pre-resample indices (int32) at step k of the slots ``j``: the
    first ``i`` with ``counts[i] > j``, or the step's ancestor indices."""
    if counts:
        return torch.searchsorted(genealogy_k, j, right=True, out_int32=True)
    return genealogy_k[j.long()].to(torch.int32)


def _summarise(model: Model, cloud: torch.Tensor, g: torch.Tensor,
               ks: torch.Tensor):
    """``(eta_mean, eta_lo, eta_hi, state_mean [d], state_lo, state_hi)``
    of one smoothed ``[d, N]`` cloud, ``g`` the design vector at its
    time, ``ks [d + 1, 2]`` the order statistics (state rows, then eta)."""
    d = cloud.shape[0]
    eta = model.link(g @ cloud)
    sel = kth_smallest_bits(torch.cat([cloud, eta[None]]), ks)
    return (torch.mean(eta), sel[d, 0], sel[d, 1], torch.mean(cloud, dim=1),
            sel[:d, 0], sel[:d, 1])


def _interp_impl(model: Model, params: Tree, data: TimeSeries,
                 n_particles: int, generator: torch.Generator, t0,
                 scheme, interval: float, store: str,
                 observed: list) -> InterpolationResult:
    device = generator.device
    params = params_to(params, device)
    sp = model.sde_params(params)
    d, n = model.dim, n_particles
    ts, ys, mask = data.ts, data.ys, data.mask
    n_steps = len(observed)
    counts_scheme = not callable(scheme) and scheme in _COUNTS

    # the step inputs and draws of _filter_impl_t, in its order
    x0 = _initial_cloud(model, params, generator, n, None)
    t_start = ts[:1] if t0 is None else torch.tensor(
        [t0], dtype=torch.float32, device=device)
    dts = ts - torch.cat([t_start, ts[:-1]])
    coef = [None] * n_steps
    if model.sde.exact:
        a, b, q = model.sde.transition_coeffs(sp, dts)           # [T, d]
        coef = torch.stack([a, b, torch.sqrt(q)], dim=-1).contiguous()
    design = model.design_vector(ts)                             # [T, d]
    y_safe = torch.where(mask, ys, 0.0)
    uniforms = (torch.rand(n_steps, generator=generator, device=device)
                if scheme == "systematic" else [None] * n_steps)
    scale = model.obs_scale(params)

    uniform_w = torch.full((n,), 1.0 / n, dtype=torch.float32, device=device)
    wn = uniform_w
    identity = (torch.arange(1, n + 1, dtype=torch.int32, device=device)
                if counts_scheme else
                torch.arange(n, dtype=torch.int32, device=device))
    genealogy = torch.empty((n_steps, n), dtype=torch.int32, device=device)
    xs_pre = (torch.empty((n_steps, d, n), dtype=torch.float32,
                          device=device) if store == "path" else None)
    states = []
    ll = torch.zeros((), dtype=torch.float32, device=device)
    ess = torch.tensor(n, dtype=torch.int32, device=device)
    ess_hist = []
    x = x0
    for i in range(n_steps):
        if store == "summary":
            states.append(generator.get_state())
        x1 = _propagate(model, params, coef[i], dts[i], x, generator)
        if store == "path":
            xs_pre[i] = x1
        if observed[i]:
            logw = model.obs.log_density(design[i] @ x1, y_safe[i], scale)
            inc, wn1 = _weigh(logw, wn)
            ll = ll + inc
            ess = torch.floor(1.0 / torch.sum(wn1 * wn1)).to(torch.int32)
            x, chosen = _resample_step(scheme, generator, x1, wn1,
                                       uniforms[i])
            wn = uniform_w
            genealogy[i] = chosen
        else:   # the weights carried as the filter carries them
            x, wn = x1, wn / torch.sum(wn)
            genealogy[i] = identity
        ess_hist.append(ess)

    eta_ks, state_ks = _interval_ks(n, interval)
    if store == "path":   # credible_interval_eta clamps the lower index
        eta_ks = (min(n - math.floor(n * interval), n - 1), eta_ks[1])
    ks = torch.tensor([list(state_ks)] * d + [list(eta_ks)],
                      dtype=torch.int32, device=device)
    j = torch.arange(n, dtype=torch.int32, device=device)
    outs = [None] * n_steps
    paths = None
    if store == "path":
        paths = torch.empty((n_steps, n, d), dtype=torch.float32,
                            device=device)
        for k in reversed(range(n_steps)):
            j = _parents(genealogy[k], j, counts_scheme)
            cloud = xs_pre[k][:, j.long()]
            paths[k] = cloud.T
            outs[k] = _summarise(model, cloud, design[k], ks)
    else:
        ps = torch.empty_like(genealogy)
        for k in reversed(range(n_steps)):
            j = _parents(genealogy[k], j, counts_scheme)
            ps[k] = j
        # the replay: the forward pass's draws from its saved states
        replay = torch.Generator(device=device)
        x = x0
        for k in range(n_steps):
            replay.set_state(states[k])
            x1 = _propagate(model, params, coef[k], dts[k], x, replay)
            outs[k] = _summarise(model, x1[:, ps[k].long()], design[k], ks)
            if not observed[k]:
                x = x1
            elif counts_scheme:
                x = sorted_gather_resample_t(x1, genealogy[k])
            else:
                x = x1[:, genealogy[k].long()]
    e_mean, e_lo, e_hi, s_mean, s_lo, s_hi = (torch.stack(v)
                                              for v in zip(*outs))
    return InterpolationResult(ll, torch.stack(ess_hist), paths, ts, e_mean,
                               e_lo, e_hi, s_mean, s_lo, s_hi)


def interpolation_filter(model: Model, params: Tree, data: TimeSeries,
                         n_particles: int, generator: torch.Generator, *,
                         t0: Optional[float] = None,
                         resample="systematic",
                         interval: float = 0.975,
                         store: str = "path") -> InterpolationResult:
    """Smoothing-by-filtering: reconstruct the latent path through gaps of
    missing observations (reference Interpolate example,
    examples/Interpolate.scala:10-53).

    Knock out observations with :meth:`TimeSeries.knock_out`; the returned
    per-time clouds are *smoothed* (conditioned on all observations), so
    the credible intervals bridge the gap rather than fanning out.

    Args:
      model, params: any pointwise observation family.
      data: observations on the generator's device.
      n_particles: N.
      generator: ``torch.Generator`` for every draw; the filter runs on its
        device.
      t0: start time (default: the first observation time).
      resample: ``"systematic"`` (K1 + K4 on a card), ``"stratified"`` or
        ``"multinomial"`` (K7a + K7b + K4), ``"residual"``, ``"identity"``
        or a ``(generator, weights) -> indices`` callable.
      interval: credible-interval level of the summaries.
      store: ``"path"`` keeps the pre-resample clouds and returns the
        smoothed ``paths [T, N, d]``; ``"summary"`` keeps only the int32
        genealogy (:func:`interpolation_memory_bytes`), replays the
        propagation and returns ``paths=None`` with every summary column.
    """
    if store not in ("path", "summary"):
        raise ValueError(
            f"store must be 'path' or 'summary', got {store!r}")
    if not (callable(resample) or resample in rs._SCHEMES):
        raise ValueError(f"unknown resampling scheme {resample!r}; choose "
                         f"from {sorted(rs._SCHEMES)}")
    if data.ts.device != generator.device:
        raise ValueError(f"data on {data.ts.device} but generator on "
                         f"{generator.device}")
    model.validate_params(params)
    return _interp_impl(model, params, data, n_particles, generator, t0,
                        resample, interval, store, data.mask.tolist())
