"""Log-Gaussian Cox process filtering: fine-grid cumulative-hazard weights.

PyTorch port of ``composablestatespacemodels_tpu/inference/lgcp.py``
(reference ``FilterLgcp``, ParticleFilter.scala:169-227), single device.
Each particle advances on a fine Euler grid between event times, summing
the cumulative hazard ``sum(exp(f(x_k, t_k)) * h)``, and is weighted by

    log w = gamma(t) - integral lambda dt      (ParticleFilter.scala:217)

The data-dependent number of fine steps ``ceil(dt * 10^p)``
(ParticleFilter.scala:190) is resolved on the host into one flat grid over
the whole series (:func:`_build_fine_grid`, the JAX package's), each slot
tagged with host flags (hazard-eval / advance / observation / zero-dt).
The filter walks that grid in a Python loop over the ``[d, N]`` cloud: the
flags are host arrays, so the JAX ``lax.cond`` at an observation slot is a
host ``if`` and no slot reads the device.  An observation slot weighs,
updates ll and ESS, summarises and resamples through
:func:`.filter._resample_step`: K1 + K4 for ``"systematic"`` (and its JAX
name ``"systematic-pallas"``), K7a + K7b + K4 for ``"stratified"`` and
``"multinomial"``, an index gather for residual, identity and a callable.
The summaries follow the JAX single-device filter: eta from the
pre-resample cloud, states from the resampled one, the order statistics of
``credible_interval_eta`` / ``credible_interval_state``.

With ``mesh=`` (:func:`_lgcp_sharded_impl`) the particle axis is sharded
over a ``torch.distributed`` mesh on the same slot semantics: the weight
scalars are all-reduced, the resample is the distributed systematic
resampler of ``parallel/sharded_filter.py`` and the order statistics come
from the bisection with its counts summed over the shards.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..models.model import Model
from ..models.params import params_to
from ..models.tree import Tree
from ..utils.data import TimeSeries
from . import resampling as rs
from .filter import (_resample_step, _weigh, credible_interval_eta,
                     credible_interval_state)


@dataclasses.dataclass(frozen=True)
class LgcpResult:
    """Per-observation filter output (reference ``PfOut`` + ``getIntervals``,
    ParticleFilter.scala:53-59, 415-424, 488-511)."""

    ll: torch.Tensor              # scalar
    ll_history: torch.Tensor      # [T]
    ess: torch.Tensor             # [T] int32
    eta_mean: torch.Tensor        # [T]  mean intensity exp(gamma)
    eta_lower: torch.Tensor       # [T]
    eta_upper: torch.Tensor       # [T]
    state_mean: torch.Tensor      # [T, d]
    state_lower: torch.Tensor     # [T, d]
    state_upper: torch.Tensor     # [T, d]
    final_particles: torch.Tensor  # [N, d]


def _interval_ks(n: int, interval: float):
    """Order-statistic (0-based sorted) indices for the eta and state
    interval flavours (ParticleFilter.scala:455-460 / :488-502), wrapped
    mod n as the JAX package's bisection selectors take them."""
    k_os = math.floor(n * interval)
    eta_ks = ((n - k_os) % n, min(k_os, n - 1))
    state_ks = ((n - k_os - 1) % n, (k_os - 1) % n)
    return eta_ks, state_ks


def _result_from_scan(ll, outs, xf) -> LgcpResult:
    """The per-observation outputs ``outs`` (one tuple per observation
    slot: ll, ESS, eta mean, lower, upper, state mean, lower, upper)
    stacked into a :class:`LgcpResult` with the final cloud ``xf [d, N]``."""
    return LgcpResult(ll, *(torch.stack(v) for v in zip(*outs)), xf.T)


def _lgcp_impl(model: Model, params: Tree, grid, n_particles: int,
               generator: torch.Generator, precision: int, scheme,
               interval: float) -> LgcpResult:
    """One pass over the union fine grid (slot semantics:
    ``_slot_body``, ``lgcp.py:68-135`` of the JAX package): the hazard is
    evaluated before the advance, the state advances by Euler-Maruyama
    after all but each segment's last substep, and a zero-dt observation
    weighs flat."""
    t_eval, t_obs = grid[0], grid[4]
    hflag, aflag, oflag, zflag = (f.tolist() for f in grid[1:4] + grid[5:6])
    device = generator.device
    params = params_to(params, device)
    sp = model.sde_params(params)
    sde = model.sde
    h = 10.0 ** (-precision)
    n = n_particles
    x = model.initial_state_t(params, generator, n)              # [d, N]
    n_obs = sum(oflag)
    uniforms = (torch.rand(n_obs, generator=generator, device=device)
                if scheme == "systematic" else [None] * n_obs)
    g_eval = model.design_vector(torch.as_tensor(t_eval, device=device))
    g_obs = model.design_vector(torch.as_tensor(t_obs, device=device))
    uniform_w = torch.full((n,), 1.0 / n, dtype=torch.float32, device=device)
    hz = torch.zeros(n, dtype=torch.float32, device=device)
    ll = torch.zeros((), dtype=torch.float32, device=device)
    outs = []
    for k in range(len(oflag)):
        if hflag[k]:
            hz = hz + torch.exp(g_eval[k] @ x) * h
        if aflag[k]:
            z = torch.randn(x.shape, generator=generator, device=device)
            x = sde.euler_maruyama(sp, x.T, h, z.T).T.contiguous()
        if not oflag[k]:
            continue
        gamma = g_obs[k] @ x
        logw = torch.zeros_like(gamma) if zflag[k] else gamma - hz   # :217
        inc, wn = _weigh(logw, uniform_w)
        ll = ll + inc
        ess = torch.floor(1.0 / torch.sum(wn * wn)).to(torch.int32)
        eta = torch.exp(gamma)
        e_lo, e_hi = credible_interval_eta(eta, interval)
        x, _ = _resample_step(scheme, generator, x, wn, uniforms[len(outs)])
        s_lo, s_hi = credible_interval_state(x.T, interval)
        outs.append((ll, ess, torch.mean(eta), e_lo, e_hi,
                     torch.mean(x, dim=1), s_lo, s_hi))
        hz = torch.zeros_like(hz)
    return _result_from_scan(ll, outs, x)


def _lgcp_sharded_impl(model: Model, params: Tree, grid, n_particles: int,
                       generator: torch.Generator, precision: int,
                       interval: float, mesh, axis: str) -> LgcpResult:
    """The particle-sharded pass over the union fine grid
    (``_lgcp_sharded_impl``, ``lgcp.py:210-296`` of the JAX package, on its
    ``_slot_body``): per observation slot the weight scalars' max and sums
    over the shards, the distributed systematic resample, the mean
    intensity and state summed over the shards and the bisection's order
    statistics at :func:`_interval_ks`'s indices.  Each shard draws its
    initial cloud and its Euler-Maruyama noise from its own stream; the
    resampling uniforms are shared.  ``final_particles`` is a sharded
    ``DTensor``."""
    from ..parallel.sharded_filter import (_as_sharded, _kth_smallest_sharded,
                                           _resample_t, _shard_generator,
                                           _Shards)

    t_eval, t_obs = grid[0], grid[4]
    hflag, aflag, oflag, zflag = (f.tolist() for f in grid[1:4] + grid[5:6])
    device = generator.device
    sh = _Shards(mesh, axis, device)
    if n_particles % sh.n:
        raise ValueError(
            f"n_particles={n_particles} not divisible by {sh.n} shards")
    local_n = n_particles // sh.n
    params = params_to(params, device)
    sp = model.sde_params(params)
    h = 10.0 ** (-precision)
    local = _shard_generator(generator, sh)
    x = model.initial_state_t(params, local, local_n)            # [d, m]
    uniforms = torch.rand(sum(oflag), generator=generator, device=device)
    eta_ks, state_ks = _interval_ks(n_particles, interval)
    ks = torch.tensor([list(eta_ks)] + [list(state_ks)] * model.dim,
                      dtype=torch.int32, device=device)
    g_eval = model.design_vector(torch.as_tensor(t_eval, device=device))
    g_obs = model.design_vector(torch.as_tensor(t_obs, device=device))
    hz = torch.zeros(local_n, dtype=torch.float32, device=device)
    ll = torch.zeros((), dtype=torch.float32, device=device)
    outs = []
    for k in range(len(oflag)):
        if hflag[k]:
            hz = hz + torch.exp(g_eval[k] @ x) * h
        if aflag[k]:
            z = torch.randn(x.shape, generator=local, device=device)
            x = model.sde.euler_maruyama(sp, x.T, h, z.T).T.contiguous()
        if not oflag[k]:
            continue
        gamma = g_obs[k] @ x
        logw = torch.zeros_like(gamma) if zflag[k] else gamma - hz   # :217
        maxw = sh.pmax(torch.amax(logw))
        w = torch.exp(logw - maxw)
        total = sh.psum(torch.sum(w))
        ll = ll + (maxw + torch.log(total / n_particles))
        wn = w / total
        ess = torch.floor(1.0 / sh.psum(torch.sum(wn * wn))).to(torch.int32)
        x = _resample_t(x, w, uniforms[len(outs)], sh)
        eta = torch.exp(gamma)
        sel = _kth_smallest_sharded(torch.cat([eta[None], x]), ks, sh)
        outs.append((ll, ess, sh.psum(torch.sum(eta)) / n_particles,
                     sel[0, 0], sel[0, 1],
                     sh.psum(torch.sum(x, dim=1)) / n_particles,
                     sel[1:, 0], sel[1:, 1]))
        hz = torch.zeros_like(hz)
    return LgcpResult(ll, *(torch.stack(v) for v in zip(*outs)),
                      _as_sharded(x.T, mesh, axis))


def lgcp_filter(model: Model, params: Tree, data: TimeSeries,
                n_particles: int, generator: torch.Generator, *,
                precision: int = 1, resample="systematic",
                interval: float = 0.975, mesh=None,
                axis: str | None = None) -> LgcpResult:
    """Particle filter for a log-Gaussian Cox process over event times.

    ``data.ts`` are the event (or grid) times; every datum contributes
    ``gamma - cumulative_hazard`` (ParticleFilter.scala:210-226).  Output
    summaries carry eta and state credible intervals (getIntervals,
    ParticleFilter.scala:415-424).  The fine grids (``ceil(dt/h)`` Euler
    substeps per gap, ``h = 10^-precision``) are flattened on the host into
    one union grid, so the work is O(sum of gaps / h).

    ``resample``: ``"systematic"`` (K1 + K4 on a card; ``"systematic-pallas"``
    is its JAX name), ``"stratified"``, ``"multinomial"`` (K7a + K7b +
    K4), ``"residual"``, ``"identity"`` or a ``(generator, weights) ->
    indices`` callable.  The filter runs on the generator's device.

    ``mesh=`` shards the particle axis over ``mesh[axis]`` (default axis
    :data:`~..parallel.mesh.PARTICLE_AXIS`) on every rank of the mesh,
    ``generator`` seeded alike on each: systematic resampling only, as
    ``bootstrap_filter(mesh=)``.
    """
    if mesh is not None:
        if resample != "systematic":
            raise ValueError(
                "lgcp_filter(mesh=...) supports resample='systematic' only "
                f"(got {resample!r}); the sharded path always resamples "
                "with the distributed systematic scheme")
        from ..parallel.mesh import PARTICLE_AXIS
        model.validate_params(params)
        grid = _build_fine_grid(data.ts.cpu().numpy().astype(np.float64),
                                precision)
        return _lgcp_sharded_impl(model, params, grid, n_particles,
                                  generator, precision, interval, mesh,
                                  axis or PARTICLE_AXIS)
    if not (callable(resample) or resample in rs._SCHEMES
            or resample == "systematic-pallas"):
        raise ValueError(f"unknown resampling scheme {resample!r}; choose "
                         f"from {sorted(rs._SCHEMES)} or "
                         "'systematic-pallas'")
    model.validate_params(params)
    grid = _build_fine_grid(data.ts.cpu().numpy().astype(np.float64),
                            precision)
    scheme = "systematic" if resample == "systematic-pallas" else resample
    return _lgcp_impl(model, params, grid, n_particles, generator, precision,
                      scheme, interval)


def _build_fine_grid(ts: np.ndarray, precision: int):
    """Flatten per-segment Euler substeps into one tagged union grid (the
    JAX package's ``_build_fine_grid``, ``lgcp.py:347``, on numpy).

    Returns ``(t_eval, hflag, aflag, oflag, t_obs, zflag, obs_idx)`` of
    length K = sum over segments of max(ceil(gap/h), 1): per slot the
    hazard-eval time, whether it contributes a hazard term, whether the
    state advances afterwards (all but each segment's last substep),
    whether it is a segment's observation slot, the observation time, and
    whether the segment is a zero-dt duplicate event; ``obs_idx`` indexes
    the observation slots.
    """
    n_obs = ts.shape[0]
    h = 10.0 ** (-precision)
    prev = np.concatenate([ts[:1], ts[:-1]])
    gaps = ts - prev
    # ceil(dt/h) with a tiny backoff so exact multiples of h do not round
    # up from float error (the reference computes this in double too)
    n_sub = np.where(gaps > 0,
                     np.ceil(gaps / h - 1e-9), 0).astype(np.int64)
    slots = np.maximum(n_sub, 1)          # zero-dt segments still need a slot
    ends = np.cumsum(slots)
    seg = np.repeat(np.arange(n_obs), slots)              # [K] obs index
    j = np.arange(ends[-1]) - np.repeat(ends - slots, slots)  # within-segment
    n_seg = n_sub[seg]

    f32 = np.float32
    return ((prev[seg] + j * h).astype(f32),               # t_eval
            n_seg > 0,                                     # hflag
            j < n_seg - 1,                                 # aflag
            j == slots[seg] - 1,                           # oflag
            ts[seg].astype(f32),                           # t_obs
            n_seg == 0,                                    # zflag
            ends - 1)                                      # obs_idx
