"""Bootstrap particle filter: the fused ``[d, N]`` path.

PyTorch port of ``_filter_impl_t_fused`` (:494), ``bootstrap_filter``
(:784) and ``log_likelihood`` (:868) of
``composablestatespacemodels_tpu/inference/filter.py``.  The carried cloud
is always already propagated to the current observation time.  Each
observed step weights it (``ll += max + log(total)``,
ParticleFilter.scala:124-127), then two kernels run:

* K1 (:func:`..ops.scan_kernel.systematic_counts_fused`) builds the
  systematic counts from the normalised weights;
* K2 + K3 (:func:`..ops.resample_kernel.resample_propagate`) resamples,
  applies the exact transition to the next observation time with
  in-kernel noise, and writes the next step's log-weights.

Every per-step input (transition coefficients, design vector, observation
constants, uniforms, seeds) is computed in one batched pass before the
loop, the mask is read on the host once, and ``ll``/``ess`` stay on the
device until the end: the loop body only slices and launches, and never
waits for the device.  A missing observation propagates with plain torch
ops and carries the weights (ParticleFilter.scala:120-121).  The last step
uses ``dt = 0``, an identity transition, so ``final_particles`` is the
filtering cloud at the last time.

The resample scheme is named ``"systematic-fused"``.  The other schemes,
store modes, the ESS trigger, forecasting and the Euler-Maruyama path are
ROADMAP Queue 1 item 6.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..models.model import Model
from ..models.observation import KERNEL_CONSTS
from ..models.params import params_to
from ..models.tree import Tree
from ..ops.resample_kernel import resample_propagate
from ..ops.scan_kernel import systematic_counts_fused
from ..utils.data import TimeSeries

_SCHEME = "systematic-fused"
_LATER = ("is not ported yet (ROADMAP.md Queue 1 item 6); the PyTorch port "
          f"runs resample={_SCHEME!r} with store='ll' and always-resample")


@dataclasses.dataclass(frozen=True)
class FilterResult:
    """Output of :func:`bootstrap_filter` (reference ``PfState``,
    ParticleFilter.scala:32-37)."""

    ll: torch.Tensor               # scalar
    ll_history: torch.Tensor       # [T]
    ess: torch.Tensor              # [T] int32
    final_particles: torch.Tensor  # [N, d]


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


def _weights(model, params, x_t, t, y, mask):
    return model.log_density(params, model.f_t(x_t, t),
                             torch.where(mask, y, 0.0))


def _filter_impl_t_fused(model: Model, params: Tree, data: TimeSeries,
                         n_particles: int, generator: torch.Generator,
                         t0, x_init) -> FilterResult:
    device = generator.device
    wspec = model.obs.kernel_log_density()
    if wspec is None:
        raise NotImplementedError(
            f"{type(model.obs).__name__} has no kernel weight hook: {_LATER}")
    make_consts, family_id = wspec
    params = params_to(params, device)
    sp = model.sde_params(params)
    d, n = model.dim, n_particles
    ts, ys, mask = data.ts, data.ys, data.mask
    observed = mask.tolist()  # host copy, read once
    n_steps = len(observed)

    if x_init is None:
        x = model.initial_state_t(params, generator, n)
    else:
        x_init = torch.as_tensor(x_init, dtype=torch.float32, device=device)
        x = (x_init[:, None].expand(d, n) if x_init.ndim == 1
             else x_init.T).contiguous()
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
            maxw = torch.max(logw)
            u = wn * torch.exp(logw - maxw)
            total = torch.sum(u)
            ll = ll + (maxw + torch.log(total))
            wn1 = u / total
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


def bootstrap_filter(model: Model, params: Tree, data: TimeSeries,
                     n_particles: int, generator: torch.Generator, *,
                     resample: str = _SCHEME,
                     t0: Optional[float] = None,
                     initial_state=None,
                     store="ll",
                     ess_threshold: Optional[float] = None) -> FilterResult:
    """Run the bootstrap particle filter over a time series.

    Args:
      model: a (possibly composed) model with exact transitions and a
        Gaussian or Poisson observation family.
      params: parameter tree matching the model composition.
      data: observations on the generator's device.
      n_particles: N.
      generator: ``torch.Generator`` for every random draw; the filter
        runs on its device (CUDA kernels on a card, their plain PyTorch
        versions on the CPU).
      resample: ``"systematic-fused"``.
      t0: start time (default: the first observation time).
      initial_state: optional fixed initial state ``[d]`` or cloud ``[N, d]``.
      store: ``"ll"`` (or None).
      ess_threshold: must be None (always resample).
    """
    if resample != _SCHEME:
        raise NotImplementedError(f"resample={resample!r} {_LATER}")
    if store not in ("ll", None):
        raise NotImplementedError(f"store={store!r} {_LATER}")
    if ess_threshold is not None:
        raise NotImplementedError(f"ess_threshold={ess_threshold!r} {_LATER}")
    if data.ts.device != generator.device:
        raise ValueError(f"data on {data.ts.device} but generator on "
                         f"{generator.device}")
    model.validate_params(params)
    return _filter_impl_t_fused(model, params, data, n_particles, generator,
                                t0, initial_state)


def log_likelihood(model: Model, params: Tree, data: TimeSeries,
                   n_particles: int, generator: torch.Generator, *,
                   resample: str = _SCHEME, **kwargs) -> torch.Tensor:
    """Log marginal-likelihood estimate only (reference ``llFilter``,
    ParticleFilter.scala:137-140)."""
    return bootstrap_filter(model, params, data, n_particles, generator,
                            resample=resample, store="ll", **kwargs).ll
