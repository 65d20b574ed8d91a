"""The plain bootstrap particle filter that every cell is held against.

Straight from its definition (ParticleFilter.scala:100-166): draw the
initial cloud, and at every observation propagate it by the exact
transition, weigh it by the observation's density, add
``log mean(w)`` to the log-likelihood, and resample it systematically
(one uniform, ``searchsorted`` on the normalised cumulative weights).
Summaries are taken of the resampled cloud with ``torch.sort``.  Its
random numbers are its own (``torch.randn`` and ``torch.rand`` from the
generator it is given), so it agrees with the system under test in
distribution, not draw by draw.

``dtype`` sets the precision of every tensor of the filter but one:
``torch.float32`` is the reference, ``torch.bfloat16`` its control.  The
cumulative weights that resampling searches, and its uniforms, are float64
in both: a float32 ``cumsum`` over millions of weights drifts by many
times ``1 / N``, and since resampling keeps the cloud in ancestor order
that drift favours one end of the cloud.  On the flagship series at
N = 2^24 - 2^12 a float32 cumulative sum moved the reference's
log-likelihood by +0.24, twenty times its spread.
"""

from __future__ import annotations

import math

import torch

from .model import RefModel


def _dts(ts: torch.Tensor, t0) -> torch.Tensor:
    start = ts[:1] if t0 is None else torch.full_like(ts[:1], float(t0))
    return ts - torch.cat([start, ts[:-1]])


def _order_indices(n: int, interval: float):
    """Sorted positions of the state and eta bounds: the reference's
    ``credible_interval_state`` / ``credible_interval_eta``
    (ParticleFilter.scala:478-502)."""
    k = math.floor(n * interval)
    return ((n - k - 1) % n, (k - 1) % n), (min(n - k, n - 1), min(k, n - 1))


def filter_one(model: RefModel, params: list, ts, ys, n: int,
               generator: torch.Generator, *, t0=None,
               dtype=torch.float32, summary_steps=(), interval=0.975):
    """One parameter set, cloud ``[d, n]``.  Returns ``(ll, incs [T],
    summaries)``: the log-likelihood and its per-step increments as
    float64 host values, and for each step in ``summary_steps`` a float64
    host tensor ``[3 + 3 d]``: eta mean, lower, upper, then the state's
    means, lowers and uppers."""
    dev = generator.device
    ts64 = torch.as_tensor(ts, dtype=torch.float64)
    dts = _dts(ts64, t0)
    steps = dts.tolist()
    design = model.design(ts64).to(dev, dtype)
    a, b, q = (v.to(dev, dtype) for v in model.transition(params, dts))
    sq = torch.sqrt(q)
    mean, var = (v.to(dev, dtype) for v in model.initial_moments(params))
    scale = model.obs_scale(params)
    scale = None if scale is None else scale.to(dev, dtype)
    ys_d = torch.as_tensor(ys).to(dev, dtype)
    d = model.dim
    x = mean[:, None] + torch.sqrt(var)[:, None] * torch.randn(
        (d, n), generator=generator, device=dev, dtype=dtype)
    ramp = torch.arange(n, device=dev, dtype=torch.float64)
    want = set(int(s) for s in summary_steps)
    (s_lo, s_hi), (e_lo, e_hi) = _order_indices(n, interval)
    ll = torch.zeros((), device=dev, dtype=dtype)
    incs, summaries = [], {}
    for i, dt in enumerate(steps):
        if dt != 0.0:
            x = a[i, :, None] * x + b[i, :, None] + sq[i, :, None] * torch.randn(
                (d, n), generator=generator, device=dev, dtype=dtype)
        logw = model.obs.log_density(design[i] @ x, ys_d[i], scale)
        m = torch.max(logw)
        w = torch.exp(logw - m)
        total = torch.sum(w)
        inc = m + torch.log(total) - math.log(n)
        ll = ll + inc
        incs.append(inc)
        cdf = torch.cumsum(w.double(), dim=0)
        cdf = cdf / cdf[-1]
        u = (torch.rand((), generator=generator, device=dev,
                        dtype=torch.float64) + ramp) / n
        idx = torch.clamp(torch.searchsorted(cdf, u), max=n - 1)
        x = x[:, idx]
        if i in want:
            eta = model.obs.link(design[i] @ x)
            s = torch.sort(torch.cat([x, eta[None]]), dim=1).values
            state_mean = torch.mean(x, dim=1)
            summaries[i] = torch.cat([
                model.obs.link(design[i] @ state_mean)[None],
                s[d, e_lo][None], s[d, e_hi][None],
                state_mean, s[:d, s_lo], s[:d, s_hi]]).double().cpu()
    return (float(ll), torch.stack(incs).double().cpu(), summaries)


def ll_chains(model: RefModel, params_b: list, ts, ys, n: int,
              generator: torch.Generator, *, dtype=torch.float32,
              block: int = 8192) -> torch.Tensor:
    """The log-likelihood of each of ``B`` parameter sets (every field with
    a leading axis ``B``), clouds ``[B, d, n]`` in blocks of ``block``
    sets.  Returns ``[B]`` float64 on the host."""
    dev = generator.device
    ts64 = torch.as_tensor(ts, dtype=torch.float64)
    dts = _dts(ts64, None)
    steps = dts.tolist()
    design = model.design(ts64).to(dev, dtype)
    ys_d = torch.as_tensor(ys).to(dev, dtype)
    n_sets = next(iter(params_b[0]["sde"].values())).shape[0]
    out = []
    for lo in range(0, n_sets, block):
        part = [{"scale": None if p["scale"] is None
                 else p["scale"][lo:lo + block],
                 "sde": {k: v[lo:lo + block] for k, v in p["sde"].items()}}
                for p in params_b]
        out.append(_ll_block(model, part, steps, dts, design, ys_d, n,
                             generator, dtype))
    return torch.cat(out)


def _ll_block(model, params, steps, dts, design, ys_d, n, generator, dtype):
    dev = generator.device
    a, b, q = (v.to(dev, dtype) for v in model.transition(params, dts))
    sq = torch.sqrt(q)                                         # [T, B, d]
    mean, var = (v.to(dev, dtype) for v in model.initial_moments(params))
    scale = model.obs_scale(params)
    scale = None if scale is None else scale.to(dev, dtype)[:, None]
    bsz, d = mean.shape
    x = mean[..., None] + torch.sqrt(var)[..., None] * torch.randn(
        (bsz, d, n), generator=generator, device=dev, dtype=dtype)
    ramp = torch.arange(n, device=dev, dtype=torch.float64)
    ll = torch.zeros(bsz, device=dev, dtype=dtype)
    for i, dt in enumerate(steps):
        if dt != 0.0:
            x = (a[i, :, :, None] * x + b[i, :, :, None]
                 + sq[i, :, :, None] * torch.randn(
                     (bsz, d, n), generator=generator, device=dev,
                     dtype=dtype))
        gamma = torch.einsum("d,bdn->bn", design[i], x)
        logw = model.obs.log_density(gamma, ys_d[i], scale)
        m = torch.amax(logw, dim=1, keepdim=True)
        w = torch.exp(logw - m)
        total = torch.sum(w, dim=1, keepdim=True)
        ll = ll + (m + torch.log(total)).squeeze(1) - math.log(n)
        cdf = torch.cumsum(w.double(), dim=1)
        cdf = cdf / cdf[:, -1:]
        u = (torch.rand((bsz, 1), generator=generator, device=dev,
                        dtype=torch.float64) + ramp) / n
        idx = torch.clamp(torch.searchsorted(cdf, u), max=n - 1)
        x = torch.gather(x, 2, idx[:, None, :].expand(bsz, d, n))
    return ll.double().cpu()
