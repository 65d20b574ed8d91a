"""Time-series containers and forward simulation.

PyTorch port of ``TimeSeries``, ``SimulatedData``, ``simulate``,
``simulate_regular``, ``simulate_sde_grid`` and ``simulate_lgcp`` from
``composablestatespacemodels_tpu/utils/data.py`` (reference: Data.scala).
A time series is ``(ts, ys, mask)``: irregular times and missing
observations are data.  Simulation draws from an explicit
``torch.Generator``; the data lands on the generator's device.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..models.params import params_to


@dataclasses.dataclass(frozen=True)
class TimeSeries:
    """Observations y(t_i) with missing values (``ys`` is 0.0 where
    ``mask`` is False -- the reference's ``None`` observation)."""

    ts: torch.Tensor    # [T] float32 observation times
    ys: torch.Tensor    # [T] float32 observation values
    mask: torch.Tensor  # [T] bool, True where an observation is present

    def __len__(self):
        return int(self.ts.shape[0])

    def knock_out(self, t_lo: float, t_hi: float) -> "TimeSeries":
        """Mark observations with t in [t_lo, t_hi] as missing
        (Interpolate.scala:31-34)."""
        drop = (self.ts >= t_lo) & (self.ts <= t_hi)
        return TimeSeries(self.ts, torch.where(drop, 0.0, self.ys),
                          self.mask & ~drop)


@dataclasses.dataclass(frozen=True)
class SimulatedData:
    """Full generative trace (ObservationWithState, Data.scala:31-36)."""

    ts: torch.Tensor      # [T]
    ys: torch.Tensor      # [T]
    etas: torch.Tensor    # [T]
    gammas: torch.Tensor  # [T]
    xs: torch.Tensor      # [T, dim]

    def __len__(self):
        return int(self.ts.shape[0])

    def to_timeseries(self) -> TimeSeries:
        return TimeSeries(self.ts, self.ys,
                          torch.ones(self.ts.shape, dtype=torch.bool,
                                     device=self.ts.device))


def simulate(model, params, generator: torch.Generator, ts) -> SimulatedData:
    """Simulate a POMP model at the given times (Data.scala:64-100).

    The first time draws the initial state; later times advance the
    transition over ``dt = t_i - t_{i-1}``: the exact one with every
    step's coefficients and normals drawn in one batched pass, or step by
    step where an SDE has none (Euler-Maruyama).  The observations of every
    step come from the family's sampler in one call after the latent path.
    """
    model.validate_params(params)
    device = generator.device
    params = params_to(params, device)
    ts = torch.as_tensor(ts, dtype=torch.float32).to(device)
    sp = model.sde_params(params)
    x = model.initial_state(params, generator)
    xs = [x]
    if model.sde.exact:
        a, b, q = model.sde.transition_coeffs(sp, ts[1:] - ts[:-1])
        s = torch.sqrt(q)
        z = torch.randn((ts.shape[0] - 1, model.dim), generator=generator,
                        device=device)
        for i in range(ts.shape[0] - 1):
            x = a[i] * x + b[i] + s[i] * z[i]
            xs.append(x)
    else:
        for i in range(ts.shape[0] - 1):
            x = model.step(params, generator, x, ts[i + 1] - ts[i])
            xs.append(x)
    xs = torch.stack(xs)
    gammas = (xs * model.design_vector(ts)).sum(dim=-1)
    ys = model.sample_obs(generator, params, gammas)
    return SimulatedData(ts, ys, model.link(gammas), gammas, xs)


def simulate_regular(model, params, generator: torch.Generator, n: int,
                     dt: float = 0.1, t0: float = 0.0) -> SimulatedData:
    """Regular-grid simulation from t0 (reference default dt: Data.scala:54)."""
    ts = t0 + dt * torch.arange(n, dtype=torch.float32)
    return simulate(model, params, generator, ts)


def simulate_sde_grid(sde, sde_params, generator: torch.Generator, x0,
                      t0: float, total: float, precision: int):
    """Fine-grid SDE path with step 10^-precision from ``(t0, x0)``:
    ``(ts [n+1], xs [n+1, dim])`` (SimulateData.simSdeStream,
    Data.scala:162-176)."""
    dt = 10.0 ** (-precision)
    n = int(math.floor(total / dt + 1e-9))
    return sde.simulate(sde_params, generator, t0, dt, n, x0=x0)


def simulate_lgcp(model, params, generator: torch.Generator, start: float,
                  end: float, precision: int = 2):
    """Simulate a log-Gaussian Cox process by thinning
    (SimulateData.simLGCP, Data.scala:110-149).

    The fine-grid latent path and its hazards are computed on the
    generator's device; the accept/reject loop over exponential candidate
    times runs on the host (numpy, seeded from the generator).  Returns
    ``(events, grid)``: the accepted event times as :class:`SimulatedData`
    (y = 1.0) and the fine-grid trace (y = 0.0)."""
    model.validate_params(params)
    device = generator.device
    params = params_to(params, device)
    x0 = model.initial_state(params, generator)
    ts, xs = simulate_sde_grid(model.sde, model.sde_params(params),
                               generator, x0, start, end - start, precision)
    gammas = (xs * model.design_vector(ts)).sum(dim=-1)

    ts_np, xs_np, gam_np = (v.cpu().numpy() for v in (ts, xs, gammas))
    upper = float(np.exp(gam_np).max())
    seed = int(torch.randint(0, 2 ** 62, (), generator=generator,
                             device=device))
    rng = np.random.default_rng(seed)
    events_t, events_g, events_x = [], [], []
    t = float(start)
    while True:
        t = t + rng.exponential(1.0 / upper)
        if t > end:
            break
        idx = int(np.searchsorted(ts_np, t, side="right") - 1)
        hazard = gam_np[idx]
        if rng.uniform() <= np.exp(hazard) / upper:
            events_t.append(t)
            events_g.append(hazard)
            events_x.append(xs_np[idx])

    def f32(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=device)

    g = f32(events_g)
    events = SimulatedData(
        f32(events_t), torch.ones(len(events_t), device=device),
        torch.exp(g), g,
        f32(events_x if events_t else np.zeros((0, model.dim))))
    grid = SimulatedData(ts, torch.zeros_like(ts), torch.exp(gammas), gammas,
                         xs)
    return events, grid
