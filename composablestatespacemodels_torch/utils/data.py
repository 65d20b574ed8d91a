"""Time-series containers and forward simulation.

PyTorch port of ``TimeSeries``, ``SimulatedData``, ``simulate`` and
``simulate_regular`` from ``composablestatespacemodels_tpu/utils/data.py``
(reference: Data.scala).  A time series is ``(ts, ys, mask)``: irregular
times and missing observations are data.  Simulation draws from an
explicit ``torch.Generator``; the data lands on the generator's device.
"""

from __future__ import annotations

import dataclasses

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
