"""Continuous-time latent processes (SDEs).

PyTorch port of ``composablestatespacemodels_tpu/models/sde.py``: the three
reference SDE families (Sde.scala:69-163), their block-diagonal
composition (Sde.scala:204-240) and the Euler-Maruyama fallback
(Sde.scala:36-43).  Every reference family has an exact diagonal
affine-Gaussian transition ``x' = a*x + b + sqrt(q)*z``, so the port
derives its steps -- ``[N, d]`` for simulation, ``[d, N]`` for the filter
-- from :meth:`Sde.transition_coeffs` and :meth:`Sde.initial_moments`.
An SDE that defines only ``drift`` and ``diffusion`` (no
``transition_coeffs``; :attr:`Sde.exact` is False) steps by Euler-Maruyama
instead; in a composition each component takes its own step.  The kernels
(K2, K5, K8) and the Kalman filter need exact transitions and raise for
such an SDE.

``dt`` may be a 0-d tensor or a ``[T]`` tensor; with ``[T]`` the
coefficients come out ``[T, dim]``, which is how the filter computes all
per-step transitions in one batched pass.  Parameters may carry a leading
chain axis (record fields ``[B, k]``, PMMH's chains): the moments are then
``[B, dim]``, the initial cloud ``[B, dim, N]``, and ``dt[:, None]`` (``[T,
1]``) gives coefficients ``[T, B, dim]``.  Noise comes from an explicit
``torch.Generator`` on the state's device.
"""

from __future__ import annotations

import dataclasses

import torch

from . import bijectors
from .params import BrownianParams, GenBrownianParams, OuParams, param_repeat


def _dt(dt, like: torch.Tensor) -> torch.Tensor:
    """``dt`` as a float32 tensor broadcasting against ``[..., dim]``."""
    dt = torch.as_tensor(dt, dtype=torch.float32, device=like.device)
    return dt[..., None] if dt.ndim > 0 else dt


class Sde:
    """Base class: static spec (dimension + family)."""

    dim: int
    param_type: type

    def constrain(self, p):
        raise NotImplementedError

    def transition_coeffs(self, p, dt):
        """Exact transition x' = a*x + b + N(0, diag(q)) over ``dt``.

        Returns ``(a, b, q)``, each ``[dim]`` for a scalar ``dt`` and
        ``[T, dim]`` for ``dt`` of shape ``[T]``.  Raises for an SDE
        without an exact linear-Gaussian transition.
        """
        raise NotImplementedError(
            f"{type(self).__name__} has no exact linear-Gaussian transition")

    @property
    def exact(self) -> bool:
        """Whether the SDE has an exact transition (defines
        :meth:`transition_coeffs`); otherwise it steps by Euler-Maruyama."""
        return type(self).transition_coeffs is not Sde.transition_coeffs

    def initial_moments(self, p):
        """Mean and diagonal variance of the initial state, ``(m0, c0)``."""
        raise NotImplementedError

    def drift(self, p, x):
        raise NotImplementedError

    def diffusion(self, p, x):
        raise NotImplementedError

    def euler_maruyama(self, p, x, dt, z):
        """``x + a(x) dt + b(x) sqrt(dt) z`` on ``x [..., dim]`` with the
        normals ``z`` given (Sde.scala:36-43)."""
        dtb = _dt(dt, x)
        return (x + self.drift(p, x) * dtb
                + self.diffusion(p, x) * torch.sqrt(dtb) * z)

    def step_euler_maruyama(self, p, generator: torch.Generator, x, dt):
        """x + a(x) dt + b(x) dW,  dW ~ N(0, dt I)."""
        z = torch.randn(x.shape, generator=generator, device=x.device)
        return self.euler_maruyama(p, x, dt, z)

    def validate(self, p) -> None:
        if not isinstance(p, self.param_type):
            raise TypeError(
                f"{type(self).__name__} expects {self.param_type.__name__}, "
                f"got {type(p).__name__}")

    # -- [..., dim] layout (simulation) ----------------------------------------

    def initial_state(self, p, generator: torch.Generator, shape=()):
        m0, c0 = self.initial_moments(p)
        z = torch.randn(tuple(shape) + (self.dim,), generator=generator,
                        device=m0.device)
        return m0 + torch.sqrt(c0) * z

    def step(self, p, generator: torch.Generator, x, dt):
        """The exact transition, or Euler-Maruyama without one
        (Sde.scala:23-25)."""
        if not self.exact:
            return self.step_euler_maruyama(p, generator, x, dt)
        a, b, q = self.transition_coeffs(p, dt)
        z = torch.randn(x.shape, generator=generator, device=x.device)
        return a * x + b + torch.sqrt(q) * z

    def simulate(self, p, generator: torch.Generator, t0: float, dt,
                 n_steps: int, x0=None):
        """A regular-grid path: ``(ts [n+1], xs [n+1, dim])`` including the
        initial state (Sde.scala:45-66)."""
        x = self.initial_state(p, generator) if x0 is None else x0
        xs = [x]
        for _ in range(n_steps):
            x = self.step(p, generator, x, dt)
            xs.append(x)
        ts = t0 + dt * torch.arange(n_steps + 1, dtype=torch.float32,
                                    device=x.device)
        return ts, torch.stack(xs)

    # -- transposed [dim, N] layout (the filter's cloud) -----------------------

    def initial_state_t(self, p, generator: torch.Generator, n: int):
        """The initial cloud ``[dim, N]`` (``[B, dim, N]`` for chains)."""
        m0, c0 = self.initial_moments(p)
        z = torch.randn(m0.shape + (n,), generator=generator,
                        device=m0.device)
        return m0[..., None] + torch.sqrt(c0)[..., None] * z

    def step_t(self, p, generator: torch.Generator, x_t, dt):
        """One step of a ``[dim, N]`` particle block (scalar dt): the exact
        transition, or Euler-Maruyama on the transposed block (``drift``
        and ``diffusion`` see ``[N, dim]``)."""
        if not self.exact:
            return self.step_euler_maruyama(p, generator, x_t.T,
                                            dt).T.contiguous()
        a, b, q = self.transition_coeffs(p, dt)
        z = torch.randn(x_t.shape, generator=generator, device=x_t.device)
        return (a[..., None] * x_t + b[..., None]
                + torch.sqrt(q)[..., None] * z)


@dataclasses.dataclass(frozen=True)
class Brownian(Sde):
    """x' ~ N(x, sigma*dt); ``sigma`` is the variance rate (Sde.scala:114-123)."""

    dim: int
    param_type = BrownianParams

    def constrain(self, p: BrownianParams):
        return (param_repeat(p.m0, self.dim),
                torch.exp(param_repeat(p.c0, self.dim)),
                torch.exp(param_repeat(p.sigma, self.dim)))

    def transition_coeffs(self, p, dt):
        _, _, sigma = self.constrain(p)
        q = sigma * _dt(dt, sigma)
        return torch.ones_like(q), torch.zeros_like(q), q

    def initial_moments(self, p):
        m0, c0, _ = self.constrain(p)
        return m0, c0

    def drift(self, p, x):
        # zero, where the reference's unused EM drift is 1.0 (Sde.scala:110)
        return torch.zeros_like(x)

    def diffusion(self, p, x):
        # sqrt of the variance rate, so EM matches the exact transition
        _, _, sigma = self.constrain(p)
        return torch.broadcast_to(torch.sqrt(sigma), x.shape)


@dataclasses.dataclass(frozen=True)
class GenBrownian(Sde):
    """x' ~ N(x + mu*dt, sigma*dt).  Reference: Sde.scala:69-95."""

    dim: int
    param_type = GenBrownianParams

    def constrain(self, p: GenBrownianParams):
        return (param_repeat(p.m0, self.dim),
                torch.exp(param_repeat(p.c0, self.dim)),
                param_repeat(p.mu, self.dim),
                torch.exp(param_repeat(p.sigma, self.dim)))

    def transition_coeffs(self, p, dt):
        _, _, mu, sigma = self.constrain(p)
        dtb = _dt(dt, mu)
        b = mu * dtb
        return torch.ones_like(b), b, sigma * dtb

    def initial_moments(self, p):
        m0, c0, _, _ = self.constrain(p)
        return m0, c0

    def drift(self, p, x):
        _, _, mu, _ = self.constrain(p)
        return torch.broadcast_to(mu, x.shape)

    def diffusion(self, p, x):
        _, _, _, sigma = self.constrain(p)
        return torch.broadcast_to(torch.sqrt(sigma), x.shape)


@dataclasses.dataclass(frozen=True)
class Ou(Sde):
    """Ornstein-Uhlenbeck with exact mean-reverting transition:
    a = exp(-phi dt), b = mu (1 - a), q = sigma^2/(2 phi) (1 - exp(-2 phi dt)).
    Reference: Sde.scala:129-163."""

    dim: int
    param_type = OuParams

    def constrain(self, p: OuParams):
        return (param_repeat(p.m0, self.dim),
                torch.exp(param_repeat(p.c0, self.dim)),
                bijectors.logistic(param_repeat(p.phi, self.dim)),
                param_repeat(p.mu, self.dim),
                torch.exp(param_repeat(p.sigma, self.dim)))

    def variance(self, p, dt):
        """Transition variance sigma^2/(2 phi) (1 - exp(-2 phi dt))."""
        _, _, phi, _, sigma = self.constrain(p)
        dtb = _dt(dt, phi)
        return (sigma * sigma) / (2.0 * phi) * (1.0 - torch.exp(-2.0 * phi * dtb))

    def transition_coeffs(self, p, dt):
        _, _, phi, mu, _ = self.constrain(p)
        a = torch.exp(-phi * _dt(dt, phi))
        return a, mu * (1.0 - a), self.variance(p, dt)

    def initial_moments(self, p):
        m0, c0, _, _, _ = self.constrain(p)
        return m0, c0

    def drift(self, p, x):
        _, _, phi, mu, _ = self.constrain(p)
        return phi * (mu - x)

    def diffusion(self, p, x):
        _, _, _, _, sigma = self.constrain(p)
        return torch.broadcast_to(sigma, x.shape)


@dataclasses.dataclass(frozen=True)
class CompositeSde(Sde):
    """Block-diagonal composition; parameters are a ``(left, right)`` tuple.
    Each component owns a contiguous slice of the flat state."""

    left: Sde
    right: Sde

    param_type = tuple

    @property
    def dim(self) -> int:
        return self.left.dim + self.right.dim

    @property
    def exact(self) -> bool:
        return self.left.exact and self.right.exact

    def validate(self, p) -> None:
        if not (isinstance(p, tuple) and len(p) == 2):
            raise TypeError("CompositeSde expects a (left, right) parameter tuple")
        self.left.validate(p[0])
        self.right.validate(p[1])

    def _split(self, x, axis: int):
        return (x.narrow(axis, 0, self.left.dim),
                x.narrow(axis, self.left.dim, self.right.dim))

    def step(self, p, generator, x, dt):
        """Each component its own step (exact or Euler-Maruyama) on its
        slice of ``[..., dim]``; one batched exact step when both are
        exact."""
        if self.exact:
            return super().step(p, generator, x, dt)
        xl, xr = self._split(x, -1)
        return torch.cat([self.left.step(p[0], generator, xl, dt),
                          self.right.step(p[1], generator, xr, dt)], dim=-1)

    def step_t(self, p, generator, x_t, dt):
        if self.exact:
            return super().step_t(p, generator, x_t, dt)
        xl, xr = self._split(x_t, 0)
        return torch.cat([self.left.step_t(p[0], generator, xl, dt),
                          self.right.step_t(p[1], generator, xr, dt)], dim=0)

    def drift(self, p, x):
        xl, xr = self._split(x, -1)
        return torch.cat([self.left.drift(p[0], xl),
                          self.right.drift(p[1], xr)], dim=-1)

    def diffusion(self, p, x):
        xl, xr = self._split(x, -1)
        return torch.cat([self.left.diffusion(p[0], xl),
                          self.right.diffusion(p[1], xr)], dim=-1)

    def transition_coeffs(self, p, dt):
        left = self.left.transition_coeffs(p[0], dt)
        right = self.right.transition_coeffs(p[1], dt)
        return tuple(torch.cat([l, r], dim=-1) for l, r in zip(left, right))

    def initial_moments(self, p):
        ml, cl = self.left.initial_moments(p[0])
        mr, cr = self.right.initial_moments(p[1])
        return torch.cat([ml, mr], dim=-1), torch.cat([cl, cr], dim=-1)


def brownian_motion(dim: int) -> Brownian:
    return Brownian(dim)


def gen_brownian_motion(dim: int) -> GenBrownian:
    return GenBrownian(dim)


def ou_process(dim: int) -> Ou:
    return Ou(dim)


def compose_sde(left: Sde, right: Sde) -> CompositeSde:
    """``sde1 |+| sde2``: independent block-diagonal composition."""
    return CompositeSde(left, right)
