"""Continuous-time latent processes (SDEs) with exact Gaussian transitions.

PyTorch port of ``composablestatespacemodels_tpu/models/sde.py``: the three
reference SDE families (Sde.scala:69-163) and their block-diagonal
composition (Sde.scala:204-240).  Every family has an exact diagonal
affine-Gaussian transition ``x' = a*x + b + sqrt(q)*z``, so the port
derives every step -- ``[N, d]`` for simulation, ``[d, N]`` for the filter
-- from :meth:`Sde.transition_coeffs` and :meth:`Sde.initial_moments`.
The Euler-Maruyama fallback of the JAX package waits for the rest of the
filter (ROADMAP Queue 1 item 6).

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
        ``[T, dim]`` for ``dt`` of shape ``[T]``.
        """
        raise NotImplementedError

    def initial_moments(self, p):
        """Mean and diagonal variance of the initial state, ``(m0, c0)``."""
        raise NotImplementedError

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
        a, b, q = self.transition_coeffs(p, dt)
        z = torch.randn(x.shape, generator=generator, device=x.device)
        return a * x + b + torch.sqrt(q) * z

    # -- transposed [dim, N] layout (the filter's cloud) -----------------------

    def initial_state_t(self, p, generator: torch.Generator, n: int):
        """The initial cloud ``[dim, N]`` (``[B, dim, N]`` for chains)."""
        m0, c0 = self.initial_moments(p)
        z = torch.randn(m0.shape + (n,), generator=generator,
                        device=m0.device)
        return m0[..., None] + torch.sqrt(c0)[..., None] * z

    def step_t(self, p, generator: torch.Generator, x_t, dt):
        """Exact transition on a ``[dim, N]`` particle block (scalar dt)."""
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

    def transition_coeffs(self, p, dt):
        _, _, phi, mu, sigma = self.constrain(p)
        dtb = _dt(dt, phi)
        a = torch.exp(-phi * dtb)
        b = mu * (1.0 - a)
        q = (sigma * sigma) / (2.0 * phi) * (1.0 - torch.exp(-2.0 * phi * dtb))
        return a, b, q

    def initial_moments(self, p):
        m0, c0, _, _, _ = self.constrain(p)
        return m0, c0


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

    def validate(self, p) -> None:
        if not (isinstance(p, tuple) and len(p) == 2):
            raise TypeError("CompositeSde expects a (left, right) parameter tuple")
        self.left.validate(p[0])
        self.right.validate(p[1])

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
