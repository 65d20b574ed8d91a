"""Ornstein-Uhlenbeck latent process, plain torch (Sde.scala:129-163).

Parameters are held unconstrained, as the system under test holds them:
``m0`` the initial mean, ``c0`` the log of the initial variance, ``phi``
the logit of the mean-reversion rate, ``mu`` the level, ``sigma`` the log
of the diffusion.  The configuration files state them on their natural
scale (:func:`unconstrain`).  Each field is ``[..., k]`` and is recycled
cyclically to the process's dimension.  The exact transition
over ``dt`` is ``x' = a x + b + sqrt(q) z`` with ``a = exp(-phi dt)``,
``b = mu (1 - a)`` and ``q = sigma^2 / (2 phi) (1 - exp(-2 phi dt))``.
"""

from __future__ import annotations

import torch

FIELDS = ("m0", "c0", "phi", "mu", "sigma")


def unconstrain(natural: dict) -> dict:
    """The natural values of a configuration file (variance, rate in
    (0, 1), diffusion) on the unconstrained scale."""
    return {"m0": natural["m0"], "c0": torch.log(natural["c0"]),
            "phi": torch.logit(natural["phi"]), "mu": natural["mu"],
            "sigma": torch.log(natural["sigma"])}


def _repeat(v: torch.Tensor, dim: int) -> torch.Tensor:
    idx = torch.arange(dim, device=v.device) % v.shape[-1]
    return v[..., idx]


def _constrained(p: dict, dim: int):
    m0, c0, phi, mu, sigma = (_repeat(p[f], dim) for f in FIELDS)
    return m0, torch.exp(c0), torch.sigmoid(phi), mu, torch.exp(sigma)


def initial_moments(p: dict, dim: int):
    """``(mean, variance)``, each ``[..., dim]``."""
    m0, c0, _, _, _ = _constrained(p, dim)
    return m0, c0


def transition(p: dict, dim: int, dt: torch.Tensor):
    """``(a, b, q)`` for every ``dt``: ``dt [T]`` and fields ``[..., k]``
    give ``[T, ..., dim]``."""
    _, _, phi, mu, sigma = _constrained(p, dim)
    dt = dt.to(phi.device, phi.dtype).reshape(dt.shape + (1,) * phi.ndim)
    a = torch.exp(-phi * dt)
    q = sigma * sigma / (2.0 * phi) * (1.0 - torch.exp(-2.0 * phi * dt))
    return a, mu * (1.0 - a), q
