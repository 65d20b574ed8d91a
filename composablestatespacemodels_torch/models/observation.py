"""Observation families: link functions, log-densities, samplers and the
in-kernel weight hook.

PyTorch port of the Gaussian and Poisson families of
``composablestatespacemodels_tpu/models/observation.py``
(reference: Model.scala:241-274).  The other seven families wait for
ROADMAP Queue 1 item 6.

``kernel_log_density()`` returns ``(make_consts, family_id)``:

* ``make_consts(y, scale)`` is torch, runs outside the kernel and returns
  the per-step constants ``[..., k]`` (k <= 8) over the broadcast shape of
  ``y`` and ``scale``: ``y [T]`` builds every step's constants in one pass,
  and ``y[:, None]`` against a chain-batched ``scale [B]`` gives ``[T, B,
  k]``, the layout of K8;
* ``family_id`` selects the matching ``__device__`` function in
  ``csrc/obs_density.cuh`` inside the fused resample kernel (K3), and the
  torch twin :func:`kernel_fn` in the kernel's plain version.  Both
  compute exactly :meth:`ObservationFamily.log_density`.
"""

from __future__ import annotations

import dataclasses

import torch

_HALF_LOG_2PI = 0.9189385332046727  # 0.5 * log(2*pi)

# family ids shared with csrc/obs_density.cuh
GAUSSIAN_ID = 0
POISSON_ID = 1
KERNEL_CONSTS = 8  # width of the per-step constants row the kernel reads


class ObservationFamily:
    """Base class; families are frozen dataclasses."""

    needs_scale: bool = True

    def constrain_scale(self, raw):
        """Default: positive scale stored on the log scale."""
        return torch.exp(raw)

    def link(self, gamma):
        return gamma

    def log_density(self, gamma, y, scale):
        raise NotImplementedError

    def sample(self, generator: torch.Generator, gamma, scale):
        raise NotImplementedError

    def kernel_log_density(self):
        """``(make_consts, family_id)`` for the fused kernel, or None."""
        return None


def _gaussian_fn(gamma, c):
    z = (c[0] - gamma) * c[1]
    return c[2] - 0.5 * z * z


def _poisson_fn(gamma, c):
    return c[0] * gamma - torch.exp(gamma) - c[1]


_KERNEL_FNS = {GAUSSIAN_ID: _gaussian_fn, POISSON_ID: _poisson_fn}


def kernel_fn(family_id: int):
    """Torch twin of the K3 device function ``family_id``:
    ``fn(gamma, consts) -> log-density``, in the kernel's operation order."""
    return _KERNEL_FNS[family_id]


@dataclasses.dataclass(frozen=True)
class Gaussian(ObservationFamily):
    """y ~ N(gamma, v^2), v = exp(scale).  Reference: Model.scala:241-259."""

    def log_density(self, gamma, y, scale):
        z = (y - gamma) / scale
        return -_HALF_LOG_2PI - torch.log(scale) - 0.5 * z * z

    def sample(self, generator, gamma, scale):
        z = torch.randn(gamma.shape, generator=generator, device=gamma.device)
        return gamma + scale * z

    def kernel_log_density(self):
        def make_consts(y, scale):
            y = torch.as_tensor(y, dtype=torch.float32)
            scale = torch.as_tensor(scale, dtype=torch.float32,
                                    device=y.device)
            return torch.stack(torch.broadcast_tensors(
                y, 1.0 / scale, -_HALF_LOG_2PI - torch.log(scale)), dim=-1)

        return make_consts, GAUSSIAN_ID


@dataclasses.dataclass(frozen=True)
class Poisson(ObservationFamily):
    """y ~ Poisson(exp(gamma)).  Reference: Model.scala:266-274."""

    needs_scale = False

    def link(self, gamma):
        return torch.exp(gamma)

    def log_density(self, gamma, y, scale):
        return y * gamma - torch.exp(gamma) - torch.lgamma(y + 1.0)

    def sample(self, generator, gamma, scale):
        return torch.poisson(self.link(gamma), generator=generator)

    def kernel_log_density(self):
        def make_consts(y, scale):
            y = torch.as_tensor(y, dtype=torch.float32)
            y = y.expand(torch.broadcast_shapes(y.shape, torch.as_tensor(
                scale).shape))
            return torch.stack([y, torch.lgamma(y + 1.0)], dim=-1)

        return make_consts, POISSON_ID
