"""Observation families: link functions, log-densities, samplers and the
in-kernel weight hook.

PyTorch port of ``composablestatespacemodels_tpu/models/observation.py``:
the nine reference observation distributions (Model.scala:144-369).
Scales arrive unconstrained, as the reference stores them, and
``constrain_scale`` maps them to their natural value (exp, or the logistic
for the zero-inflation probability).  Samplers draw from an explicit
``torch.Generator`` on the device of ``gamma``.

``kernel_log_density()`` returns ``(make_consts, family_id)`` for every
pointwise family (all but :class:`LogGaussianCox`):

* ``make_consts(y, scale)`` is torch, runs outside the kernel and returns
  the per-step constants ``[..., k]`` (k <= 8) over the broadcast shape of
  ``y`` and ``scale``: ``y [T]`` builds every step's constants in one pass,
  and ``y[:, None]`` against a chain-batched ``scale [B]`` gives ``[T, B,
  k]``, the layout of K8;
* ``family_id`` selects the matching ``__device__`` function in
  ``csrc/obs_density.cuh`` inside K2, K5 and K8 (K3), and the torch twin
  :func:`kernel_fn` in the kernels' plain versions.  Each twin repeats its
  device function operation for operation, in the same order and float32
  rounding, and computes :meth:`ObservationFamily.log_density`.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .bijectors import logistic

_HALF_LOG_2PI = 0.9189385332046727  # 0.5 * log(2*pi)
# Hard log-likelihood floor for impossible observations (the reference's
# -1e99, Model.scala:332-334, kept finite in float32).
_NEG_INF_LL = -1e30

# family ids shared with csrc/obs_density.cuh
GAUSSIAN_ID = 0
POISSON_ID = 1
ZERO_INFLATED_POISSON_ID = 2
NEGATIVE_BINOMIAL_ID = 3
BERNOULLI_ID = 4
STUDENTS_T_ID = 5
BETA_ID = 6
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
        """``(make_consts, family_id)`` for the fused kernels, or None."""
        return None


def _f32(y, like=None) -> torch.Tensor:
    device = None if like is None else like.device
    return torch.as_tensor(y, dtype=torch.float32, device=device)


def _stack(*cols) -> torch.Tensor:
    """The constants ``[..., k]`` over the broadcast shape of ``cols``."""
    return torch.stack(torch.broadcast_tensors(*cols), dim=-1)


def _log_add_exp(a, b):
    """``logaddexp`` as the kernel computes it:
    ``max(a, b) + log1p(exp(-|a - b|))``."""
    return torch.maximum(a, b) + torch.log1p(torch.exp(-torch.abs(a - b)))


def _bernoulli_link(gamma):
    """The logistic clamped to 1 above 6 and 0 below -6 (Model.scala:315-337)."""
    p = logistic(gamma)
    return torch.where(gamma > 6.0, 1.0, torch.where(gamma < -6.0, 0.0, p))


def _lgamma_f32(x):
    """Twin of ``lgamma_f32`` in ``csrc/obs_density.cuh`` (the JAX
    package's ``_lgamma_f32``, ``observation.py:282``): ``lgamma(x)`` for
    x > 0 in float32 from Stirling's series at z >= 8 with three correction
    terms, smaller arguments shifted up by the recurrence
    ``lgamma(x) = lgamma(x + 8) - log(x (x+1) ... (x+7))`` (the product,
    inf for large x, is select-masked there)."""
    big = x >= 8.0
    z = torch.where(big, x, x + 8.0)
    prod = x
    for i in range(1, 8):
        prod = prod * (x + float(i))
    corr = torch.where(big, 0.0, torch.log(prod))
    zi = 1.0 / z
    zi2 = zi * zi
    series = zi * (1.0 / 12.0 + zi2 * (-1.0 / 360.0 + zi2 * (1.0 / 1260.0)))
    return (z - 0.5) * torch.log(z) - z + _HALF_LOG_2PI + series - corr


# -- the K3 twins: fn(gamma, consts) in the device functions' order --------


def _gaussian_fn(gamma, c):
    z = (c[0] - gamma) * c[1]
    return c[2] - 0.5 * z * z


def _poisson_fn(gamma, c):
    return c[0] * gamma - torch.exp(gamma) - c[1]


def _zip_fn(gamma, c):
    lam = torch.exp(gamma)
    ll_zero = _log_add_exp(c[1], c[2] - lam)
    ll_pos = c[2] + c[0] * gamma - lam - c[3]
    return torch.where(c[4] > 0.5, ll_zero, ll_pos)


def _negative_binomial_fn(gamma, c):
    # log(mu + size) = logaddexp(gamma, log size)
    lse = _log_add_exp(gamma, c[3])
    return c[0] + c[2] * (c[3] - lse) + c[1] * (gamma - lse)


def _bernoulli_fn(gamma, c):
    p = _bernoulli_link(gamma)
    # the JAX package's maximum(p, 1e-300) is maximum(p, 0) in float32
    # (1e-300 rounds to 0): p == 0 is caught by the floor before the log
    ll1 = torch.where(p == 0.0, _NEG_INF_LL, torch.log(torch.clamp(p, min=0.0)))
    ll0 = torch.where(p == 1.0, _NEG_INF_LL,
                      torch.log(torch.clamp(1.0 - p, min=0.0)))
    return torch.where(c[0] == 1.0, ll1, ll0)


def _students_t_fn(gamma, c):
    z = (c[0] - gamma) * c[1]
    return c[2] - c[3] * torch.log1p(z * z / c[4])


def _beta_fn(gamma, c):
    a = torch.exp(-gamma)
    return ((a - 1.0) * c[0] + c[1] + _lgamma_f32(a + c[2])
            - _lgamma_f32(a))


_KERNEL_FNS = {GAUSSIAN_ID: _gaussian_fn, POISSON_ID: _poisson_fn,
               ZERO_INFLATED_POISSON_ID: _zip_fn,
               NEGATIVE_BINOMIAL_ID: _negative_binomial_fn,
               BERNOULLI_ID: _bernoulli_fn, STUDENTS_T_ID: _students_t_fn,
               BETA_ID: _beta_fn}


def kernel_fn(family_id: int):
    """Torch twin of the K3 device function ``family_id``:
    ``fn(gamma, consts) -> log-density``, in the kernel's operation order."""
    return _KERNEL_FNS[family_id]


def _gamma_sample(generator, alpha):
    """Gamma(alpha, 1) draws from ``generator``."""
    return torch._standard_gamma(alpha, generator=generator)


# -- the families -------------------------------------------------------------


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
            y = _f32(y)
            scale = _f32(scale, y)
            return _stack(y, 1.0 / scale, -_HALF_LOG_2PI - torch.log(scale))

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
            y = _f32(y)
            y = y.expand(torch.broadcast_shapes(y.shape, _f32(scale).shape))
            return _stack(y, torch.lgamma(y + 1.0))

        return make_consts, POISSON_ID


@dataclasses.dataclass(frozen=True)
class ZeroInflatedPoisson(ObservationFamily):
    """Excess-zero counts: with probability p = logistic(scale) emit 0,
    else Poisson(exp(gamma)).  Reference: Model.scala:281-309."""

    def constrain_scale(self, raw):
        return logistic(raw)

    def link(self, gamma):
        return torch.exp(gamma)

    def log_density(self, gamma, y, scale):
        lam = torch.exp(gamma)
        log_p = torch.log(scale)
        log_1mp = torch.log1p(-scale)
        ll_zero = torch.logaddexp(log_p, log_1mp - lam)
        ll_pos = log_1mp + y * gamma - lam - torch.lgamma(y + 1.0)
        return torch.where(y == 0, ll_zero, ll_pos)

    def sample(self, generator, gamma, scale):
        u = torch.rand(gamma.shape, generator=generator, device=gamma.device)
        pois = torch.poisson(self.link(gamma), generator=generator)
        return torch.where(u < scale, 0.0, pois)

    def kernel_log_density(self):
        def make_consts(y, scale):
            y = _f32(y)
            scale = _f32(scale, y)
            return _stack(y, torch.log(scale), torch.log1p(-scale),
                          torch.lgamma(y + 1.0), (y == 0).to(torch.float32))

        return make_consts, ZERO_INFLATED_POISSON_ID


@dataclasses.dataclass(frozen=True)
class NegativeBinomial(ObservationFamily):
    """Overdispersed counts: mean mu = exp(gamma), size r = exp(scale),
    variance mu + mu^2 / r; a gamma-Poisson mixture.  Reference:
    Model.scala:168-196."""

    def link(self, gamma):
        return torch.exp(gamma)

    def log_density(self, gamma, y, scale):
        size = scale
        mu = torch.exp(gamma)
        return (torch.lgamma(size + y) - torch.lgamma(y + 1.0)
                - torch.lgamma(size)
                + size * torch.log(size / (mu + size))
                + y * torch.log(mu / (mu + size)))

    def sample(self, generator, gamma, scale):
        mu = self.link(gamma)
        size = torch.broadcast_to(scale, mu.shape)
        # lambda ~ Gamma(shape=size, scale=mu/size), so E[y] = mu
        lam = _gamma_sample(generator, size) * (mu / size)
        return torch.poisson(lam, generator=generator)

    def kernel_log_density(self):
        def make_consts(y, scale):
            y = _f32(y)
            size = _f32(scale, y)
            return _stack(torch.lgamma(size + y) - torch.lgamma(y + 1.0)
                          - torch.lgamma(size), y, size, torch.log(size))

        return make_consts, NEGATIVE_BINOMIAL_ID


@dataclasses.dataclass(frozen=True)
class Bernoulli(ObservationFamily):
    """y in {0, 1} with p = clamped-logistic(gamma).  Reference:
    Model.scala:315-337 (clamps the link at |gamma| > 6)."""

    needs_scale = False

    def link(self, gamma):
        return _bernoulli_link(gamma)

    def log_density(self, gamma, y, scale):
        p = self.link(gamma)
        ll1 = torch.where(p == 0.0, _NEG_INF_LL,
                          torch.log(torch.clamp(p, min=0.0)))
        ll0 = torch.where(p == 1.0, _NEG_INF_LL,
                          torch.log(torch.clamp(1.0 - p, min=0.0)))
        return torch.where(y == 1.0, ll1, ll0)

    def sample(self, generator, gamma, scale):
        u = torch.rand(gamma.shape, generator=generator, device=gamma.device)
        return torch.where(u < self.link(gamma), 1.0, 0.0)

    def kernel_log_density(self):
        def make_consts(y, scale):
            y = _f32(y)
            y = y.expand(torch.broadcast_shapes(y.shape, _f32(scale).shape))
            return y[..., None]

        return make_consts, BERNOULLI_ID


@dataclasses.dataclass(frozen=True)
class StudentsT(ObservationFamily):
    """y = gamma + v * t_df, v = exp(scale).  Reference: Model.scala:144-162,
    with the change of variables ``logPdf((y - eta)/v) - log(v)`` where
    the reference multiplies the log-density by 1/v (as the JAX package).

    The JAX kernel closes over ``df`` as a static Python float; here
    ``(df + 1)/2`` and ``df`` ride in two spare slots of the constants row
    (``KERNEL_CONSTS = 8``), so one kernel instantiation serves every
    ``df``."""

    df: int = 4

    def _lognorm(self, like):
        nu = float(self.df)
        half = torch.tensor([(nu + 1.0) / 2.0, nu / 2.0], dtype=torch.float32,
                            device=like.device)
        lg = torch.lgamma(half)
        return lg[0] - lg[1] - 0.5 * torch.log(_f32(nu * math.pi, like))

    def log_density(self, gamma, y, scale):
        nu = float(self.df)
        z = (y - gamma) / scale
        return (self._lognorm(z) - (nu + 1.0) / 2.0 * torch.log1p(z * z / nu)
                - torch.log(scale))

    def sample(self, generator, gamma, scale):
        nu = float(self.df)
        z = torch.randn(gamma.shape, generator=generator, device=gamma.device)
        chi2 = 2.0 * _gamma_sample(generator, torch.full_like(z, nu / 2.0))
        return gamma + scale * (z / torch.sqrt(chi2 / nu))

    def kernel_log_density(self):
        nu = float(self.df)

        def make_consts(y, scale):
            y = _f32(y)
            scale = _f32(scale, y)
            return _stack(y, 1.0 / scale,
                          self._lognorm(y) - torch.log(scale),
                          _f32((nu + 1.0) / 2.0, y), _f32(nu, y))

        return make_consts, STUDENTS_T_ID


@dataclasses.dataclass(frozen=True)
class Beta(ObservationFamily):
    """y ~ Beta(alpha = exp(-gamma), beta = exp(scale)).

    The reference's link is ``exp(-x)`` (Model.scala:345), kept for parity;
    sampling and density use the same Beta(alpha, beta) law, where the
    reference's ``dataLikelihood`` ignores the stored shape (as the JAX
    package)."""

    def link(self, gamma):
        return torch.exp(-gamma)

    def log_density(self, gamma, y, scale):
        a = self.link(gamma)
        b = scale
        return ((a - 1.0) * torch.log(y) + (b - 1.0) * torch.log1p(-y)
                + torch.lgamma(a + b) - torch.lgamma(a) - torch.lgamma(b))

    def sample(self, generator, gamma, scale):
        a = self.link(gamma)
        ga = _gamma_sample(generator, a)
        gb = _gamma_sample(generator, torch.broadcast_to(scale, a.shape))
        return ga / (ga + gb)

    def kernel_log_density(self):
        def make_consts(y, scale):
            # log y, log1p(-y) and lgamma(b) are per-step scalars computed
            # here; only lgamma(a) and lgamma(a + b) depend on the particle
            y = _f32(y)
            b = _f32(scale, y)
            return _stack(torch.log(y),
                          (b - 1.0) * torch.log1p(-y) - torch.lgamma(b), b)

        return make_consts, BETA_ID


@dataclasses.dataclass(frozen=True)
class LogGaussianCox(ObservationFamily):
    """Log-Gaussian Cox process: events arrive with hazard exp(gamma(t)).
    As in the reference (Model.scala:363-369), it has no pointwise
    likelihood: only the LGCP filter (``inference.lgcp.lgcp_filter``) and
    the thinning simulator (``utils.data.simulate_lgcp``) use it."""

    needs_scale = False

    def link(self, gamma):
        return torch.exp(gamma)

    def log_density(self, gamma, y, scale):
        raise NotImplementedError(
            "LogGaussianCox has no pointwise likelihood; use "
            "inference.lgcp.lgcp_filter")

    def sample(self, generator, gamma, scale):
        raise NotImplementedError(
            "LogGaussianCox is simulated by thinning; use "
            "utils.data.simulate_lgcp")
