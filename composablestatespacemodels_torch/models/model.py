"""Composable state-space models: the left-biased composition operator.

PyTorch port of ``composablestatespacemodels_tpu/models/model.py``
(reference: Model.scala:96-136).  A model is a frozen dataclass tree of
:class:`LeafModel` / :class:`ComposedModel`; the composed latent state is
a flat ``[..., d]`` tensor in which every component owns a contiguous
slice; ``f(x, t)`` is a dot product with the time-dependent design vector
``F(t)``; the *leftmost* leaf supplies the observation family.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import torch

from . import observation as obs_mod
from .observation import ObservationFamily
from .params import ParamNode
from .sde import CompositeSde, Sde, compose_sde
from .tree import Branch, Leaf, Tree


def _times(t) -> torch.Tensor:
    return torch.as_tensor(t, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class FirstElement:
    """f(x, t) = x[0] of the component's slice (Model.scala:250, 271)."""

    def design(self, dim: int, t):
        t = _times(t)
        e = torch.zeros(t.shape + (dim,), dtype=torch.float32, device=t.device)
        e[..., 0] = 1.0
        return e


@dataclasses.dataclass(frozen=True)
class Fourier:
    """Seasonal design: cos/sin of ``2 pi a t / period`` for harmonics
    a = 1..h, interleaved (SeasonalModel.buildF, Model.scala:217-225)."""

    period: int
    harmonics: int

    def design(self, dim: int, t):
        t = _times(t)
        freq = 2.0 * math.pi / self.period
        a = torch.arange(1, self.harmonics + 1, dtype=torch.float32,
                         device=t.device)
        ang = freq * a * t[..., None]
        return torch.stack([torch.cos(ang), torch.sin(ang)],
                           dim=-1).reshape(t.shape + (2 * self.harmonics,))


class Model:
    """Base class for model specs."""

    def components(self) -> List["LeafModel"]:
        raise NotImplementedError

    def structure(self):
        raise NotImplementedError

    @property
    def sde(self) -> Sde:
        raise NotImplementedError

    @property
    def dim(self) -> int:
        return self.sde.dim

    def __add__(self, other: "Model") -> "ComposedModel":
        """The semigroup operator ``|+|`` (left-biased)."""
        return ComposedModel(self, other)

    # -- parameter plumbing -----------------------------------------------------

    def validate_params(self, params: Tree) -> None:
        raise NotImplementedError

    def sde_params(self, params: Tree):
        raise NotImplementedError

    def _leftmost_node(self, params: Tree) -> ParamNode:
        if isinstance(params, ParamNode):
            return params
        t = params
        while isinstance(t, Branch):
            t = t.left
        if not isinstance(t, Leaf):
            raise TypeError("parameter tree has no leftmost leaf")
        return t.value

    # -- observation layer (leftmost leaf) ------------------------------------------

    def obs_scale(self, params: Tree):
        """Constrained observation scale of the leftmost component (or ones),
        ``[B]`` for chain-batched parameters."""
        node = self._leftmost_node(params)
        if not self.obs.needs_scale:
            m0 = node.sde.m0
            return torch.ones(m0.shape[:-1], dtype=torch.float32,
                              device=m0.device)
        if node.scale is None:
            raise ValueError(
                f"{type(self.obs).__name__} requires an observation scale "
                "parameter but ParamNode.scale is None")
        return self.obs.constrain_scale(node.scale)

    def link(self, gamma):
        return self.obs.link(gamma)

    def log_density(self, params: Tree, gamma, y):
        """log pi(y | gamma) -- the reference ``dataLikelihood``."""
        return self.obs.log_density(gamma, y, self.obs_scale(params))

    def sample_obs(self, generator, params: Tree, gamma):
        return self.obs.sample(generator, gamma, self.obs_scale(params))

    # -- latent dynamics ------------------------------------------------------------

    def initial_state(self, params: Tree, generator, shape=()):
        return self.sde.initial_state(self.sde_params(params), generator, shape)

    def step(self, params: Tree, generator, x, dt):
        return self.sde.step(self.sde_params(params), generator, x, dt)

    def initial_state_t(self, params: Tree, generator, n: int):
        return self.sde.initial_state_t(self.sde_params(params), generator, n)

    def step_t(self, params: Tree, generator, x_t, dt):
        return self.sde.step_t(self.sde_params(params), generator, x_t, dt)

    # -- linear transform f -----------------------------------------------------------

    def design_vector(self, t):
        """F(t) ``[..., d]`` with gamma = x @ F(t): the components' designs
        concatenated.  ``t`` may be a scalar or ``[T]``."""
        return torch.cat([c.ftype.design(c.sde.dim, t)
                          for c in self.components()], dim=-1)

    def f(self, x, t):
        """gamma = f(x, t) for a ``[..., d]`` state."""
        return x @ self.design_vector(t)

    def f_t(self, x_t, t):
        """gamma ``[N]`` from a transposed ``[d, N]`` particle block."""
        return self.design_vector(t) @ x_t


@dataclasses.dataclass(frozen=True)
class LeafModel(Model):
    obs: ObservationFamily
    _sde: Sde
    ftype: object  # FirstElement | Fourier

    @property
    def sde(self) -> Sde:
        return self._sde

    def components(self) -> List["LeafModel"]:
        return [self]

    def structure(self):
        return "L"

    def validate_params(self, params: Tree, _is_obs_leaf: bool = True) -> None:
        if isinstance(params, ParamNode):
            params = Leaf(params)
        if not isinstance(params, Leaf):
            raise TypeError(
                "Can't build model from branch parameter "
                f"(got {type(params).__name__} for a leaf model)")
        node = params.value
        if not isinstance(node, ParamNode):
            raise TypeError(f"expected ParamNode leaf, got {type(node).__name__}")
        self._sde.validate(node.sde)
        if _is_obs_leaf and self.obs.needs_scale and node.scale is None:
            raise ValueError(
                f"{type(self.obs).__name__} requires an observation scale")
        if node.scale is not None and node.scale.ndim != 0:
            raise ValueError("observation scale must be a scalar, got shape "
                             f"{tuple(node.scale.shape)}")
        if isinstance(self.ftype, Fourier):
            want = 2 * self.ftype.harmonics
            if self._sde.dim != want:
                raise ValueError(
                    f"seasonal model with {self.ftype.harmonics} harmonics "
                    f"needs a {want}-dimensional SDE, got {self._sde.dim}")

    def sde_params(self, params: Tree):
        if isinstance(params, ParamNode):
            return params.sde
        if isinstance(params, Leaf):
            return params.value.sde
        raise TypeError("Can't build model from branch parameter")


@dataclasses.dataclass(frozen=True)
class ComposedModel(Model):
    left: Model
    right: Model

    @property
    def obs(self) -> ObservationFamily:
        """Left-biased: the leftmost leaf supplies the observation layer."""
        return self.components()[0].obs

    @property
    def sde(self) -> CompositeSde:
        return compose_sde(self.left.sde, self.right.sde)

    def components(self) -> List[LeafModel]:
        return self.left.components() + self.right.components()

    def structure(self):
        return (self.left.structure(), self.right.structure())

    def validate_params(self, params: Tree, _is_obs_leaf: bool = True) -> None:
        if not isinstance(params, Branch):
            raise TypeError("Can't build composed model from leaf parameter")
        self.left.validate_params(params.left, _is_obs_leaf)
        self.right.validate_params(params.right, False)

    def sde_params(self, params: Tree):
        if not isinstance(params, Branch):
            raise TypeError("Can't build composed model from leaf parameter")
        return (self.left.sde_params(params.left),
                self.right.sde_params(params.right))


def poisson(sde: Sde) -> LeafModel:
    return LeafModel(obs_mod.Poisson(), sde, FirstElement())


def linear(sde: Sde) -> LeafModel:
    return LeafModel(obs_mod.Gaussian(), sde, FirstElement())


def seasonal(period: int, harmonics: int, sde: Sde) -> LeafModel:
    return LeafModel(obs_mod.Gaussian(), sde, Fourier(period, harmonics))


def students_t(sde: Sde, df: int = 4) -> LeafModel:
    return LeafModel(obs_mod.StudentsT(df), sde, FirstElement())


def bernoulli(sde: Sde) -> LeafModel:
    return LeafModel(obs_mod.Bernoulli(), sde, FirstElement())


def beta(sde: Sde) -> LeafModel:
    return LeafModel(obs_mod.Beta(), sde, FirstElement())


def negative_binomial(sde: Sde) -> LeafModel:
    return LeafModel(obs_mod.NegativeBinomial(), sde, FirstElement())


def zero_inflated_poisson(sde: Sde) -> LeafModel:
    return LeafModel(obs_mod.ZeroInflatedPoisson(), sde, FirstElement())


def lgcp(sde: Sde) -> LeafModel:
    return LeafModel(obs_mod.LogGaussianCox(), sde, FirstElement())


def compose(m1: Model, m2: Model) -> ComposedModel:
    """``m1 |+| m2``: left-biased model composition (Model.scala:110-136)."""
    return ComposedModel(m1, m2)
