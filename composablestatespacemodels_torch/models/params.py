"""Parameter records for SDE families and observation models.

PyTorch port of ``composablestatespacemodels_tpu/models/params.py``
(reference: SdeParameters.scala:14-248, Parameters.scala:14-153).
Parameters are stored **unconstrained** (log scale for positive values,
logit scale for the OU rate ``phi``) as float32 tensors in plain
dataclasses; a composed model's parameters form a :class:`~.tree.Tree` of
:class:`ParamNode` leaves.

:func:`params_from_numpy` builds a parameter tree from a neutral nested
form of numpy arrays, which is how parameters are carried over from the
JAX package (or from any other source) without importing it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import bijectors
from .tree import Branch, Leaf, Tree


def _as_array(x) -> torch.Tensor:
    return torch.atleast_1d(torch.as_tensor(x, dtype=torch.float32))


@dataclasses.dataclass(frozen=True)
class BrownianParams:
    """Brownian motion: ``c0`` (initial variance) and ``sigma`` (variance
    rate per unit time) on the log scale.  Reference:
    SdeParameters.scala:93-126."""

    m0: torch.Tensor
    c0: torch.Tensor
    sigma: torch.Tensor


@dataclasses.dataclass(frozen=True)
class GenBrownianParams:
    """Brownian motion with drift ``mu``.  Reference:
    SdeParameters.scala:50-91."""

    m0: torch.Tensor
    c0: torch.Tensor
    mu: torch.Tensor
    sigma: torch.Tensor


@dataclasses.dataclass(frozen=True)
class OuParams:
    """Ornstein-Uhlenbeck: ``phi`` on the logit scale, ``c0``/``sigma`` on
    the log scale.  Reference: SdeParameters.scala:128-169."""

    m0: torch.Tensor
    c0: torch.Tensor
    phi: torch.Tensor
    mu: torch.Tensor
    sigma: torch.Tensor


# kind name <-> record type, for the neutral numpy form
_SDE_KINDS = {"brownian": BrownianParams, "gen_brownian": GenBrownianParams,
              "ou": OuParams}


def brownian_params(m0, c0, sigma) -> BrownianParams:
    """Build Brownian parameters from *constrained* (natural-scale) values."""
    return BrownianParams(_as_array(m0), bijectors.to_log(_as_array(c0)),
                          bijectors.to_log(_as_array(sigma)))


def gen_brownian_params(m0, c0, mu, sigma) -> GenBrownianParams:
    return GenBrownianParams(
        _as_array(m0), bijectors.to_log(_as_array(c0)), _as_array(mu),
        bijectors.to_log(_as_array(sigma)))


def ou_params(m0, c0, phi, mu, sigma) -> OuParams:
    """Build OU parameters from constrained values; ``phi`` in (0, 1)."""
    return OuParams(
        _as_array(m0), bijectors.to_log(_as_array(c0)),
        bijectors.to_logit(_as_array(phi)), _as_array(mu),
        bijectors.to_log(_as_array(sigma)))


def param_repeat(v: torch.Tensor, dim: int) -> torch.Tensor:
    """Cyclically recycle a parameter vector to ``dim`` entries.

    Reference: Sde.scala:177-179 (``buildParamRepeat``).
    """
    v = torch.atleast_1d(v)
    n = v.shape[-1]
    if n == dim:
        return v
    idx = torch.arange(dim, device=v.device) % n
    return v[..., idx]


@dataclasses.dataclass(frozen=True)
class ParamNode:
    """(optional unconstrained observation scale, SDE parameters) for one
    model component.  Reference: Parameters.scala:14."""

    scale: Optional[torch.Tensor]
    sde: object


def param_node(scale, sde) -> ParamNode:
    """Leaf constructor.  ``scale`` is the *unconstrained* observation scale
    (``log(v)`` for a Gaussian sd of ``v``), or ``None``."""
    if scale is not None:
        scale = torch.as_tensor(scale, dtype=torch.float32)
    return ParamNode(scale, sde)


def parameters(scale, sde) -> Tree:
    """Single-component parameter tree (a leaf), as ``Parameters.apply``."""
    return Leaf(param_node(scale, sde))


def _sde_to(p, device) -> object:
    return dataclasses.replace(p, **{
        f.name: getattr(p, f.name).to(device) for f in dataclasses.fields(p)})


def _node_to(node: ParamNode, device) -> ParamNode:
    scale = None if node.scale is None else node.scale.to(device)
    return ParamNode(scale, _sde_to(node.sde, device))


def params_to(params, device):
    """Copy a parameter tree (or a bare :class:`ParamNode`) to ``device``."""
    if isinstance(params, ParamNode):
        return _node_to(params, device)
    return params.map(lambda node: _node_to(node, device))


def params_from_numpy(obj, device=None):
    """Build a parameter tree from its neutral nested numpy form.

    * a branch is ``{"left": ..., "right": ...}``;
    * a leaf is ``{"scale": array or None, "sde": {"kind": k, fields...}}``
      with ``k`` one of ``"brownian"``, ``"gen_brownian"``, ``"ou"`` and the
      fields of the matching record, all **unconstrained** as stored.
    """
    if "left" in obj:
        return Branch(params_from_numpy(obj["left"], device),
                      params_from_numpy(obj["right"], device))
    sde = dict(obj["sde"])
    kind = sde.pop("kind")
    if kind not in _SDE_KINDS:
        raise ValueError(f"unknown SDE kind {kind!r}; "
                         f"expected one of {sorted(_SDE_KINDS)}")
    cls = _SDE_KINDS[kind]
    rec = cls(**{f.name: torch.tensor(
        np.atleast_1d(np.asarray(sde[f.name], np.float32)), device=device)
        for f in dataclasses.fields(cls)})
    scale = obj.get("scale")
    if scale is not None:
        scale = torch.tensor(np.asarray(scale, np.float32), device=device)
    return Leaf(ParamNode(scale, rec))
