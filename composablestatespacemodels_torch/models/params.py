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

The flat-vector layer (:func:`flatten_params`, :func:`add_flat`, the
proposals) follows ``jax.flatten_util.ravel_pytree``'s order, which is
the reference's flatten order: the tree's leaves left to right, within a
leaf the scale first, then ``m0 ++ c0 [++ phi] [++ mu] ++ sigma``
(Parameters.scala:88-95).  A tree may carry a leading chain axis on every
tensor (PMMH's chains, where JAX ``vmap``s): a scale is then ``[B]`` and a
record field ``[B, k]``, the flat vector ``[B, P]``, and the proposals draw
independent noise per chain.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np
import torch

from . import bijectors
from .tree import Branch, Leaf, Tree, tree_map


def _as_array(x) -> torch.Tensor:
    return torch.atleast_1d(torch.as_tensor(x, dtype=torch.float32))


def _vec_names(v: torch.Tensor, name: str) -> List[str]:
    return [f"{name}_{i}" for i in range(v.shape[-1])]


class _Names:
    """``names()`` of a record: ``<field>_<i>`` per entry, with ``C0`` for
    ``c0`` (Parameters.scala:146-153)."""

    def names(self) -> List[str]:
        return [name for f in dataclasses.fields(self)
                for name in _vec_names(getattr(self, f.name),
                                       "C0" if f.name == "c0" else f.name)]


@dataclasses.dataclass(frozen=True)
class BrownianParams(_Names):
    """Brownian motion: ``c0`` (initial variance) and ``sigma`` (variance
    rate per unit time) on the log scale.  Reference:
    SdeParameters.scala:93-126."""

    m0: torch.Tensor
    c0: torch.Tensor
    sigma: torch.Tensor


@dataclasses.dataclass(frozen=True)
class GenBrownianParams(_Names):
    """Brownian motion with drift ``mu``.  Reference:
    SdeParameters.scala:50-91."""

    m0: torch.Tensor
    c0: torch.Tensor
    mu: torch.Tensor
    sigma: torch.Tensor


@dataclasses.dataclass(frozen=True)
class OuParams(_Names):
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


def brownian_params_unconstrained(m0, c0, sigma) -> BrownianParams:
    return BrownianParams(_as_array(m0), _as_array(c0), _as_array(sigma))


def gen_brownian_params_unconstrained(m0, c0, mu, sigma) -> GenBrownianParams:
    return GenBrownianParams(_as_array(m0), _as_array(c0), _as_array(mu),
                             _as_array(sigma))


def ou_params_unconstrained(m0, c0, phi, mu, sigma) -> OuParams:
    return OuParams(_as_array(m0), _as_array(c0), _as_array(phi),
                    _as_array(mu), _as_array(sigma))


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

    def names(self) -> List[str]:
        return (["scale"] if self.scale is not None else []) + self.sde.names()


def param_node(scale, sde) -> ParamNode:
    """Leaf constructor.  ``scale`` is the *unconstrained* observation scale
    (``log(v)`` for a Gaussian sd of ``v``), or ``None``."""
    if scale is not None:
        scale = torch.as_tensor(scale, dtype=torch.float32)
    return ParamNode(scale, sde)


def parameters(scale, sde) -> Tree:
    """Single-component parameter tree (a leaf), as ``Parameters.apply``."""
    return Leaf(param_node(scale, sde))


def params_to(params, device):
    """Copy a parameter tree (or a bare :class:`ParamNode`) to ``device``."""
    return tree_map(lambda t: t.to(device), params)


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


# -- flat-vector interop (reference Addable / flattenParams) ------------------


def _leaves(p) -> list:
    """``(tensor, per-chain ndim)`` of every parameter of a tree, a node or
    a record, in flat order: a scale is a scalar per chain, a record field
    a vector."""
    out = []
    for node in (p.flatten() if isinstance(p, Tree) else [p]):
        if isinstance(node, ParamNode):
            if node.scale is not None:
                out.append((node.scale, 0))
            node = node.sde
        out += [(getattr(node, f.name), 1) for f in dataclasses.fields(node)]
    return out


def _batch_shape(p) -> tuple:
    t, event = _leaves(p)[0]
    return tuple(t.shape[:t.ndim - event])


def flatten_params(p) -> torch.Tensor:
    """Flatten a parameter tree (or node) into one vector ``[P]`` (``[B,
    P]`` for chain-batched trees), in ``ravel_pytree``'s order: leaves left
    to right, the scale first, then m0 ++ c0 [++ phi] [++ mu] ++ sigma
    (Parameters.scala:88-95, SdeParameters.scala:71,112,151)."""
    batch = _batch_shape(p)
    return torch.cat([t.reshape(batch + (-1,)) for t, _ in _leaves(p)],
                     dim=-1)


def unflatten_params(p, flat: torch.Tensor):
    """The tree of ``p``'s structure and shapes holding ``flat`` (the
    inverse of :func:`flatten_params`; ``flat`` may carry a chain axis)."""
    nb = len(_batch_shape(p))
    batch = flat.shape[:-1]
    parts = iter(torch.split(
        flat, [math.prod(t.shape[nb:]) for t, _ in _leaves(p)], dim=-1))
    return tree_map(lambda t: next(parts).reshape(batch + t.shape[nb:]), p)


def param_size(p) -> int:
    return int(flatten_params(p).shape[-1])


def param_names(p) -> List[str]:
    """Reference: Parameters.scala:146-153."""
    if isinstance(p, Leaf):
        return p.value.names()
    if isinstance(p, Branch):
        return param_names(p.left) + param_names(p.right)
    if isinstance(p, ParamNode):
        return p.names()
    return []


def add_flat(p, delta: torch.Tensor):
    """Add a flat innovation vector to a structured parameter tree: the
    reference ``Addable`` typeclass (Addable.scala:8-10,
    Parameters.scala:97-103), the bridge letting MCMC propose in flat R^n."""
    return unflatten_params(p, flatten_params(p) + delta)


# -- proposals (reference Parameters.scala:60-123) ----------------------------
#
# A proposal is ``(generator, params) -> params``.  On a chain-batched tree
# every chain gets its own noise.


def propose_identity(generator, p):
    return p


def _normals(generator, flat: torch.Tensor, width: int) -> torch.Tensor:
    return torch.randn(flat.shape[:-1] + (width,), generator=generator,
                       device=flat.device)


def perturb(delta: float):
    """iid Gaussian random-walk proposal with variance ``delta`` per entry.
    Reference: Parameters.scala:65-67."""
    sd = math.sqrt(delta)

    def proposal(generator, p):
        flat = flatten_params(p)
        return unflatten_params(
            p, flat + sd * _normals(generator, flat, flat.shape[-1]))

    return proposal


def perturb_mvn(chol):
    """Correlated Gaussian proposal ``flat + chol @ z`` from a Cholesky
    factor.  Reference: Parameters.scala:111-114."""
    chol = torch.as_tensor(chol, dtype=torch.float32)

    def proposal(generator, p):
        flat = flatten_params(p)
        c = chol.to(flat.device)
        return unflatten_params(
            p, flat + _normals(generator, flat, c.shape[-1]) @ c.T)

    return proposal


def perturb_mvn_eigen(cov):
    """Correlated Gaussian proposal via the eigendecomposition of ``cov``,
    robust to semi-definite covariances.  Reference:
    Parameters.scala:116-123, MultivariateNormalEigen.scala:11-23."""
    evals, evecs = torch.linalg.eigh(torch.as_tensor(cov,
                                                     dtype=torch.float32))
    q = evecs * torch.sqrt(torch.clamp(evals, min=0.0))[None, :]

    def proposal(generator, p):
        flat = flatten_params(p)
        qd = q.to(flat.device)
        return unflatten_params(
            p, flat + _normals(generator, flat, qd.shape[-1]) @ qd.T)

    return proposal


# -- posterior-sample statistics (reference Parameters.scala:53-58,135-139,
#    Utilities.scala:11-18) ---------------------------------------------------


def mean_params(samples):
    """Mean of a stacked parameter tree (leading sample axis)."""
    return tree_map(lambda x: torch.mean(x, dim=0), samples)


def stack_flat(samples) -> torch.Tensor:
    """Stacked tree (leading axis n) -> ``[n, P]`` matrix of flat vectors."""
    return flatten_params(samples)


def covariance_params(samples) -> torch.Tensor:
    """Covariance matrix ``[P, P]`` of a stacked parameter tree (rows are
    samples, ddof 1).  Reference: Parameters.scala:135-139 +
    Utilities.scala:11-18; feeds the adaptive MVN proposals."""
    return torch.cov(stack_flat(samples).T)
