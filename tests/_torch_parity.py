"""Shared fixtures for the parity tests of composablestatespacemodels_torch
against the JAX package: the same models built in both packages, and JAX
parameter trees carried into the port through their neutral numpy form."""

from __future__ import annotations

import numpy as np

import composablestatespacemodels_torch as ct
import composablestatespacemodels_tpu as cj
from composablestatespacemodels_tpu.models.params import (BrownianParams,
                                                          GenBrownianParams,
                                                          OuParams, ParamNode)
from composablestatespacemodels_tpu.models.tree import Branch, Leaf

_KINDS = {BrownianParams: "brownian", GenBrownianParams: "gen_brownian",
          OuParams: "ou"}


def jax_params_to_numpy(tree):
    """A JAX parameter tree in the neutral form ``params_from_numpy`` reads."""
    if isinstance(tree, Branch):
        return {"left": jax_params_to_numpy(tree.left),
                "right": jax_params_to_numpy(tree.right)}
    node = tree.value if isinstance(tree, Leaf) else tree
    assert isinstance(node, ParamNode)
    sde = {"kind": _KINDS[type(node.sde)]}
    for name in node.sde.__dataclass_fields__:
        sde[name] = np.asarray(getattr(node.sde, name))
    scale = None if node.scale is None else np.asarray(node.scale)
    return {"scale": scale, "sde": sde}


def flagship(pkg):
    """The headline model of bench.py:79-85 in package ``pkg``."""
    model = (pkg.poisson(pkg.ou_process(1))
             + pkg.seasonal(24, 3, pkg.ou_process(6)))
    params = pkg.branch(
        pkg.leaf(pkg.param_node(None, pkg.ou_params(1.0, 0.2, 0.3, 1.0, 0.3))),
        pkg.leaf(pkg.param_node(None,
                                pkg.ou_params(0.2, 0.2, 0.25, 0.2, 0.2))))
    return model, params


def oracle(pkg):
    """The linear-Gaussian oracle model: linear(brownian_motion(1))."""
    model = pkg.linear(pkg.brownian_motion(1))
    params = pkg.parameters(np.log(0.5), pkg.brownian_params(0.0, 1.0, 0.4))
    return model, params


def seasonal_linear(pkg):
    """A composed linear-Gaussian model (Gaussian leftmost, seasonal right)."""
    model = (pkg.linear(pkg.ou_process(1))
             + pkg.seasonal(24, 2, pkg.ou_process(4)))
    params = pkg.branch(
        pkg.leaf(pkg.param_node(np.log(0.3),
                                pkg.ou_params(0.5, 0.5, 0.4, 0.2, 0.3))),
        pkg.leaf(pkg.param_node(None,
                                pkg.ou_params(0.1, 0.3, 0.3, 0.0, 0.2))))
    return model, params


def _family_case(make, scale, sde_params):
    def build(pkg):
        return make(pkg), pkg.parameters(scale, sde_params(pkg))
    return build


# the pointwise observation families with the parameters of
# tests/test_families_end_to_end.py:14-42, one model per family
FAMILY_CASES = {
    "poisson": _family_case(lambda p: p.poisson(p.ou_process(1)), None,
                            lambda p: p.ou_params(1.0, 0.3, 0.3, 1.0, 0.3)),
    "linear": _family_case(lambda p: p.linear(p.brownian_motion(1)),
                           np.log(0.5),
                           lambda p: p.brownian_params(0.0, 1.0, 0.3)),
    "bernoulli": _family_case(lambda p: p.bernoulli(p.ou_process(1)), None,
                              lambda p: p.ou_params(0.0, 0.5, 0.3, 0.0, 0.5)),
    "beta": _family_case(lambda p: p.beta(p.ou_process(1)), np.log(2.0),
                         lambda p: p.ou_params(0.5, 0.2, 0.3, 0.5, 0.3)),
    "students_t": _family_case(
        lambda p: p.students_t(p.ou_process(1), df=5), np.log(0.4),
        lambda p: p.ou_params(1.0, 0.3, 0.3, 1.0, 0.4)),
    "negative_binomial": _family_case(
        lambda p: p.negative_binomial(p.ou_process(1)), np.log(3.0),
        lambda p: p.ou_params(1.0, 0.3, 0.3, 1.0, 0.3)),
    "zero_inflated_poisson": _family_case(
        lambda p: p.zero_inflated_poisson(p.ou_process(1)), 0.0,
        lambda p: p.ou_params(1.0, 0.3, 0.3, 1.0, 0.3)),
}

MODELS = {"flagship": flagship, "oracle": oracle,
          "seasonal_linear": seasonal_linear, **FAMILY_CASES}


def both(name):
    """``(jax_model, jax_params, torch_model, torch_params)``, the torch
    parameters carried over from the JAX ones."""
    jm, jp = MODELS[name](cj)
    tm, _ = MODELS[name](ct)
    return jm, jp, tm, ct.params_from_numpy(jax_params_to_numpy(jp))


def drift_only_ou():
    """An OU written with only ``drift`` and ``diffusion`` (no exact
    transition, so it steps by Euler-Maruyama) in a linear-Gaussian model,
    and its parameters."""
    from composablestatespacemodels_torch.models import sde

    class DriftOnlyOu(sde.Ou):
        transition_coeffs = sde.Sde.transition_coeffs

    model = ct.linear(DriftOnlyOu(1))
    return model, ct.parameters(np.log(0.5),
                                ct.ou_params(0.5, 0.2, 0.3, 0.5, 0.3))


def to_torch_series(ts, ys, mask):
    import torch
    return ct.TimeSeries(torch.tensor(np.asarray(ts, np.float32)),
                         torch.tensor(np.asarray(ys, np.float32)),
                         torch.tensor(np.asarray(mask, bool)))
