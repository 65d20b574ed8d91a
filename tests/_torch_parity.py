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


MODELS = {"flagship": flagship, "oracle": oracle,
          "seasonal_linear": seasonal_linear}


def both(name):
    """``(jax_model, jax_params, torch_model, torch_params)``, the torch
    parameters carried over from the JAX ones."""
    jm, jp = MODELS[name](cj)
    tm, _ = MODELS[name](ct)
    return jm, jp, tm, ct.params_from_numpy(jax_params_to_numpy(jp))


def to_torch_series(ts, ys, mask):
    import torch
    return ct.TimeSeries(torch.tensor(np.asarray(ts, np.float32)),
                         torch.tensor(np.asarray(ys, np.float32)),
                         torch.tensor(np.asarray(mask, bool)))
