"""The system under test, composablestatespacemodels_torch, seen from the
benchmark: its model and parameters built from a configuration file
through the public API, the cell's series handed over as its
``TimeSeries``, and its parameter trees read back as plain tensors.

The port is imported inside these functions only, so the reference and
the tests import this module without it.
"""

from __future__ import annotations

import dataclasses

import torch

PACKAGE = "composablestatespacemodels_torch"


def port():
    import composablestatespacemodels_torch as ct
    return ct


def build(config: dict):
    """``(model, params)`` of the port for the configuration: component
    ``c`` is ``ct.<model>(*args, ct.<sde>(dim))`` under
    ``ct.param_node(scale, ct.<params>(**sde_params))`` (the scale
    unconstrained, the process's parameters on their natural scale),
    composed left to right with ``+``."""
    ct = port()
    model = params = None
    for comp in config["components"]:
        sde = getattr(ct, comp["sde"])(int(comp["dim"]))
        leaf_model = getattr(ct, comp["model"])(*comp.get("args", []), sde)
        node = ct.models.leaf(ct.param_node(
            comp.get("scale"), getattr(ct, comp["params"])(**{
                k: list(v) for k, v in comp["sde_params"].items()})))
        if model is None:
            model, params = leaf_model, node
        else:
            model, params = model + leaf_model, ct.models.branch(params, node)
    return model, params


def series(ts, ys, device):
    """The port's ``TimeSeries`` of float64 arrays, every value observed."""
    ct = port()
    t = torch.as_tensor(ts, dtype=torch.float32).to(device)
    return ct.utils.TimeSeries(t, torch.as_tensor(ys, dtype=torch.float32)
                               .to(device), torch.ones_like(t, dtype=torch.bool))


def plain_params(tree, dtype=torch.float64) -> list:
    """A parameter tree of the port (``Branch``/``Leaf`` of ``ParamNode``,
    fields possibly with a leading chain axis) as the reference's list of
    ``{"scale", "sde"}``, leftmost component first, in ``dtype`` (None: as
    they are)."""
    leaves = []

    def walk(t):
        if hasattr(t, "left"):
            walk(t.left)
            walk(t.right)
        else:
            leaves.append(t.value if hasattr(t, "value") else t)

    walk(tree)
    def cast(v):
        return v if dtype is None else v.to(dtype)

    return [{"scale": None if node.scale is None else cast(node.scale),
             "sde": {f.name: cast(getattr(node.sde, f.name))
                     for f in dataclasses.fields(node.sde)}}
            for node in leaves]


def generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)
