"""The plain reference of a composed model, built from a configuration file.

A configuration lists its components left to right.  Each names its
observation model (a file of ``reference/obs/``) and its latent process
(a file of ``reference/sde/``), found by name, so a configuration with a
new family adds a file here and edits none.  Composition follows the
left-biased ``+`` of Model.scala:96-136: the states are concatenated, the
linear predictor is the sum of every component's design times its slice,
and the leftmost component supplies the observation family.

Parameters are plain: a list with one ``{"scale": tensor or None, "sde":
{field: tensor [..., k]}}`` per component, a leading chain axis allowed.
Nothing here imports the system under test.
"""

from __future__ import annotations

import importlib.util
import math
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent


def _load(kind: str, name: str):
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"no reference {kind} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"cssm_bench.reference.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _design(kind: str, comp: dict, dim: int, ts: torch.Tensor) -> torch.Tensor:
    if kind == "first":
        e = torch.zeros(ts.shape + (dim,), dtype=ts.dtype, device=ts.device)
        e[..., 0] = 1.0
        return e
    if kind == "fourier":
        period, harmonics = comp["args"]
        a = torch.arange(1, harmonics + 1, dtype=ts.dtype, device=ts.device)
        ang = (2.0 * math.pi / period) * a * ts[..., None]
        return torch.stack([torch.cos(ang), torch.sin(ang)],
                           dim=-1).reshape(ts.shape + (2 * harmonics,))
    raise ValueError(f"unknown design {kind!r}")


class RefModel:
    def __init__(self, config: dict):
        self.components = config["components"]
        self.obs_mods = [_load("obs", c["model"]) for c in self.components]
        self.sde_mods = [_load("sde", c["sde"]) for c in self.components]
        self.dims = [int(c["dim"]) for c in self.components]
        self.dim = sum(self.dims)
        self.obs = self.obs_mods[0]
        if not hasattr(self.obs, "log_density"):
            raise ValueError(f"{self.components[0]['model']} has no "
                             "observation family to stand leftmost")

    def params(self, device, dtype=torch.float64) -> list:
        """The configuration's own parameters, unconstrained (its
        ``scale`` is stated unconstrained, its ``sde_params`` on their
        natural scale)."""
        def t(v):
            return torch.as_tensor(v, dtype=dtype, device=device)
        return [{"scale": None if c.get("scale") is None else t(c["scale"]),
                 "sde": s.unconstrain({k: t(v) for k, v in
                                       c["sde_params"].items()})}
                for c, s in zip(self.components, self.sde_mods)]

    def design(self, ts: torch.Tensor) -> torch.Tensor:
        """``F(t) [T, d]``, the components' designs concatenated."""
        return torch.cat([_design(o.DESIGN, c, d, ts) for o, c, d in
                          zip(self.obs_mods, self.components, self.dims)],
                         dim=-1)

    def initial_moments(self, params: list):
        ms, vs = zip(*(s.initial_moments(p["sde"], d) for s, p, d in
                       zip(self.sde_mods, params, self.dims)))
        return torch.cat(ms, dim=-1), torch.cat(vs, dim=-1)

    def transition(self, params: list, dt: torch.Tensor):
        """``(a, b, q)``, each ``[T, ..., d]`` for ``dt [T]``."""
        parts = [s.transition(p["sde"], d, dt) for s, p, d in
                 zip(self.sde_mods, params, self.dims)]
        return tuple(torch.cat(c, dim=-1) for c in zip(*parts))

    def obs_scale(self, params: list):
        raw = params[0]["scale"]
        return None if raw is None else self.obs.constrain_scale(raw)
