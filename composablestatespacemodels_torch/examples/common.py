"""Shared fixtures and the small config layer of the example apps.

The port of ``examples/common.py``.  The test model mirrors the
reference's ``TestModel`` (examples/Simulation.scala:14-29): a
negative-binomial observation model over a 1-d OU process composed with a
24-period 4-harmonic seasonal model over an 8-d OU process (d = 9).

The reference hard-codes experiment configuration inside each App object;
here a small dataclass and argparse layer replaces it.  Every app takes
``--device`` (default ``cuda``): its ``torch.Generator``, and so all its
work, lives there.
"""

from __future__ import annotations

import argparse
import dataclasses
import math

import torch

import composablestatespacemodels_torch as ct
from composablestatespacemodels_torch.models import (branch, leaf, ou_params,
                                                     param_node)


@dataclasses.dataclass
class RunConfig:
    seed: int = 0
    n_obs: int = 500
    dt: float = 1.0
    n_particles: int = 1000
    n_iters: int = 10000
    resample: str = "systematic"
    out: str = "out"
    device: str = "cuda"


def add_common_args(ap: argparse.ArgumentParser) -> None:
    d = RunConfig()
    ap.add_argument("--seed", type=int, default=d.seed)
    ap.add_argument("--n-obs", type=int, default=d.n_obs)
    ap.add_argument("--dt", type=float, default=d.dt)
    ap.add_argument("--n-particles", type=int, default=d.n_particles)
    ap.add_argument("--n-iters", type=int, default=d.n_iters)
    ap.add_argument("--resample", default=d.resample)
    ap.add_argument("--out", default=d.out)
    ap.add_argument("--device", default=d.device,
                    help="torch device of the run (default: cuda)")


def config_from_args(args) -> RunConfig:
    return RunConfig(seed=args.seed, n_obs=args.n_obs, dt=args.dt,
                     n_particles=args.n_particles, n_iters=args.n_iters,
                     resample=args.resample, out=args.out,
                     device=args.device)


def generator(cfg: RunConfig) -> torch.Generator:
    """The run's generator, seeded with ``--seed`` on ``--device``."""
    return torch.Generator(device=cfg.device).manual_seed(cfg.seed)


def test_model():
    """The canonical composed model + parameters (Simulation.scala:14-29)."""
    model = (ct.negative_binomial(ct.ou_process(1))
             + ct.seasonal(24, 4, ct.ou_process(8)))
    params = branch(
        leaf(param_node(math.log(3.0),
                        ou_params(1.0, 0.2, 0.3, 1.0, 0.3))),
        leaf(param_node(None,
                        ou_params(0.5, 0.2, 0.25, 0.5, 0.2))))
    return model, params
