"""The cell's observations, made from the run's seed.

The latent path follows the exact transition on a regular grid from
``t0`` (the first observation at ``t0``, from the initial state), in
float64 numpy with a ``PCG64`` stream seeded from ``(seed, purpose)``, so
one seed gives the same series on any machine.  Both the system under
test and the reference receive these arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from .model import RefModel

SIMULATE = 0x5151


def rng_for(seed: int, *purpose: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), *purpose])


def simulate(model: RefModel, n: int, dt: float, seed: int,
             t0: float = 0.0):
    """``(ts [n], ys [n])`` as float64 numpy arrays."""
    rng = rng_for(seed, SIMULATE)
    params = model.params("cpu")
    ts = t0 + dt * np.arange(n, dtype=np.float64)
    mean, var = (v.numpy() for v in model.initial_moments(params))
    a, b, q = (v.numpy() for v in model.transition(
        params, torch.full((n,), dt, dtype=torch.float64)))
    z = rng.standard_normal((n, model.dim))
    xs = np.empty((n, model.dim))
    x = mean + np.sqrt(var) * z[0]
    xs[0] = x
    for k in range(1, n):
        x = a[k] * x + b[k] + np.sqrt(q[k]) * z[k]
        xs[k] = x
    design = model.design(torch.from_numpy(ts)).numpy()
    gamma = np.sum(design * xs, axis=-1)
    mean_y = model.obs.link(torch.from_numpy(gamma)).numpy()
    scale = model.components[0].get("scale")
    ys = model.obs.sample(rng, mean_y, scale)
    return ts, ys
