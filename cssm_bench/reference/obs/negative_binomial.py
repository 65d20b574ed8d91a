"""Negative binomial counts: mean ``exp(gamma)``, size ``exp(scale)``,
variance ``mu + mu^2 / size`` (Model.scala:168-196), plain torch."""

from __future__ import annotations

import math

import numpy as np
import torch

DESIGN = "first"
# float32 operations of one density evaluation, as a roofline counts them:
# exp(gamma), mu + size, a division and a log for each of the two ratios,
# two products and the sum (the lgamma terms are the step's)
DENSITY_FLOPS = 10


def link(gamma):
    return torch.exp(gamma)


def constrain_scale(raw):
    return torch.exp(raw)


def log_density(gamma, y, size):
    mu = torch.exp(gamma)
    return (torch.lgamma(size + y) - torch.lgamma(y + 1.0)
            - torch.lgamma(size)
            + size * torch.log(size / (mu + size))
            + y * torch.log(mu / (mu + size)))


def sample(rng: np.random.Generator, mean: np.ndarray, size) -> np.ndarray:
    size = math.exp(float(size))
    lam = rng.gamma(size, mean / size)
    return rng.poisson(lam).astype(np.float64)
