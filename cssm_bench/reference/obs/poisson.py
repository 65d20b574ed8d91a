"""Poisson counts with a log link, the first state of the component as the
linear predictor (Model.scala:266-274), plain torch."""

from __future__ import annotations

import numpy as np
import torch

DESIGN = "first"
# float32 operations of one density evaluation, as a roofline counts them:
# y gamma, exp(gamma), two subtractions (lgamma(y + 1) is the step's)
DENSITY_FLOPS = 4


def link(gamma):
    return torch.exp(gamma)


def constrain_scale(raw):
    return None


def log_density(gamma, y, scale):
    return y * gamma - torch.exp(gamma) - torch.lgamma(y + 1.0)


def sample(rng: np.random.Generator, mean: np.ndarray, scale) -> np.ndarray:
    return rng.poisson(mean).astype(np.float64)
