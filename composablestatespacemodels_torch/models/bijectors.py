"""Bijectors between constrained parameter values and unconstrained storage.

PyTorch port of ``composablestatespacemodels_tpu/models/bijectors.py``:
positive parameters are stored on the log scale and the OU mean-reversion
rate ``phi`` on the logit scale (reference: SdeParameters.scala:192-216).
Everything is elementwise float32 torch and broadcasts over leading axes.
"""

from __future__ import annotations

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def logit(p):
    """Log-odds transform (0, 1) -> R.  Reference: SdeParameters.scala:210-212."""
    p = _f32(p)
    return torch.log(p) - torch.log1p(-p)


def logistic(x):
    """Inverse of :func:`logit`, R -> (0, 1), evaluating ``exp`` of a
    non-positive number on both branches (as the JAX function)."""
    x = _f32(x)
    e = torch.exp(-torch.abs(x))
    return torch.where(x >= 0, 1.0 / (1.0 + e), e / (1.0 + e))


def to_log(value):
    """Constrained positive value -> unconstrained (log) storage."""
    return torch.log(_f32(value))


def from_log(stored):
    """Unconstrained (log) storage -> constrained positive value."""
    return torch.exp(_f32(stored))


def to_logit(value):
    """Constrained (0, 1) value -> unconstrained (logit) storage (the
    correct inverse; see the JAX function for the upstream bug it avoids)."""
    return logit(value)
