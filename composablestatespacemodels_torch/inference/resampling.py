"""Systematic resampling as cumulative position counts: the main-path part
of ``composablestatespacemodels_tpu/inference/resampling.py``.

Resampling works on *counts*: ``counts[i]`` is the number of systematic
positions ``(j + u) / n`` strictly below ``cdf[i]``, so particle ``i`` owns
output slots ``[counts[i-1], counts[i])`` and the ancestor of slot ``j`` is
the first ``i`` with ``counts[i] > j`` (Resampling.scala:63-72).  These
functions are the plain versions that the K1 and K2 kernels
(``ops/scan_kernel.py``, ``ops/resample_kernel.py``) are held against.

The prefix sum accumulates in float64 and rounds each entry to float32.
The result is then the float32 rounding of the exact prefix on every
device and for every summation order, so the CUDA kernel and this plain
version see the same cdf bits (a float32 prefix moves by ulps with the
summation order, and an ulp moves a count by one at ties --
``resampling.py:26-63`` of the JAX package).
"""

from __future__ import annotations

import torch


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of float32 ``x``: float64 accumulation, each
    entry rounded to float32."""
    return torch.cumsum(x.double(), dim=0).float()


def _counts_from_cdf(cdf: torch.Tensor, u, n: int) -> torch.Tensor:
    """``cummax(clip(ceil(n*cdf - u), 0, n))`` with ``counts[-1] = n``.

    ``n*cdf`` and ``- u`` are two separately rounded float32 operations
    (the kernel uses ``__fmul_rn`` / ``__fsub_rn``; a fused multiply-add
    would move a count at ties).  The running max is exact in int32.
    """
    c = torch.clamp(torch.ceil(n * cdf - u), 0, n).to(torch.int32)
    c[-1] = n  # guard against cdf[-1] < 1 rounding
    return torch.cummax(c, dim=0).values


def systematic_counts(weights: torch.Tensor, u, n: int | None = None):
    """Monotone cumulative position counts for systematic resampling,
    from weights and the uniform draw ``u`` (0-d tensor or float).
    Reference semantics: Resampling.scala:63-72."""
    n = weights.shape[0] if n is None else n
    return _counts_from_cdf(_cumsum(weights / weights.sum()), u, n)


def _ancestors_from_counts(counts: torch.Tensor, n_out: int) -> torch.Tensor:
    """Ancestor indices from nondecreasing counts (``counts[-1] == n_out``):
    scatter particle ``i`` to slot ``counts[i-1]`` for every particle with
    offspring, then forward-fill with a running max."""
    m = counts.shape[0]
    offspring = torch.diff(counts, prepend=counts.new_zeros(1))
    starts = counts - offspring
    targets = torch.where(offspring > 0, starts,
                          torch.full_like(starts, n_out)).long()
    seed = torch.zeros(n_out + 1, dtype=torch.int32, device=counts.device)
    seed.scatter_reduce_(0, targets, torch.arange(
        m, dtype=torch.int32, device=counts.device), reduce="amax")
    return torch.cummax(seed[:n_out], dim=0).values
