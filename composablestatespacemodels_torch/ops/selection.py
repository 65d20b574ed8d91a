"""Exact order statistics without sorting: bit-bisection selection.

PyTorch port of ``composablestatespacemodels_tpu/ops/selection.py``
(``kth_smallest_bits`` :24, ``weighted_quantile_bits`` :60), plain torch
ops as in the JAX package (no kernel).  The filter's per-step summaries
select a few order statistics per row of the ``[d + 1, N]`` cloud; 32
rounds of counting compares over an order-preserving integer encoding of
float32 give values bit-identical to ``sort(row)[k]``.

The JAX package bisects over a uint32 encoding.  torch's ``uint32`` has
few kernels (on CUDA above all), so the keys here are the signed
order-preserving int32 encoding ``b ^ ((b >> 31) & 0x7fffffff)`` of the
float bits ``b`` -- the uint32 key minus 2^31 -- and the bisection runs on
the uint32 value of the candidate held in int64: the same 32 candidates,
the same comparisons, the same answers.

Both selectors take the JAX package's ``psum`` hook: a function that sums
each round's per-shard counts (or masses) over the shards of a
particle-sharded cloud (``parallel/sharded_filter.py``), so the order
statistics are those of the global rows with no gather; at ``psum=None``
nothing changes.
"""

from __future__ import annotations

import torch

from ..utils.profiling import span

_SIGN = 1 << 31


def _keys(vals: torch.Tensor, name: str) -> torch.Tensor:
    if vals.dtype != torch.float32:
        raise TypeError(f"{name} needs float32, got {vals.dtype}")
    b = vals.contiguous().view(torch.int32)
    return b ^ ((b >> 31) & 0x7FFFFFFF)


def _bisect(keys: torch.Tensor, shape, below_ok) -> torch.Tensor:
    """The largest uint32 key ``lo`` (held in int64) built bit by bit from
    the top, keeping a bit when ``below_ok(keys < candidate)`` holds, mapped
    back to float32."""
    lo = torch.zeros(shape, dtype=torch.int64, device=keys.device)
    for i in range(32):
        cand = lo | (1 << (31 - i))
        below = keys[:, None, :] < (cand - _SIGN).to(torch.int32)[:, :, None]
        lo = torch.where(below_ok(below), cand, lo)
    k = (lo - _SIGN).to(torch.int32)
    return (k ^ ((k >> 31) & 0x7FFFFFFF)).view(torch.float32)


def _summed(psum):
    return (lambda v: v) if psum is None else psum


def kth_smallest_bits(vals: torch.Tensor, ks: torch.Tensor,
                      psum=None) -> torch.Tensor:
    """Exact k-th smallest of each row of float32 ``vals [c, n]`` for the
    0-indexed order statistics ``ks [c, q]``: ``[c, q]`` values
    bit-identical to ``sort(row)[k]``.  With ``psum`` the rows are a
    shard's slices and ``ks`` index the global rows."""
    with span("cssm.select"):
        keys = _keys(vals, "kth_smallest_bits")
        ks = ks.to(device=vals.device, dtype=torch.int32)
        psum = _summed(psum)
        # an int32 count: summing the bools as int64 (torch's default) costs
        # a quarter more on the card, and the counts stay below 2^31
        return _bisect(keys, ks.shape, lambda below: psum(
            below.sum(-1, dtype=torch.int32)) <= ks)


def weighted_quantile_bits(vals: torch.Tensor, wn: torch.Tensor,
                           ps: torch.Tensor, psum=None) -> torch.Tensor:
    """Weighted quantiles of each row of float32 ``vals [c, n]``: per
    (row, target), the smallest value ``x`` of the row whose weighted CDF
    ``sum(wn * (row <= x))`` reaches ``ps[c, q] * sum(wn)``.

    Each round sums the float32 weight mass strictly below the candidate
    and keeps the bit while that mass is below the target, so ``p = 1``
    lands on the largest positive-weight value (see the JAX docstring).
    Exact up to the rounding of the float32 mass sums.  With ``psum`` the
    rows and ``wn`` are a shard's slices, and the total and each round's
    masses are summed over the shards.
    """
    with span("cssm.select"):
        keys = _keys(vals, "weighted_quantile_bits")
        w = wn.to(torch.float32)
        psum = _summed(psum)
        th = torch.clamp(ps.to(torch.float32), max=1.0) * psum(torch.sum(w))
        return _bisect(keys, ps.shape, lambda below: psum(torch.sum(
            torch.where(below, w, 0.0), dim=-1)) < th)
